// Two-level w4a8 decode GEMM in the group-dot form, for Hopper (sm_90a),
// plain C interface for ctypes:
//
//   acc[m, n] = sum_g s2[g, n] * (xq_g[m] . q_g[:, n])
//             - sum_g sx[m, g] * (s2 * z)[g, n],   sx[m, g] = sum_k xq_g[m, k]
//   y[m, n]   = out_t( f32(acc) * xs[m] * chan[n] )
//
// over the 128-row groups g of K in global order (the low nibble plane's
// K/256 groups, then the high plane's; ops/quant.py's global halves), q_g
// the group's raw nibbles 0..15. Algebraically acc = sum_k xq * w8 with
// w8 = (q - z) * s2, the integer dot of w4a8tl_gemm.cu, and it is the same
// integer: every product and sum is unsigned 32-bit (modular; mma.sync
// without .satfinite) and the true result fits int32 (|acc| <= 127*127*K,
// K <= 14336), so the order of the terms does not matter, even where
// sum_g s2 * dot alone passes 2^31 before the correction cancels it. The
// result equals the plain PyTorch version w4a8tl_gd_plain
// (ops/kernels/quant_matmul.py) bit for bit.
//
// Replaces ferrum_tpu/ops/pallas/quant_matmul.py::_qmm_w4a8tl_gd_kernel
// (wrapper _quant_matmul_w4a8tl_gd, taken at m <= 64 under
// w4a8_gd = "all", and "down" where in_features > out_features). There the
// point is to move the per-weight dequant off the TPU's vector unit; here
// the raw nibbles go straight into the int8 B fragments and the scales
// and the zero correction move to the output side.
//
// What bounds it on the H100: at decode m it streams the packed weight once
// (plus scales2 and zeros) for ~2m int8 ops per weight: HBM-bound, like
// w4a8tl_decode (3.35 TB/s) -- if enough bytes are in flight per SM and
// the per-byte work stays off the copies' path. The first version of this
// kernel had neither: synchronous 4-byte staging loads, bank-conflicted
// stores, three barriers a K step, 64-column tiles and split-K sums by
// integer atomics (~8 us per million outputs), 1.7x torch._int_mm.
//
// Design: the group-dot form of w4a8tl_stream.cuh's main loop (kGD) and
// its launcher, shared with w4a8tl_decode: a ring of 16-byte cp.async
// copies several K steps deep, one barrier a step, the raw-nibble unpack
// (the dequant's byte-perm transpose, no scales) of step s+1 overlapping
// the mma.sync of step s, 64 or 128 columns a block, K split so the
// blocks fill the SMs in whole waves, per-split int32 partial planes
// summed by each tile's last arrival. Each half's 64-k dot lands in a
// fragment of its own and is rescaled into the accumulator, acc += dot *
// s2 (every step; at BN 128 once a group, on dots kept over the group's
// steps), then acc -= sx * (s2 * z) once a group, with s2 and s2 * z of
// the fragment's columns in registers and sx from the A fragments (dp4a,
// two lane shuffles). These multiply-adds are the price of the form: the
// unpack saves about as much against the dequant at m = 32, so it runs
// at kernel 1's time there, a little under it at m = 1 and ~10% over it
// at m = 64, where the rescale has 4x m = 16's outputs a block.

#include <cstdint>

#include "w4a8tl_stream.cuh"

using w4a8tl_stream::decode_any;

// The arguments and scratch contract of ferrum_w4a8tl_decode
// (w4a8tl_gemm.cu): with more than one K split, `ws` is int32 [splits, M,
// N] of any contents and `counters` (int32, N / 64) all zero on entry and
// all zero again on return; with one, neither is touched. `splits` 0: the
// launcher's count (ferrum_w4a8tl_gd_decode_plan). Requires 1 <= M <= 64,
// K % 256 == 0, N % 64 == 0, and xq, qweight, scales2 and zeros 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_gd_decode(const void* xq, const void* xs,
                                       const void* qw, const void* s2,
                                       const void* z, const void* chan,
                                       void* out, void* ws, void* counters,
                                       int M, int N, int K, int splits,
                                       int out_bf16, void* stream) {
  return decode_any<true>({xq, xs, qw, s2, z, chan, out,
                           static_cast<int*>(ws),
                           static_cast<int*>(counters), M, N, K, splits,
                           out_bf16, static_cast<cudaStream_t>(stream),
                           nullptr});
}

// The launch ferrum_w4a8tl_gd_decode would make for (M, N, K, splits),
// without making it: plan[0..6] = BM, BN, threads, ring stages, splits, K
// steps per split, resident blocks per SM. Returns a cudaError_t.
extern "C" int ferrum_w4a8tl_gd_decode_plan(int M, int N, int K, int splits,
                                            int* plan) {
  return decode_any<true>({nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, M, N, K,
                           splits, 0, nullptr, plan});
}
