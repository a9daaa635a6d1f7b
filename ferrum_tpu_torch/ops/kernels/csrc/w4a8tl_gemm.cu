// Two-level w4a8 GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
//   y[m, n] = out_t( f32(sum_k xq[m, k] * w8[k, n]) * xs[m] * chan[n] )
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128
//
// q is packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of
// qweight [K/2, N] holds row r in its low nibble and row K/2 + r in its
// high nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31
// for K <= 14336: the int32 sums are exact and the result matches the
// plain PyTorch version (ops/kernels/quant_matmul.py) bit for bit.
//
// Replaces two Pallas TPU kernels of ferrum_tpu/ops/pallas/quant_matmul.py:
//   ferrum_w4a8tl_decode  <- _qmm_w4a8tl_mxu_kernel (m <= 64, decode)
//   ferrum_w4a8tl_prefill <- _qmm_w4a8tl_kernel     (m > 64, prefill)
// The TPU tricks are not carried over: the "MXU-assisted unpack" exists
// because Mosaic lacks sub-32-bit shifts, and the m -> 32 padding exists
// for the int8 sublane tile. Here nibbles are unpacked with plain shifts.
//
// What bounds it on the H100: decode (m <= 64) streams the packed weight
// once per call and does ~2m int8 ops per weight, far below the tensor
// cores' 1979 TOP/s, so it is bound by the 3.35 TB/s of HBM -- if the
// kernel keeps enough bytes in flight per SM (~20 KB at HBM latency) and
// its per-byte work (the dequant, ~2 instructions per w8) off the copies'
// path. On an H100 SXM (PERF.md §6) this loop's 16-byte copies alone
// stream ~1.3 TB/s at llama's gate_up, and a small projection pays a
// ~13-17 us floor (launch, first load, split epilogue). Prefill at
// m >= 256 is bound by the int8 tensor-core rate.
//
// Design: at decode sizes (m <= 64) the kernel is w4a8tl_stream.cuh's
// main loop: a ring of 16-byte cp.async copies several K steps deep, the
// dequant of step s+1 and the mma.sync of step s overlapping it, one
// barrier a step, 128 columns a block (64 for small weights or where
// N % 128 != 0) and all of m. Decode has few output tiles per call, so
// it splits K across blockIdx.z -- the count chosen by the header's
// launcher (shared with w4a8tl_gd.cu's group-dot form), so the blocks
// fill the resident slots in whole waves -- each split storing its int32
// partial sums in a plane of its own; the block that finishes a tile
// last (a per-tile arrival counter, left zeroed) sums the planes
// (order-independent, so still exact) and applies the epilogue, so a
// decode projection is one launch with no memset. At prefill sizes
// (m > 64) the kernel is w4a8tl_wgmma.cuh's pipelined int8 wgmma main
// loop on 128-row tiles. The float epilogue is f32(acc) * xs[m] *
// chan[n], in that order, then round-to-nearest-even to bf16 (or f32
// output).

#include <cstdint>

#include "w4a8tl_stream.cuh"
#include "w4a8tl_wgmma.cuh"

using w4a8tl_stream::decode_any;

// Decode tiles (w4a8tl_stream.cuh, its w8 form and launcher): all M rows
// (BM = 16 / 32 / 64) x 128 columns (64 where N % 128 != 0 or K/2 x N <=
// 16 MiB), 64 packed rows (128 k) per K step; K split across blockIdx.z
// into `splits` parts (0: the launcher's count; at most one split per K
// step; ferrum_w4a8tl_decode_plan gives the count a launch takes). With
// more than one split, `ws` is int32 [splits, M, N] of any contents (the
// splits' partial sums) and `counters` (int32, one per column tile: N /
// 64 suffice) caller-owned scratch that must be all zero on entry and is
// all zero again on return, so one serves every call on a stream; with
// one, neither is touched. Requires 1 <= M <= 64, K % 256 == 0,
// N % 64 == 0, and xq, qweight, scales2 and zeros 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_decode(const void* xq, const void* xs,
                                    const void* qw, const void* s2,
                                    const void* z, const void* chan, void* out,
                                    void* ws, void* counters, int M, int N,
                                    int K, int splits, int out_bf16,
                                    void* stream) {
  return decode_any<false>({xq, xs, qw, s2, z, chan, out,
                            static_cast<int*>(ws),
                            static_cast<int*>(counters), M, N, K, splits,
                            out_bf16, static_cast<cudaStream_t>(stream),
                            nullptr});
}

// The launch ferrum_w4a8tl_decode would make for (M, N, K, splits),
// without making it: plan[0..6] = BM, BN, threads, ring stages, splits, K
// steps per split, resident blocks per SM. Returns a cudaError_t.
extern "C" int ferrum_w4a8tl_decode_plan(int M, int N, int K, int splits,
                                         int* plan) {
  return decode_any<false>({nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, M, N, K,
                            splits, 0, nullptr, plan});
}

// Prefill tiles (w4a8tl_wgmma.cuh): 128 rows x 256 columns, or 128 where
// N % 256 != 0 or 256-column tiles would not fill the SMs once; full K per
// block. Requires M >= 1, K % 256 == 0, N % 128 == 0, and xq, qweight,
// scales2 and zeros 16-byte aligned. Returns a cudaError_t.
extern "C" int ferrum_w4a8tl_prefill(const void* xq, const void* xs,
                                     const void* qw, const void* s2,
                                     const void* z, const void* chan,
                                     void* out, int M, int N, int K,
                                     int out_bf16, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_m = (M + 127) / 128;
  return N % 256 == 0 && tiles_m * (N / 256) >= w4a8tl_wgmma::num_sms()
      ? w4a8tl_wgmma::launch<128, 256>(xq, xs, qw, s2, z, chan, out, M, N, K,
                                       out_bf16, st)
      : w4a8tl_wgmma::launch<128, 128>(xq, xs, qw, s2, z, chan, out, M, N, K,
                                       out_bf16, st);
}
