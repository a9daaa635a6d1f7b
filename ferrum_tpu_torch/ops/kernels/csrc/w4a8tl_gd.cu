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
// integer: each group's correction is subtracted as soon as its dot is
// scaled, so the running sum is a sum of per-group sum_k xq * w8 terms and
// stays below 127*127*K < 2^31 (K <= 14336) like that kernel's. Every
// intermediate is in modular 32-bit arithmetic anyway (unsigned multiply
// and add; mma.sync without .satfinite), so no step is undefined even on
// weights outside the two-level bound, and the result equals the plain
// PyTorch version w4a8tl_gd_plain (ops/kernels/quant_matmul.py) bit for
// bit.
//
// Replaces ferrum_tpu/ops/pallas/quant_matmul.py::_qmm_w4a8tl_gd_kernel
// (wrapper _quant_matmul_w4a8tl_gd, taken at m <= 64 under
// w4a8_gd = "all", and "down" where in_features > out_features). There the
// point is to move the per-weight dequant off the TPU's vector unit; here
// it removes the subtract and multiply per weight element from the staging
// of each block: the raw nibbles go straight into the int8 B fragments.
//
// What bounds it on the H100: at decode m it streams the packed weight once
// (plus scales2 and zeros) for ~2m int8 ops per weight: HBM-bound, like
// w4a8tl_decode (3.35 TB/s). The per-group output rescale is m * N * K/128
// int32 multiply-adds, small beside the dots.
//
// Design (a first, simple kernel): the shared tile's decode tiling
// (w4a8tl_tile.cuh) -- one block per 64-column tile and BM = 16/32/64
// rows, one group per plane per K step, K split across blockIdx.z so
// enough blocks cover the 132 SMs, the int32 partial sums added with
// atomics into the per-stream scratch and the epilogue applied by the
// tile's last-arriving split, which leaves the scratch and its counter
// zeroed (w4a8tl::Tile::finish). Per K step the
// block stages xq and the raw nibbles (w4a8tl_tile.cuh), the group's
// scales2 and s2 * z per column and, once per block, each staged
// activation row's sum sx (dp4a); each plane's 128-deep dot lands in a
// fresh int32 fragment, which is scaled by s2, corrected and added to the
// running accumulator in registers.

#include "w4a8tl_tile.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kGroup = w4a8tl::kGroup;

// Grid: x = N / 64, y = 1, z = K splits (each `steps_per_split` groups per
// plane).
template <int BM, bool kSplit>
__global__ void __launch_bounds__(128)
w4a8tl_gd_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const uint8_t* __restrict__ qw,
                 const int8_t* __restrict__ s2, const int8_t* __restrict__ zr,
                 const float* __restrict__ chan, void* __restrict__ out,
                 int* __restrict__ ws, int* __restrict__ counters, int M,
                 int N, int K, int steps_per_split, int out_bf16) {
  using T = w4a8tl::Tile<BM, kBN, kGroup, 1, 4>;
  __shared__ __align__(16) typename T::Smem sm;
  __shared__ int s2s[2][kBN];     // scales2 of the step's two groups
  __shared__ int s2z[2][kBN];     // scales2 * zeros
  __shared__ int sx[2][BM];       // row sums of the staged xq groups
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int half_groups = (K / 2) / kGroup;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(half_groups, s_begin + steps_per_split);

  typename T::Acc acc;
  T::zero(acc);
  for (int s = s_begin; s < s_end; ++s) {
    const int r0 = s * kGroup;
    T::stage_a(sm, xq, 0, 0, M, K, r0);
    T::template stage_b<false>(sm, qw, nullptr, nullptr, n0, N, K, r0);
    {  // 128 threads: one (plane, column) each
      const int h = tid / kBN;
      const int c = tid % kBN;
      const size_t gi = (size_t)(h * half_groups + s) * N + n0 + c;
      const int sv = s2[gi];
      s2s[h][c] = sv;
      s2z[h][c] = sv * (int)zr[gi];
    }
    __syncthreads();
    if (tid < 2 * BM) {
      const int h = tid / BM;
      const int row = tid % BM;
      const int* a = reinterpret_cast<const int*>(&sm.A[h][row][0]);
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kGroup / 4; ++w) sum = __dp4a(a[w], 0x01010101, sum);
      sx[h][row] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      typename T::Acc dot;
      T::zero(dot);
      T::mma_half(dot, sm, h);
      T::for_each_elem([&](int i, int j, int e, int r, int c) {
        acc[i][j][e] = (int)((uint32_t)acc[i][j][e]
                             + (uint32_t)dot[i][j][e] * (uint32_t)s2s[h][c]
                             - (uint32_t)sx[h][r] * (uint32_t)s2z[h][c]);
      });
    }
    __syncthreads();
  }
  T::template finish<kSplit>(acc, xs, chan, out, ws, counters, 0, n0, M, N,
                             out_bf16);
}

template <int BM>
void launch_gd(const void* xq, const void* xs, const void* qw, const void* s2,
               const void* z, const void* chan, void* out, int* ws,
               int* counters, int M, int N, int K, int splits, int out_bf16,
               cudaStream_t stream) {
  const int nsteps = (K / 2) / kGroup;
  const int per = (nsteps + splits - 1) / splits;
  const int used = (nsteps + per - 1) / per;
  dim3 grid(N / kBN, 1, used);
  auto kernel = used > 1 ? w4a8tl_gd_kernel<BM, true>
                         : w4a8tl_gd_kernel<BM, false>;
  kernel<<<grid, 128, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan), out,
      ws, counters, M, N, K, per, out_bf16);
}

}  // namespace

// The arguments of ferrum_w4a8tl_decode (w4a8tl_gemm.cu), with the same
// scratch contract: `ws` (int32 [M, N]) and `counters` (int32, N / 64)
// all zero on entry and all zero again on return. Requires 1 <= M <= 64,
// K % 256 == 0, N % 64 == 0. Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_gd_decode(const void* xq, const void* xs,
                                       const void* qw, const void* s2,
                                       const void* z, const void* chan,
                                       void* out, void* ws, void* counters,
                                       int M, int N, int K, int splits,
                                       int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* wsp = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (M <= 16) {
    launch_gd<16>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M, N, K, splits,
                  out_bf16, st);
  } else if (M <= 32) {
    launch_gd<32>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M, N, K, splits,
                  out_bf16, st);
  } else if (M <= 64) {
    launch_gd<64>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M, N, K, splits,
                  out_bf16, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
