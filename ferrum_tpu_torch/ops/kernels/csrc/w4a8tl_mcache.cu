// Two-level w4a8 prefill GEMM with the dequantized weight shared across
// M-tiles, for Hopper (sm_90a), plain C interface for ctypes. The function
// of w4a8tl_gemm.cu (same exact int32 sums, same epilogue):
//
//   y[m, n] = out_t( f32(sum_k xq[m, k] * w8[k, n]) * xs[m] * chan[n] )
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n]
//
// bit for bit equal to the plain PyTorch version w4a8tl_plain
// (ops/kernels/quant_matmul.py).
//
// Replaces ferrum_tpu/ops/pallas/quant_matmul.py::_qmm_w4a8tl_mcache_kernel
// (wrapper _quant_matmul_w4a8tl_2d_mcache). Like it, this kernel is wired
// into no route: it is reached only through its wrapper
// (quant_matmul.py::w4a8tl_prefill_mcache), as a schedule option of
// w4a8tl_prefill.
//
// What bounds it on the H100: at prefill m (>= 256) it does 2 * m * K * N
// int8 ops against one read of the packed weight: the int8 tensor-core
// rate (1979 TOP/s dense).
//
// Design: the TPU kernel walks m innermost so the weight prep of a (column
// tile, K step) runs once for every m-tile, carrying a whole-m int32
// accumulator in VMEM. That accumulator would be 1 MiB at m = 2048 and 128
// columns, which no SM holds, so the idea is kept and the shape is not:
// one block owns a 128-column tile and a super-tile of R = 2 row tiles of
// 128 rows, and walks K outermost. Per K step (64 packed rows) it
// dequantizes the [64 x 2, 128] w8 tile into shared memory once, then for
// each row tile stages that tile's xq and runs its MMAs (mma.sync
// m16n8k32 s8 x s8 -> s32, w4a8tl_tile.cuh) into that row tile's own int32
// accumulators, kept in registers. So the dequant runs once per 256 rows
// instead of once per 128 (w4a8tl_prefill). 8 warps, each a 64 x 32 warp
// tile of every row tile: 2 x 64 accumulator registers per thread.

#include "w4a8tl_tile.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kKP = 64;
constexpr int kR = 2;           // row tiles per block sharing one w8 tile

// Grid: x = N / 128, y = ceil(M / (R * 128)).
__global__ void __launch_bounds__(256, 1)
w4a8tl_mcache_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ xs,
                     const uint8_t* __restrict__ qw,
                     const int8_t* __restrict__ s2,
                     const int8_t* __restrict__ zr,
                     const float* __restrict__ chan, void* __restrict__ out,
                     int M, int N, int K, int out_bf16) {
  using T = w4a8tl::Tile<kBM, kBN, kKP, 2, 4>;
  __shared__ __align__(16) typename T::Smem sm;
  const int n0 = blockIdx.x * kBN;
  const int m_base = blockIdx.y * kR * kBM;
  const int nsteps = (K / 2) / kKP;

  typename T::Acc acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) T::zero(acc[r]);
  for (int s = 0; s < nsteps; ++s) {
    const int r0 = s * kKP;
    // The w8 tile of this (column tile, K step), once for all row tiles;
    // the first row tile's barrier publishes it.
    T::template stage_b<true>(sm, qw, s2, zr, n0, N, K, r0);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int m0 = m_base + r * kBM;
      if (m0 < M) {             // uniform across the block
        T::stage_a(sm, xq, m0, 0, M, K, r0);
        __syncthreads();
        T::mma_half(acc[r], sm, 0);
        T::mma_half(acc[r], sm, 1);
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    T::template finish<false>(acc[r], xs, chan, out, nullptr, nullptr,
                              m_base + r * kBM, n0, M, N, out_bf16);
  }
}

}  // namespace

// Requires M >= 1, K % 256 == 0 and N % 128 == 0. Returns
// cudaGetLastError().
extern "C" int ferrum_w4a8tl_prefill_mcache(const void* xq, const void* xs,
                                            const void* qw, const void* s2,
                                            const void* z, const void* chan,
                                            void* out, int M, int N, int K,
                                            int out_bf16, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(N / kBN, (M + kR * kBM - 1) / (kR * kBM));
  w4a8tl_mcache_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan), out, M,
      N, K, out_bf16);
  return (int)cudaGetLastError();
}
