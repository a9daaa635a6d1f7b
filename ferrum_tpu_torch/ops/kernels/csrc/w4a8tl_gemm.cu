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
// cores' 1979 TOP/s, so it is bound by the 3.35 TB/s of HBM. Prefill at
// m >= 256 is bound by the int8 tensor-core rate.
//
// Design: at decode sizes (m <= 64) one block owns a BM x BN output tile;
// its int32 main loop (mma.sync m16n8k32 on xq and w8 staged in shared
// memory) is w4a8tl::Tile in w4a8tl_tile.cuh, shared with the MoE kernels
// (moe_gemm.cu). Decode has few output tiles per call, so it splits K
// across blockIdx.z (enough blocks to cover the 132 SMs) and reduces the
// int32 partial sums with integer atomics into a workspace --
// order-independent, so still exact. The block that finishes a tile last
// (a per-tile arrival counter) applies the epilogue from the workspace
// and leaves the workspace and the counter zeroed, so a decode projection
// is one launch with no memset. At prefill sizes (m > 64) the kernel is
// w4a8tl_wgmma.cuh's pipelined int8 wgmma main loop on 128-row tiles. The
// float epilogue is f32(acc) * xs[m] * chan[n], in that order, then
// round-to-nearest-even to bf16 (or f32 output).

#include "w4a8tl_tile.cuh"
#include "w4a8tl_wgmma.cuh"

namespace {

// Grid: x = N / BN, y = ceil(M / BM), z = K splits (each `steps_per_split`
// steps of KP packed rows); kSplit: more than one split, summed through
// ws / counters (w4a8tl::Tile::finish).
template <int BM, int BN, int KP, int WM, int WN, bool kSplit>
__global__ void __launch_bounds__(WM * WN * 32)
w4a8tl_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const uint8_t* __restrict__ qw,
                   const int8_t* __restrict__ s2,
                   const int8_t* __restrict__ zr,
                   const float* __restrict__ chan, void* __restrict__ out,
                   int* __restrict__ ws, int* __restrict__ counters, int M,
                   int N, int K, int steps_per_split, int out_bf16) {
  using T = w4a8tl::Tile<BM, BN, KP, WM, WN>;
  __shared__ __align__(16) typename T::Smem sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (K / 2) / KP;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  typename T::Acc acc;
  T::zero(acc);
  T::mainloop(acc, sm, xq, qw, s2, zr, m0, 0, M, n0, N, K, s_begin, s_end);
  T::template finish<kSplit>(acc, xs, chan, out, ws, counters, m0, n0, M, N,
                             out_bf16);
}

template <int BM, int BN, int KP, int WM, int WN>
void launch_gemm(const void* xq, const void* xs, const void* qw,
                 const void* s2, const void* z, const void* chan, void* out,
                 int* ws, int* counters, int M, int N, int K, int splits,
                 int out_bf16, cudaStream_t stream) {
  const int nsteps = (K / 2) / KP;
  const int per = (nsteps + splits - 1) / splits;
  const int used = (nsteps + per - 1) / per;
  dim3 grid(N / BN, (M + BM - 1) / BM, used);
  auto kernel = used > 1 ? w4a8tl_gemm_kernel<BM, BN, KP, WM, WN, true>
                         : w4a8tl_gemm_kernel<BM, BN, KP, WM, WN, false>;
  kernel<<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan), out,
      ws, counters, M, N, K, per, out_bf16);
}

}  // namespace

// Decode tiles: BN = 64 columns, one group (128 packed rows) per K step,
// BM = 16/32/64 rows by m; split-K over blockIdx.z when splits > 1. Then
// `ws` (int32 [M, N]) and `counters` (int32, one per output tile: N / 64)
// are caller-owned scratch that must be all zero on entry and are all
// zero again on return, so one scratch serves every call on a stream.
// Requires M <= 64, K % 256 == 0, N % 64 == 0. Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_decode(const void* xq, const void* xs,
                                    const void* qw, const void* s2,
                                    const void* z, const void* chan, void* out,
                                    void* ws, void* counters, int M, int N,
                                    int K, int splits, int out_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* wsp = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (M <= 16) {
    launch_gemm<16, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else if (M <= 32) {
    launch_gemm<32, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else if (M <= 64) {
    launch_gemm<64, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
