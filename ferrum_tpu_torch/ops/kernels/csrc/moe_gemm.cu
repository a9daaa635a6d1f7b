// Two-level w4a8 GEMMs over MoE expert stacks for Hopper (sm_90a), plain
// C interface for ctypes. Every stack is [E, ...]: qweight [E, K/2, N]
// (global halves, as the dense weights), scales2/zeros [E, K/128, N],
// chan [E, N]; w8[e] = (q[e] - zeros[e]) * scales2[e] per 128-group.
//
// Replaces two Pallas TPU kernels of ferrum_tpu/ops/pallas/quant_matmul.py:
//   ferrum_moe_bmm      <- _qbmm_w4a8tl_mxu_kernel / _qbmm_w4a8tl_kernel
//                          (quant_bmm_all_experts: every expert on every
//                          row; the two TPU kernels compute one function)
//       out[e, m, n] = out_t( (f32(xq[e|0, m] . w8[e][:, n]) * xs[e|0, m])
//                             * chan[e, n] )
//   ferrum_moe_grouped  <- _qgmm_w4a8tl_kernel (_quant_grouped_w4a8tl_2d:
//                          rows sorted by expert, group_sizes[e] rows each)
//       y[r, n] = out_t( (f32(xq[r] . w8[e(r)][:, n]) * chan[e(r), n])
//                        * xs[r] )
// Each keeps its TPU kernel's epilogue order (the two differ), so each is
// bit-exact to its plain PyTorch version (ops/kernels/moe_gemm.py). The
// int32 sums are exact in any order (|acc| <= 127 * 127 * K < 2^31).
//
// What bounds them on the H100: the all-experts bmm runs at decode
// (t <= 64 rows) and streams every expert's packed weight once per call
// (100.7 MB at 128 x 2048 x 768) for ~2t int8 ops per weight: HBM-bound.
// The grouped GEMM reads only the experts that have rows; at a 2048-token
// prefill (16384 rows at top-8) it does 2 * 16384 * K * N int8 ops
// against the same ~100 MB of weights plus the rows: HBM-bound by the
// bytes it must move (0.05 ms a projection), and the int8 tensor-core
// rate is the second wall -- which the 128-row tiles reach first in
// practice: with ~128 rows per expert most tiles hold ~64 rows of their
// expert, so the tensor cores do about twice the real work.
//
// Design:
//  - bmm: grid (N / 64, E), one block per (expert, 64-column tile) with
//    every row in it (BM = 16/32/64 >= t), walking the full K with the
//    mma.sync tile w4a8tl::Tile (w4a8tl_tile.cuh): at the qwen3-30b-a3b
//    shapes that is 1536 (gate, up) or 4096 (down) blocks, enough to fill
//    132 SMs without splitting K, so no cross-block sum. A template flag
//    picks shared rows (gate/up read one [t, K] block) or per-expert rows
//    (down reads xq[e]).
//  - grouped: grid (N / BN, logical tiles). The host bounds the logical
//    tiles statically by ceil(A / BM) + E - 1 and the device-side tile
//    map (gid, mtid, valid; moe_gemm.py::group_tile_map, the counterpart
//    of _make_group_metadata) assigns each one an (expert, m-tile) pair;
//    a block whose tile is not valid, or whose expert has no row in its
//    m-tile, exits before any load. A block stages only its expert's rows
//    of the m-tile (the others zero-filled) and writes only those rows: a
//    row belongs to one expert, so a tile shared by two experts is
//    written by two blocks, each its own rows, with no cross-block sum.
//    No host sync: the grid is static and the offsets stay on the device.
//    Decode-sized maps (BM = 16, A <= 256) run w4a8tl::Tile with 64
//    columns; prefill maps (BM = 128) run the dense prefill GEMM's
//    pipelined int8 wgmma main loop (w4a8tl_wgmma.cuh) on the expert's
//    weight, scales and chan, with the row window of the tile's expert
//    and the chan-first epilogue. Both of its warpgroups issue every
//    wgmma, also where the expert's rows all lie in the other one's 64
//    (zero rows): a wgmma behind a branch makes ptxas serialize them all.

#include "w4a8tl_tile.cuh"
#include "w4a8tl_wgmma.cuh"

namespace {

using w4a8tl::store_out;

template <int BM, int BN, int KP, int WM, int WN, bool kShared>
__global__ void __launch_bounds__(WM * WN * 32)
moe_bmm_kernel(const int8_t* __restrict__ xq3, const float* __restrict__ xs3,
               const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
               const int8_t* __restrict__ zr, const float* __restrict__ chan,
               void* __restrict__ out, int T, int N, int K, int out_bf16) {
  using Tl = w4a8tl::Tile<BM, BN, KP, WM, WN>;
  __shared__ __align__(16) typename Tl::Smem sm;
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.y;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a8tl::kGroup) * N;
  const int8_t* xq = kShared ? xq3 : xq3 + (size_t)e * T * K;
  const float* xs = kShared ? xs3 : xs3 + (size_t)e * T;
  const float* ch = chan + (size_t)e * N;

  typename Tl::Acc acc;
  Tl::zero(acc);
  Tl::mainloop(acc, sm, xq, qw + e * wstride, s2 + e * gstride,
               zr + e * gstride, 0, 0, T, n0, N, K, 0, (K / 2) / KP);
  const size_t obase = (size_t)e * T * N;
  Tl::for_each_out(acc, 0, n0, 0, T, [&](int row, int col, int v) {
    store_out(out, obase + (size_t)row * N + col,
              ((float)v * xs[row]) * ch[col], out_bf16);
  });
}

template <int BM, int BN, int KP, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
moe_grouped_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const uint8_t* __restrict__ qw,
                   const int8_t* __restrict__ s2,
                   const int8_t* __restrict__ zr,
                   const float* __restrict__ chan,
                   const int* __restrict__ gid, const int* __restrict__ mtid,
                   const int* __restrict__ offsets,
                   const int* __restrict__ valid, void* __restrict__ out,
                   int N, int K, int out_bf16) {
  using Tl = w4a8tl::Tile<BM, BN, KP, WM, WN>;
  __shared__ __align__(16) typename Tl::Smem sm;
  const int i = blockIdx.y;                  // logical tile
  if (!valid[i]) return;
  const int g = gid[i];
  const int m0 = mtid[i] * BM;
  const int row_lo = max(offsets[g], m0);
  const int row_hi = min(offsets[g + 1], m0 + BM);
  if (row_lo >= row_hi) return;
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a8tl::kGroup) * N;
  const float* ch = chan + (size_t)g * N;

  typename Tl::Acc acc;
  Tl::zero(acc);
  Tl::mainloop(acc, sm, xq, qw + g * wstride, s2 + g * gstride,
               zr + g * gstride, m0, row_lo, row_hi, n0, N, K, 0,
               (K / 2) / KP);
  Tl::for_each_out(acc, m0, n0, row_lo, row_hi, [&](int row, int col, int v) {
    store_out(out, (size_t)row * N + col, ((float)v * ch[col]) * xs[row],
              out_bf16);
  });
}

// Prefill-sized grouped GEMM: logical tile blockIdx.y of the tile map
// (128-row m-tiles), columns blockIdx.x * BN.., only the rows of the
// tile's expert.
template <int BN>
__global__ void __launch_bounds__(w4a8tl_wgmma::kThreads, 1)
moe_grouped_wgmma_kernel(const int8_t* __restrict__ xq,
                         const float* __restrict__ xs,
                         const uint8_t* __restrict__ qw,
                         const int8_t* __restrict__ s2,
                         const int8_t* __restrict__ zr,
                         const float* __restrict__ chan,
                         const int* __restrict__ gid,
                         const int* __restrict__ mtid,
                         const int* __restrict__ offsets,
                         const int* __restrict__ valid,
                         void* __restrict__ out, int N, int K, int out_bf16) {
  constexpr int BM = 128;
  using L = w4a8tl_wgmma::Mainloop<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const int i = blockIdx.y;                  // logical tile
  if (!valid[i]) return;
  const int g = gid[i];
  const int m0 = mtid[i] * BM;
  const int row_lo = max(offsets[g], m0);
  const int row_hi = min(offsets[g + 1], m0 + BM);
  if (row_lo >= row_hi) return;
  uint8_t* base = w4a8tl_wgmma::aligned_smem(smem_raw);
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a8tl_wgmma::kGroup) * N;

  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, base, xq, qw + g * wstride, s2 + g * gstride, zr + g * gstride,
         m0, row_lo, row_hi, n0, N, K);
  L::template store<true>(acc, xs, chan + (size_t)g * N, out, m0, row_lo,
                          row_hi, n0, N, out_bf16);
}

template <int BM, bool kShared>
void launch_bmm(const void* xq3, const void* xs3, const void* qw,
                const void* s2, const void* z, const void* chan, void* out,
                int E, int T, int N, int K, int out_bf16, cudaStream_t st) {
  dim3 grid(N / 64, E);
  moe_bmm_kernel<BM, 64, 128, 1, 4, kShared><<<grid, 128, 0, st>>>(
      static_cast<const int8_t*>(xq3), static_cast<const float*>(xs3),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan), out, T,
      N, K, out_bf16);
}

template <int BM, int BN, int KP, int WM, int WN>
void launch_grouped(const void* xq, const void* xs, const void* qw,
                    const void* s2, const void* z, const void* chan,
                    const void* gid, const void* mtid, const void* offsets,
                    const void* valid, void* out, int n_logical, int N, int K,
                    int out_bf16, cudaStream_t st) {
  dim3 grid(N / BN, n_logical);
  moe_grouped_kernel<BM, BN, KP, WM, WN><<<grid, WM * WN * 32, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan),
      static_cast<const int*>(gid), static_cast<const int*>(mtid),
      static_cast<const int*>(offsets), static_cast<const int*>(valid), out,
      N, K, out_bf16);
}

template <int BN>
int launch_grouped_wgmma(const void* xq, const void* xs, const void* qw,
                         const void* s2, const void* z, const void* chan,
                         const void* gid, const void* mtid,
                         const void* offsets, const void* valid, void* out,
                         int n_logical, int N, int K, int out_bf16,
                         cudaStream_t st) {
  return w4a8tl_wgmma::launch_on<128, BN>(
      moe_grouped_wgmma_kernel<BN>, dim3(N / BN, n_logical), st,
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan),
      static_cast<const int*>(gid), static_cast<const int*>(mtid),
      static_cast<const int*>(offsets), static_cast<const int*>(valid), out,
      N, K, out_bf16);
}

}  // namespace

// All-experts batched GEMM. xq3 int8 [shared ? 1 : E, T, K], xs3 f32
// [shared ? 1 : E, T], out [E, T, N]. Requires T <= 64, K % 256 == 0,
// N % 64 == 0. Returns cudaGetLastError().
extern "C" int ferrum_moe_bmm(const void* xq3, const void* xs3,
                              const void* qw, const void* s2, const void* z,
                              const void* chan, void* out, int E, int T,
                              int N, int K, int shared, int out_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FERRUM_BMM(BM)                                                      \
  (shared ? launch_bmm<BM, true>(xq3, xs3, qw, s2, z, chan, out, E, T, N, \
                                 K, out_bf16, st)                         \
          : launch_bmm<BM, false>(xq3, xs3, qw, s2, z, chan, out, E, T, N, \
                                  K, out_bf16, st))
  if (T <= 16) {
    FERRUM_BMM(16);
  } else if (T <= 32) {
    FERRUM_BMM(32);
  } else if (T <= 64) {
    FERRUM_BMM(64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FERRUM_BMM
  return (int)cudaGetLastError();
}

// Grouped GEMM over expert-sorted rows. xq int8 [A, K], xs f32 [A],
// out [A, N]; gid/mtid/valid int32 [n_logical] and offsets int32 [E + 1]
// on the device (group_tile_map with the same bm). bm 16: 64-column
// tiles (N % 64 == 0); bm 128: the wgmma main loop on 256- or 128-column
// tiles (N % 128 == 0; xq and the stacks 16-byte aligned). Requires
// K % 256 == 0. Returns a cudaError_t.
extern "C" int ferrum_moe_grouped(const void* xq, const void* xs,
                                  const void* qw, const void* s2,
                                  const void* z, const void* chan,
                                  const void* gid, const void* mtid,
                                  const void* offsets, const void* valid,
                                  void* out, int n_logical, int bm, int N,
                                  int K, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 16) {
    launch_grouped<16, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, gid, mtid,
                                      offsets, valid, out, n_logical, N, K,
                                      out_bf16, st);
    return (int)cudaGetLastError();
  }
  if (bm != 128) return (int)cudaErrorInvalidValue;
  // BN 256 wherever N allows it: on an H100 it took 15-23% less time
  // than BN 128 at every qwen3-30b-a3b expert site, at 2048 and at 16384
  // rows (PERF.md).
  const bool wide = N % 256 == 0;
  return wide
      ? launch_grouped_wgmma<256>(xq, xs, qw, s2, z, chan, gid, mtid, offsets,
                                  valid, out, n_logical, N, K, out_bf16, st)
      : launch_grouped_wgmma<128>(xq, xs, qw, s2, z, chan, gid, mtid, offsets,
                                  valid, out, n_logical, N, K, out_bf16, st);
}
