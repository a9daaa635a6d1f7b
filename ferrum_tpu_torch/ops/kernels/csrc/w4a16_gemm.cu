// w4a16 GEMMs for Hopper (sm_90a), plain C interface for ctypes:
//
//   y[m, n] = bf16( sum_k x[m, k] * w[k, n] ),  x bf16, f32 sums,
//   w[k, n] = bf16( bf16(q[k, n] - zeros[g(k), n]) * bf16(scales[g(k), n]) )
//
// with q packed int4 in GLOBAL HALVES (ops/quant.py). The dequant and the
// bf16 x bf16 -> f32 main loop are w4a16::Tile (w4a16_tile.cuh) at decode
// sizes and w4a16_wgmma::Mainloop (w4a16_wgmma.cuh) at prefill sizes.
//
// Replaces two Pallas TPU kernels of ferrum_tpu/ops/pallas/quant_matmul.py:
//   ferrum_w4a16_gemm        <- _qmm_kernel  (dense projections, any m)
//   ferrum_moe_grouped_w4a16 <- _qgmm_kernel (rows sorted by expert,
//                               group_sizes[e] rows each, expert stacks
//                               [E, ...])
// The f32 sums run in another order than the TPU's (k16 slices, and at
// decode a fixed-order sum of split-K partials), so the output may be
// one bf16 step from the plain version (ops/kernels/quant_matmul.py,
// moe_gemm.py), which sums in float64 and rounds once. The kernels are
// deterministic: no float atomics, split-K partials summed in split order.
//
// What bounds them on the H100: at decode (m <= 64) each call streams
// the packed weight once for ~2m flops per weight: HBM-bound (3.35 TB/s).
// At prefill (m >= 2048) the bf16 tensor cores (989 TFLOP/s) bound the
// dense GEMM; the grouped one at 16384 rows is bound by the expert
// stacks' bytes. Every weight element costs a few integer/bf16 ops to
// dequantize, once per block that reads it.
//
// Design:
//  - dense, m <= 64: w4a16::Tile (w4a16_tile.cuh, mma.sync), tiles
//    BM = 16/32/64 x 64 columns, 64 packed rows per K step, 4 warps; K
//    split across blockIdx.z until ~264 blocks cover the 132 SMs. Each
//    split writes its f32 partial tile to a workspace [splits, M, N]; the
//    split that arrives last at a tile (a per-tile counter) sums the
//    partials in split order, writes bf16 and re-zeroes the counter, so
//    a call is one launch and the result does not depend on which split
//    finished first.
//  - dense, m > 64: w4a16_wgmma::Mainloop (w4a16_wgmma.cuh: a cp.async
//    ring, packed bf16x2 dequant overlapping wgmma), 128-row tiles of
//    256 columns (128 where N % 256 != 0 or 256-column tiles would not
//    fill the SMs once), full K per block; blocks walk the tiles in
//    groups of 16 m-tiles so a wave shares weight tiles in L2.
//  - grouped: the two-level grouped GEMM's structure (moe_gemm.cu): a
//    static grid of ceil(A / BM) + E - 1 logical tiles x N tiles, the
//    device-side tile map (moe_gemm.py::group_tile_map) giving each an
//    (expert, m-tile) pair; a block stages only its expert's rows of the
//    m-tile and writes only them. BM = 16 (w4a16::Tile, 64 columns) for
//    decode-sized A <= 256, else BM = 128 on w4a16_wgmma::Mainloop (256
//    columns where N % 256 == 0, else 128).

#include "w4a16_tile.cuh"
#include "w4a16_wgmma.cuh"

namespace {

using w4a16_wgmma::aligned_smem;
using w4a16_wgmma::num_sms;

constexpr int kDecodeBN = 64, kDecodeKP = 64;
constexpr int kPrefillStages = 4;   // cp.async ring depth
constexpr int kRasterGroup = 16;    // m-tiles per raster group

__device__ __forceinline__ void store_bf16(void* out, size_t idx, float v) {
  reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

// Grid: x = N / BN, y = ceil(M / BM), z = K splits of `steps_per_split`
// steps. !kSplit: write the output directly. kSplit: write the f32 partial
// to ws[z] and count arrivals in counters[y * X + x] (zero on entry); the
// last arrival sums ws[0..Z) in order, writes the output and re-zeroes
// the counter.
template <int BM, int BN, int KP, int WM, int WN, bool kF32, bool kSplit>
__global__ void __launch_bounds__(WM * WN * 32)
w4a16_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ qw, const void* __restrict__ sc,
                  const int8_t* __restrict__ zr, void* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M,
                  int N, int K, int steps_per_split) {
  using T = w4a16::Tile<BM, BN, KP, WM, WN, kF32>;
  __shared__ __align__(16) typename T::Smem sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (K / 2) / KP;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  typename T::Acc acc;
  T::zero(acc);
  T::mainloop(acc, sm, x, qw, sc, zr, m0, 0, M, n0, N, K, s_begin, s_end);

  if constexpr (!kSplit) {
    T::for_each_out(acc, m0, n0, 0, M, [&](int row, int col, float v) {
      store_bf16(out, (size_t)row * N + col, v);
    });
  } else {
    const size_t plane = (size_t)M * N;
    T::for_each_out(acc, m0, n0, 0, M, [&](int row, int col, float v) {
      ws[blockIdx.z * plane + (size_t)row * N + col] = v;
    });
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
      if (last) counters[tile] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    T::for_each_out(acc, m0, n0, 0, M, [&](int row, int col, float) {
      const size_t idx = (size_t)row * N + col;
      float s = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z) s += __ldcg(ws + z * plane + idx);
      store_bf16(out, idx, s);
    });
  }
}

template <int BM, int BN, int KP, int WM, int WN, bool kF32>
__global__ void __launch_bounds__(WM * WN * 32)
moe_grouped_w4a16_kernel(const __nv_bfloat16* __restrict__ x,
                         const uint8_t* __restrict__ qw,
                         const void* __restrict__ sc,
                         const int8_t* __restrict__ zr,
                         const int* __restrict__ gid,
                         const int* __restrict__ mtid,
                         const int* __restrict__ offsets,
                         const int* __restrict__ valid,
                         void* __restrict__ out, int N, int K) {
  using T = w4a16::Tile<BM, BN, KP, WM, WN, kF32>;
  __shared__ __align__(16) typename T::Smem sm;
  const int i = blockIdx.y;                  // logical tile
  if (!valid[i]) return;
  const int g = gid[i];
  const int m0 = mtid[i] * BM;
  const int row_lo = max(offsets[g], m0);
  const int row_hi = min(offsets[g + 1], m0 + BM);
  if (row_lo >= row_hi) return;
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a16::kGroup) * N;
  const char* sc_g = static_cast<const char*>(sc)
                     + g * gstride * (kF32 ? sizeof(float) : sizeof(__nv_bfloat16));

  typename T::Acc acc;
  T::zero(acc);
  T::mainloop(acc, sm, x, qw + g * wstride, sc_g, zr + g * gstride, m0,
              row_lo, row_hi, n0, N, K, 0, (K / 2) / KP);
  T::for_each_out(acc, m0, n0, row_lo, row_hi, [&](int row, int col, float v) {
    store_bf16(out, (size_t)row * N + col, v);
  });
}

// Prefill-sized dense GEMM: one 128 x BN tile per block, grid 1-D over
// the tiles in raster groups of kRasterGroup m-tiles (m fastest inside a
// group).
template <int BN, bool kF32>
__global__ void __launch_bounds__(w4a16_wgmma::kThreads, 1)
w4a16_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ qw,
                        const void* __restrict__ sc,
                        const int8_t* __restrict__ zr,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using L = w4a16_wgmma::Mainloop<BN, kPrefillStages, kF32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tiles_m = (M + w4a16_wgmma::kBM - 1) / w4a16_wgmma::kBM;
  const int per_group = kRasterGroup * (N / BN);
  const int first_m = (blockIdx.x / per_group) * kRasterGroup;
  const int gm = min(kRasterGroup, tiles_m - first_m);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * w4a16_wgmma::kBM;
  const int n0 = (in_group / gm) * BN;

  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, base, x, qw, sc, zr, m0, 0, M, n0, N, K);
  L::store(acc, out, m0, 0, M, n0, N);
}

// Prefill-sized grouped GEMM: logical tile blockIdx.y of the tile map,
// columns blockIdx.x * BN.., only the rows of the tile's expert.
template <int BN, bool kF32>
__global__ void __launch_bounds__(w4a16_wgmma::kThreads, 1)
moe_grouped_w4a16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ qw,
                               const void* __restrict__ sc,
                               const int8_t* __restrict__ zr,
                               const int* __restrict__ gid,
                               const int* __restrict__ mtid,
                               const int* __restrict__ offsets,
                               const int* __restrict__ valid,
                               __nv_bfloat16* __restrict__ out, int N, int K) {
  using L = w4a16_wgmma::Mainloop<BN, kPrefillStages, kF32>;
  extern __shared__ uint8_t smem_raw[];
  const int i = blockIdx.y;
  if (!valid[i]) return;
  const int g = gid[i];
  const int m0 = mtid[i] * w4a16_wgmma::kBM;
  const int row_lo = max(offsets[g], m0);
  const int row_hi = min(offsets[g + 1], m0 + w4a16_wgmma::kBM);
  if (row_lo >= row_hi) return;
  uint8_t* base = aligned_smem(smem_raw);
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a16_wgmma::kGroup) * N;
  const char* sc_g = static_cast<const char*>(sc)
                     + g * gstride * (kF32 ? sizeof(float) : sizeof(__nv_bfloat16));

  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, base, x, qw + g * wstride, sc_g, zr + g * gstride, m0, row_lo,
         row_hi, n0, N, K);
  L::store(acc, out, m0, row_lo, row_hi, n0, N);
}

// Launch `kernel` with the main loop's dynamic shared memory (above the
// 48 KB default, so the limit is raised first).
template <int BN, bool kF32, class Kernel, class... Args>
int launch_wgmma(Kernel kernel, dim3 grid, cudaStream_t st, Args... args) {
  constexpr int smem =
      w4a16_wgmma::Mainloop<BN, kPrefillStages, kF32>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, w4a16_wgmma::kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int BN, bool kF32>
int launch_gemm_wgmma(const void* x, const void* qw, const void* sc,
                      const void* z, void* out, int M, int N, int K,
                      cudaStream_t st) {
  const int tiles = (M + w4a16_wgmma::kBM - 1) / w4a16_wgmma::kBM * (N / BN);
  return launch_wgmma<BN, kF32>(
      w4a16_gemm_wgmma_kernel<BN, kF32>, dim3(tiles), st,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      sc, static_cast<const int8_t*>(z), static_cast<__nv_bfloat16*>(out), M,
      N, K);
}

template <int BN, bool kF32>
int launch_grouped_wgmma(const void* x, const void* qw, const void* sc,
                         const void* z, const void* gid, const void* mtid,
                         const void* offsets, const void* valid, void* out,
                         int n_logical, int N, int K, cudaStream_t st) {
  return launch_wgmma<BN, kF32>(
      moe_grouped_w4a16_wgmma_kernel<BN, kF32>, dim3(N / BN, n_logical), st,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      sc, static_cast<const int8_t*>(z), static_cast<const int*>(gid),
      static_cast<const int*>(mtid), static_cast<const int*>(offsets),
      static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(out), N, K);
}

template <int BM, int BN, int KP, int WM, int WN, bool kF32>
void launch_gemm(const void* x, const void* qw, const void* sc, const void* z,
                 void* out, float* ws, int* counters, int M, int N, int K,
                 int splits, cudaStream_t st) {
  const int nsteps = (K / 2) / KP;
  const int per = (nsteps + splits - 1) / splits;
  const int used = (nsteps + per - 1) / per;
  dim3 grid(N / BN, (M + BM - 1) / BM, used);
  auto kernel = used > 1
      ? w4a16_gemm_kernel<BM, BN, KP, WM, WN, kF32, true>
      : w4a16_gemm_kernel<BM, BN, KP, WM, WN, kF32, false>;
  kernel<<<grid, WM * WN * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      sc, static_cast<const int8_t*>(z), out, ws, counters, M, N, K, per);
}

template <bool kF32>
int gemm(const void* x, const void* qw, const void* sc, const void* z,
         void* out, float* ws, int* cnt, int M, int N, int K, int splits,
         cudaStream_t st) {
  if (M <= 16) {
    launch_gemm<16, kDecodeBN, kDecodeKP, 1, 4, kF32>(
        x, qw, sc, z, out, ws, cnt, M, N, K, splits, st);
  } else if (M <= 32) {
    launch_gemm<32, kDecodeBN, kDecodeKP, 1, 4, kF32>(
        x, qw, sc, z, out, ws, cnt, M, N, K, splits, st);
  } else if (M <= 64) {
    launch_gemm<64, kDecodeBN, kDecodeKP, 1, 4, kF32>(
        x, qw, sc, z, out, ws, cnt, M, N, K, splits, st);
  } else {
    const int tiles_m = (M + w4a16_wgmma::kBM - 1) / w4a16_wgmma::kBM;
    return N % 256 == 0 && tiles_m * (N / 256) >= num_sms()
        ? launch_gemm_wgmma<256, kF32>(x, qw, sc, z, out, M, N, K, st)
        : launch_gemm_wgmma<128, kF32>(x, qw, sc, z, out, M, N, K, st);
  }
  return (int)cudaGetLastError();
}

template <int BM, int BN, int KP, int WM, int WN, bool kF32>
void launch_grouped(const void* x, const void* qw, const void* sc,
                    const void* z, const void* gid, const void* mtid,
                    const void* offsets, const void* valid, void* out,
                    int n_logical, int N, int K, cudaStream_t st) {
  dim3 grid(N / BN, n_logical);
  moe_grouped_w4a16_kernel<BM, BN, KP, WM, WN, kF32>
      <<<grid, WM * WN * 32, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const uint8_t*>(qw), sc, static_cast<const int8_t*>(z),
          static_cast<const int*>(gid), static_cast<const int*>(mtid),
          static_cast<const int*>(offsets), static_cast<const int*>(valid),
          out, N, K);
}

template <bool kF32>
int grouped(const void* x, const void* qw, const void* sc, const void* z,
            const void* gid, const void* mtid, const void* offsets,
            const void* valid, void* out, int n_logical, int bm, int N, int K,
            cudaStream_t st) {
  if (bm == 16) {
    launch_grouped<16, kDecodeBN, kDecodeKP, 1, 4, kF32>(
        x, qw, sc, z, gid, mtid, offsets, valid, out, n_logical, N, K, st);
  } else if (bm == w4a16_wgmma::kBM) {
    return N % 256 == 0
        ? launch_grouped_wgmma<256, kF32>(x, qw, sc, z, gid, mtid, offsets,
                                          valid, out, n_logical, N, K, st)
        : launch_grouped_wgmma<128, kF32>(x, qw, sc, z, gid, mtid, offsets,
                                          valid, out, n_logical, N, K, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dense w4a16 GEMM. x bf16 [M, K], out bf16 [M, N]; scales bf16 or f32
// (scales_f32) [K/128, N]. M <= 64: 64-column tiles (N % 64 == 0), K split
// `splits` ways; then `ws` (f32, >= splits * M * N) and `counters` (int32,
// one per 64-column tile, all zero on entry and on return) are caller-
// owned scratch. M > 64: 128-row tiles of 256 or 128 columns (N % 128 ==
// 0), no scratch; x, qweight, scales and zeros 16-byte aligned.
// Requires K % 256 == 0. Returns cudaGetLastError().
extern "C" int ferrum_w4a16_gemm(const void* x, const void* qw, const void* sc,
                                 const void* z, void* out, void* ws,
                                 void* counters, int M, int N, int K,
                                 int splits, int scales_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (M < 1 || splits < 1 || (splits > 1 && (M > 64 || !wsp || !cnt))) {
    return (int)cudaErrorInvalidValue;
  }
  return scales_f32
      ? gemm<true>(x, qw, sc, z, out, wsp, cnt, M, N, K, splits, st)
      : gemm<false>(x, qw, sc, z, out, wsp, cnt, M, N, K, splits, st);
}

// Grouped w4a16 GEMM over expert-sorted rows. x bf16 [A, K], out bf16
// [A, N]; stacks qweight [E, K/2, N], scales/zeros [E, K/128, N];
// gid/mtid/valid int32 [n_logical] and offsets int32 [E + 1] on the device
// (group_tile_map with the same bm). bm 16: 64-column tiles (N % 64 == 0);
// bm 128: 256- or 128-column tiles (N % 128 == 0), x and the stacks
// 16-byte aligned. Requires K % 256 == 0. Returns
// cudaGetLastError().
extern "C" int ferrum_moe_grouped_w4a16(const void* x, const void* qw,
                                        const void* sc, const void* z,
                                        const void* gid, const void* mtid,
                                        const void* offsets, const void* valid,
                                        void* out, int n_logical, int bm,
                                        int N, int K, int scales_f32,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scales_f32
      ? grouped<true>(x, qw, sc, z, gid, mtid, offsets, valid, out,
                      n_logical, bm, N, K, st)
      : grouped<false>(x, qw, sc, z, gid, mtid, offsets, valid, out,
                       n_logical, bm, N, K, st);
}
