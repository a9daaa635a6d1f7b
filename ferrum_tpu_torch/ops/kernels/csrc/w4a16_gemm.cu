// w4a16 GEMMs for Hopper (sm_90a), plain C interface for ctypes:
//
//   y[m, n] = bf16( sum_k x[m, k] * w[k, n] ),  x bf16, f32 sums,
//   w[k, n] = bf16( bf16(q[k, n] - zeros[g(k), n]) * bf16(scales[g(k), n]) )
//
// with q packed int4 in GLOBAL HALVES (ops/quant.py). The dequant and the
// bf16 x bf16 -> f32 main loop are w4a16_stream::Stream (w4a16_stream.cuh,
// the streamed decode loop in bf16) at decode sizes and
// w4a16_wgmma::Mainloop (w4a16_wgmma.cuh) at prefill sizes.
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
//  - dense, m <= 64: w4a16_stream.cuh (a ring of 16-byte cp.async copies
//    several K steps deep, the dequant of step s+1 overlapping the
//    mma.sync of step s, one barrier a step), all of m in one block, 64
//    or 128 columns, K split across blockIdx.z by its launcher's rule so
//    the blocks fill the resident slots in whole waves. Each split writes
//    its f32 partial tile to a plane of part [splits, M, N]; the split
//    that arrives last at a tile (a per-tile counter) sums the planes in
//    split order, writes bf16 and re-zeroes the counter, so a call is one
//    launch and the result does not depend on which split finished first.
//  - dense, m > 64: w4a16_wgmma::Mainloop (w4a16_wgmma.cuh: a cp.async
//    ring, packed bf16x2 dequant overlapping wgmma), 128-row tiles of
//    256 columns (128 where N % 256 != 0 or 256-column tiles would not
//    fill the SMs once), full K per block; blocks walk the tiles in
//    groups of 16 m-tiles so a wave shares weight tiles in L2.
//  - grouped: the two-level grouped GEMM's structure (moe_gemm.cu): a
//    static grid of ceil(A / BM) + E - 1 logical tiles x N tiles, the
//    device-side tile map (moe_gemm.py::group_tile_map) giving each an
//    (expert, m-tile) pair; a block stages only its expert's rows of the
//    m-tile and writes only them. BM = 16 on w4a16_stream.cuh (the full
//    K, no split) for decode-sized A <= 256, else BM = 128 on
//    w4a16_wgmma::Mainloop (256 columns where N % 256 == 0, else 128).

#include "w4a16_stream.cuh"
#include "w4a16_wgmma.cuh"

namespace {

using w4a16_wgmma::aligned_smem;
using w4a16_wgmma::num_sms;

constexpr int kPrefillStages = 4;   // cp.async ring depth
constexpr int kRasterGroup = 16;    // m-tiles per raster group

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

template <bool kF32>
int gemm(const void* x, const void* qw, const void* sc, const void* z,
         void* out, int M, int N, int K, cudaStream_t st) {
  const int tiles_m = (M + w4a16_wgmma::kBM - 1) / w4a16_wgmma::kBM;
  return N % 256 == 0 && tiles_m * (N / 256) >= num_sms()
      ? launch_gemm_wgmma<256, kF32>(x, qw, sc, z, out, M, N, K, st)
      : launch_gemm_wgmma<128, kF32>(x, qw, sc, z, out, M, N, K, st);
}

template <bool kF32>
int grouped(const void* x, const void* qw, const void* sc, const void* z,
            const void* gid, const void* mtid, const void* offsets,
            const void* valid, void* out, int n_logical, int N, int K,
            cudaStream_t st) {
  return N % 256 == 0
      ? launch_grouped_wgmma<256, kF32>(x, qw, sc, z, gid, mtid, offsets,
                                        valid, out, n_logical, N, K, st)
      : launch_grouped_wgmma<128, kF32>(x, qw, sc, z, gid, mtid, offsets,
                                        valid, out, n_logical, N, K, st);
}

// The streamed decode loop's arguments of a dense launch (or plan).
w4a16_stream::Args dense_args(const void* x, const void* qw, const void* sc,
                              const void* z, void* out, void* part,
                              void* counters, int M, int N, int K,
                              int splits, int scales_f32, void* stream,
                              int* plan) {
  return {x, qw, sc, z, nullptr, nullptr, nullptr, nullptr, out,
          static_cast<float*>(part), static_cast<int*>(counters), M, N, K,
          splits, scales_f32, static_cast<cudaStream_t>(stream), plan};
}

// ... and of a grouped one at 16-row tiles.
w4a16_stream::Args grouped_args(const void* x, const void* qw,
                                const void* sc, const void* z,
                                const void* gid, const void* mtid,
                                const void* offsets, const void* valid,
                                void* out, int n_logical, int N, int K,
                                int scales_f32, void* stream, int* plan) {
  return {x, qw, sc, z, static_cast<const int*>(gid),
          static_cast<const int*>(mtid), static_cast<const int*>(offsets),
          static_cast<const int*>(valid), out, nullptr, nullptr, n_logical,
          N, K, 1, scales_f32, static_cast<cudaStream_t>(stream), plan};
}

}  // namespace

// Dense w4a16 GEMM. x bf16 [M, K], out bf16 [M, N]; scales bf16 or f32
// (scales_f32) [K/128, N]. M <= 64: the streamed decode loop, BN = 64 or
// 128 columns (N % 64 == 0), K split across blockIdx.z into `splits`
// parts (0: the launcher's count; at most one split per K step;
// ferrum_w4a16_decode_plan gives the count a launch takes). With more
// than one split, `ws` is f32 [splits, M, N] of any contents (the splits'
// partial sums) and `counters` (int32, one per column tile: N / 64
// suffice) caller-owned scratch that must be all zero on entry and is all
// zero again on return; with one, neither is touched. M > 64: 128-row
// tiles of 256 or 128 columns (N % 128 == 0), no scratch. x, qweight,
// scales and zeros 16-byte aligned; K % 256 == 0. Returns
// cudaGetLastError().
extern "C" int ferrum_w4a16_gemm(const void* x, const void* qw, const void* sc,
                                 const void* z, void* out, void* ws,
                                 void* counters, int M, int N, int K,
                                 int splits, int scales_f32, void* stream) {
  if (M < 1 || splits < 0) return (int)cudaErrorInvalidValue;
  if (M <= 64) {
    return w4a16_stream::decode_any<false>(
        dense_args(x, qw, sc, z, out, ws, counters, M, N, K, splits,
                   scales_f32, stream, nullptr));
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scales_f32 ? gemm<true>(x, qw, sc, z, out, M, N, K, st)
                    : gemm<false>(x, qw, sc, z, out, M, N, K, st);
}

// The launch ferrum_w4a16_gemm would make at M <= 64 for (M, N, K,
// splits) with bf16 scales, without making it: plan[0..6] = BM, BN,
// threads, ring stages, splits, K steps per split, resident blocks per
// SM. Returns a cudaError_t.
extern "C" int ferrum_w4a16_decode_plan(int M, int N, int K, int splits,
                                        int* plan) {
  return w4a16_stream::decode_any<false>(
      dense_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, M, N, K, splits, 0, nullptr, plan));
}

// Grouped w4a16 GEMM over expert-sorted rows. x bf16 [A, K], out bf16
// [A, N]; stacks qweight [E, K/2, N], scales/zeros [E, K/128, N];
// gid/mtid/valid int32 [n_logical] and offsets int32 [E + 1] on the device
// (group_tile_map with the same bm). bm 16: the streamed decode loop on
// 64- or 128-column tiles (N % 64 == 0); bm 128: 256- or 128-column tiles
// (N % 128 == 0). x and the stacks 16-byte aligned; K % 256 == 0.
// Returns cudaGetLastError().
extern "C" int ferrum_moe_grouped_w4a16(const void* x, const void* qw,
                                        const void* sc, const void* z,
                                        const void* gid, const void* mtid,
                                        const void* offsets, const void* valid,
                                        void* out, int n_logical, int bm,
                                        int N, int K, int scales_f32,
                                        void* stream) {
  if (bm == 16) {
    return w4a16_stream::decode_any<true>(
        grouped_args(x, qw, sc, z, gid, mtid, offsets, valid, out,
                     n_logical, N, K, scales_f32, stream, nullptr));
  }
  if (bm != w4a16_wgmma::kBM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scales_f32
      ? grouped<true>(x, qw, sc, z, gid, mtid, offsets, valid, out,
                      n_logical, N, K, st)
      : grouped<false>(x, qw, sc, z, gid, mtid, offsets, valid, out,
                       n_logical, N, K, st);
}

// The launch ferrum_moe_grouped_w4a16 would make at bm 16 over n_logical
// logical tiles with bf16 scales, without making it: plan[0..6] as
// ferrum_w4a16_decode_plan's (one split of every K step). Returns a
// cudaError_t.
extern "C" int ferrum_moe_grouped_w4a16_plan(int n_logical, int N, int K,
                                             int* plan) {
  return w4a16_stream::decode_any<true>(
      grouped_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, n_logical, N, K, 0, nullptr,
                   plan));
}
