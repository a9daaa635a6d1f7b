// Float-scale w4a8 decode GEMM for Hopper (sm_90a), plain C interface for
// ctypes:
//
//   y[m, n] = out_t( acc[m, n] * xs[m] ),
//   acc = sum over TPU K steps kk, in order, of  lo(kk) then hi(kk),
//   lo(kk) = sum_{t < gpt} s[g, n] * f32(sum_{k in g} xq[m, k] * (q[k, n] - z[g, n]))
//            over the low plane's groups g = kk * gpt + t (summed from t = 0),
//   hi(kk) = the same over the high plane's groups half_groups + kk * gpt + t
//
// with q packed int4 in GLOBAL HALVES (ops/quant.py) and float group
// scales s (bf16 or f32, used as f32). This is the function and the
// float order of the TPU kernel it replaces, `_qmm_w4a8_kernel` in
// ferrum_tpu/ops/pallas/quant_matmul.py, which computes each group's
// term as (f32(sum xq * q) - z * f32(sum xq)) * s: both integers are below
// 2^24, so that difference is exact and equals f32(sum xq * (q - z)); the
// one rounding is the multiply by s. Every multiply and add is an
// explicit __fmul_rn / __fadd_rn (no FMA contraction), so the kernel
// equals its plain version (ops/kernels/quant_matmul.py::w4a8_plain) and
// an interpret-mode run of the TPU kernel bit for bit. gpt (groups per
// TPU K step) is the TPU wrapper's bkb / 128 (quant_matmul.py::
// w4a8_step_rows; fs_gpt below).
//
// What bounds it on the H100: it runs at decode (m <= 64), streaming the
// packed weight once per call for ~2m int8 ops per weight: HBM-bound
// (3.35 TB/s), like the two-level decode GEMMs, whose streamed main loop
// it runs.
//
// Design: the float-scale form of w4a8tl_stream.cuh's main loop
// (FloatScale, fs_decode_kernel) and its launcher (fs_decode_any): the
// group-dot form's ring of 16-byte cp.async copies, raw-nibble unpack and
// per-half int32 dots and row sums, kept over each group's two streamed
// steps; once a group and half the term f32(dot - z * sum(xq)) * s joins
// that half's plane sum, and at each TPU step's end acc = (acc + lo) +
// hi. 64-column tiles (128 for weights over 16 MiB), 256 threads, row
// tiles of 16 / 32 / 64 rows and K splits on TPU-step boundaries chosen
// by one cost model that counts the splits' f32 planes and the row
// tiles' weight re-reads as bytes, each kernel compiled to the register
// cap of the blocks an SM it should hold (its five fragments -- acc, the
// two plane sums, the two halves' dots -- take more registers than the
// group-dot form's, and occupancy was its largest lever). Split 0 writes its acc, each later split its TPU
// steps' (lo, hi) planes, and the tile's last arrival continues the fold
// in TPU-step order, so the order never depends on which block finished
// first. The first version of this kernel split K at every TPU step and
// wrote every step's two planes (~54.5 MB a llama layer at m = 32, half
// the weight's bytes), staged the weight with 4-byte loads between two
// barriers a group and subtracted the zeros byte by byte.

#include <cstdint>

#include "w4a8tl_stream.cuh"

// The float-scale form's launcher (fs_decode_any): column tiles of 64 or
// 128, row tiles and K splits on TPU-step boundaries by one cost model.
// Internal linkage, as the two-level launchers' (w4a8tl_stream.cuh): a
// probe's rebuilt copy of this library keeps its own once-per-device
// state.
namespace {

using namespace w4a8tl_stream;

constexpr int kFsStages = 4;
constexpr int kFsThreads = 256;
// Row tiles: BM from all of m (16 / 32 / 64) down to kFsMinBM, at most
// kFsMaxBM (and fs_top_bm's).
constexpr int kFsMinBM = 16;
constexpr int kFsMaxBM = 64;
// A streamed step's time grows with the block's rows (the mma, the xq
// lines): 1 + kFsRowStep * (BM / 16 - 1) steps of a 16-row block.
constexpr double kFsRowStep = 0.25;

// The largest row tile at BN columns and kThreads threads: the five
// fragments of a larger one spill.
template <int BN, int kThreads>
constexpr int fs_top_bm() {
  const int fits = kThreads == 256 ? (BN == 64 ? 64 : 32)
                                   : (BN == 64 ? 32 : 16);
  return fits < kFsMaxBM ? fits : kFsMaxBM;
}

// The resident blocks an SM each kernel is compiled to fit
// (__launch_bounds__: a register cap of 65536 / (blocks * threads)), the
// most it holds without spilling -- BM 64 at 256 threads spills ~50 bytes
// at 2, against one block an SM at 162 registers. Uncapped, ptxas gives
// BM 32 at 256 threads 124 registers (two blocks), capped at 85 it fits
// 80 (three).
template <int BM, int BN, int kThreads>
constexpr int fs_min_blocks() {
  if (kThreads == 256) return BN == 128 ? 2 : BM == 16 ? 4 : BM == 32 ? 3 : 2;
  return BN == 128 ? 3 : BM == 16 ? 4 : 3;
}

template <int BM, int BN, int kThreads, bool kSplit>
auto fs_kernel() {
  return fs_decode_kernel<BM, BN, kFsStages, kThreads,
                          fs_min_blocks<BM, BN, kThreads>(), kSplit>;
}

// The arguments of a float-scale decode launch; plan as DecodeArgs'
// (plan[5]: TPU K steps a split).
struct FsArgs {
  const void *xq, *xs, *qw, *sc, *z;
  void* out;
  float* part;
  int* counters;
  int M, N, K, splits, sf32, out_bf16;
  cudaStream_t st;
  int* plan;
};

// Groups of each plane a TPU K step: the TPU wrapper's bkb / 128, bkb the
// largest of 512, 256, 128 that divides K/2 (w4a8_step_rows); 0 if none.
inline int fs_gpt(int K) {
  int bkb = 512;
  while (bkb >= kGroup && (K / 2) % bkb) bkb /= 2;
  return bkb >= kGroup ? bkb / kGroup : 0;
}

// Raise both split forms' shared-memory limit once per device; resident
// blocks an SM (at least 1).
template <int BM, int BN, int kThreads>
int fs_prepare(int* per_sm) {
  using F = FloatScale<BM, BN, kFsStages, kThreads>;
  const auto split_k = fs_kernel<BM, BN, kThreads, true>();
  const auto whole = fs_kernel<BM, BN, kThreads, false>();
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    for (auto kernel : {split_k, whole}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmemBytes);
      if (e != cudaSuccess) return (int)e;
    }
    ready.fetch_or(bit);
  }
  static const int b = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_k, kThreads,
                                                  F::kSmemBytes);
    return n > 0 ? n : 1;
  }();
  *per_sm = b;
  return (int)cudaSuccess;
}

template <int BM, int BN, int kThreads>
int fs_launch(const FsArgs& a, int gpt, int splits, int per) {
  using F = FloatScale<BM, BN, kFsStages, kThreads>;
  const auto split_k = fs_kernel<BM, BN, kThreads, true>();
  const auto whole = fs_kernel<BM, BN, kThreads, false>();
  const auto kernel = splits > 1 ? split_k : whole;
  const dim3 grid((a.M + BM - 1) / BM, a.N / BN, splits);
  kernel<<<grid, kThreads, F::kSmemBytes, a.st>>>(
      static_cast<const int8_t*>(a.xq), static_cast<const float*>(a.xs),
      static_cast<const uint8_t*>(a.qw), static_cast<const uint8_t*>(a.sc),
      static_cast<const int8_t*>(a.z), a.out, a.part, a.counters, a.M, a.N,
      a.K, gpt, per, a.sf32, a.out_bf16);
  return (int)cudaGetLastError();
}

// The plan: the (BM, splits) of the least cost
//   waves * (steps a split * (1 + kFsRowStep * (BM / 16 - 1)) + kBlockSteps)
//   + (plane bytes written and read + weight bytes read again)
//     / the weight bytes of one step of all resident blocks,
// waves of row tiles * column tiles * splits blocks on the resident slots,
// plane bytes 8 * M * N * (1 + 2 * (T - per)) where there is more than one
// split, the weight read again by each row tile after the first (from L2,
// but through the SMs' copies and unpack all the same); ties to the fewer
// blocks. a.splits > 0 fixes the split count (at most one a TPU step).
template <int BN, int kThreads>
int fs_decode(const FsArgs& a) {
  constexpr int top = fs_top_bm<BN, kThreads>();
  const int gpt = fs_gpt(a.K);
  const int T = (a.K / 2) / (gpt * kGroup);
  const int tiles = a.N / BN;
  const int sms = w4a8tl_wgmma::num_sms();
  const int bms[3] = {16, 32, 64};
  int per_sm[3] = {1, 1, 1};
  int e = fs_prepare<16, BN, kThreads>(per_sm);
  if constexpr (top >= 32) {
    if (!e) e = fs_prepare<32, BN, kThreads>(per_sm + 1);
  }
  if constexpr (top >= 64) {
    if (!e) e = fs_prepare<64, BN, kThreads>(per_sm + 2);
  }
  if (e) return e;
  const int full = a.M <= 16 ? 16 : a.M <= 32 ? 32 : 64;
  const int hi_bm = min(top, full);
  const int lo_bm = min(kFsMinBM, hi_bm);
  int best_bm = hi_bm, best_s = 1, best_per = T;
  long best_blocks = 0;
  double best_cost = -1;
  for (int i = 0; i < 3; ++i) {
    const int bm = bms[i];
    if (bm < lo_bm || bm > hi_bm) continue;
    const int rt = (a.M + bm - 1) / bm;
    const long slots = (long)sms * per_sm[i];
    const double step = 1.0 + kFsRowStep * (bm / 16 - 1);
    const int s_lo = a.splits > 0 ? min(a.splits, T) : 1;
    const int s_hi = a.splits > 0 ? s_lo : T;
    for (int s = s_lo; s <= s_hi; ++s) {
      const int per = (T + s - 1) / s;
      const int used = (T + per - 1) / per;   // every split gets steps
      if (used != s && a.splits <= 0) continue;
      const long blocks = (long)tiles * rt * used;
      const long waves = (blocks + slots - 1) / slots;
      const double planes = used > 1 ? 1 + 2.0 * (T - per) : 0.0;
      const double cost =
          waves * (per * 2.0 * gpt * step + kBlockSteps)
          + (planes * 8.0 * a.M * a.N + (rt - 1) * (a.K / 2.0) * a.N)
            / ((double)slots * kKP * BN);
      if (best_cost < 0 || cost < best_cost
          || (cost == best_cost && blocks < best_blocks)) {
        best_cost = cost;
        best_bm = bm;
        best_s = used;
        best_per = per;
        best_blocks = blocks;
      }
    }
  }
  if (a.plan) {
    const int bi = best_bm == 16 ? 0 : best_bm == 32 ? 1 : 2;
    const int plan[7] = {best_bm, BN, kThreads, kFsStages, best_s,
                         best_per, per_sm[bi]};
    for (int i = 0; i < 7; ++i) a.plan[i] = plan[i];
    return (int)cudaSuccess;
  }
  if constexpr (top >= 64) {
    if (best_bm == 64) return fs_launch<64, BN, kThreads>(a, gpt, best_s, best_per);
  }
  if constexpr (top >= 32) {
    if (best_bm == 32) return fs_launch<32, BN, kThreads>(a, gpt, best_s, best_per);
  }
  return fs_launch<16, BN, kThreads>(a, gpt, best_s, best_per);
}

// A float-scale decode launch (or its plan): 64 columns where N % 128 !=
// 0 or the packed weight is small (kNarrowBytes, the two-level decode
// rule), else 128; kFsThreads threads. Requires 1 <= M <= 64,
// K % 256 == 0, N % 64 == 0.
inline int fs_decode_any(const FsArgs& a) {
  if (a.M < 1 || a.M > 64 || a.K % 256 || a.N % 64 || !fs_gpt(a.K)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool fs_narrow = a.N % 128 != 0 || (long)a.K / 2 * a.N <= kNarrowBytes;
  return fs_narrow ? fs_decode<64, kFsThreads>(a)
                   : fs_decode<128, kFsThreads>(a);
}

}  // namespace

// xq int8 [M, K], xs f32 [M], qweight uint8 [K/2, N], scales bf16 or f32
// (scales_f32) [K/128, N], zeros int8 [K/128, N], out [M, N] bf16 or f32.
// `splits` 0: the launcher's plan (ferrum_w4a8_decode_plan); else that
// many K splits (at most one a TPU step). With more than one split, `ws`
// is f32 [1 + 2 * (T - per), M, N] of any contents (T TPU steps, per a
// split: the plan's) and `counters` (int32, one per (row tile, 64-column
// tile): N / 64 times the row tiles) all zero on entry and all zero again
// on return; with one, neither is touched. Requires 1 <= M <= 64,
// K % 256 == 0, N % 64 == 0, and xq, qweight, scales and zeros 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int ferrum_w4a8_decode(const void* xq, const void* xs,
                                  const void* qw, const void* sc,
                                  const void* z, void* out, void* ws,
                                  void* counters, int M, int N, int K,
                                  int splits, int scales_f32, int out_bf16,
                                  void* stream) {
  return fs_decode_any({xq, xs, qw, sc, z, out, static_cast<float*>(ws),
                        static_cast<int*>(counters), M, N, K, splits,
                        scales_f32, out_bf16,
                        static_cast<cudaStream_t>(stream), nullptr});
}

// The launch ferrum_w4a8_decode would make for (M, N, K, splits), without
// making it: plan[0..6] = BM (rows a row tile), BN, threads, ring stages,
// splits, TPU K steps per split, resident blocks per SM. Returns a
// cudaError_t.
extern "C" int ferrum_w4a8_decode_plan(int M, int N, int K, int splits,
                                       int* plan) {
  return fs_decode_any({nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, M, N, K, splits, 0, 0,
                        nullptr, plan});
}
