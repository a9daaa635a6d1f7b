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
// The grouped GEMM reads only the experts that have rows. At decode sizes
// its bound is the bytes too (t = 1: 8 rows over 8 experts, ~19.6 MB of
// weights a qwen3 layer's gate, up and down, 5.9 us at 3.35 TB/s), but
// few blocks stream them: a launch's fixed cost and each block's serial
// K steps take most of its time (PERF.md). At a 2048-token
// prefill (16384 rows at top-8) it does 2 * 16384 * K * N int8 ops
// against the same ~100 MB of weights plus the rows: HBM-bound by the
// bytes it must move (0.05 ms a projection), and the int8 tensor-core
// rate is the second wall -- which the 128-row tiles reach first in
// practice: with ~128 rows per expert most tiles hold ~64 rows of their
// expert, so the tensor cores do about twice the real work.
//
// Design:
//  - bmm: the decode GEMMs' streamed main loop (w4a8tl_stream.cuh, its
//    w8 form: a ring of 16-byte cp.async copies several K steps deep,
//    the dequant of step s+1 overlapping the mma.sync of step s, one
//    barrier a step) with the expert as a grid axis: grid (N / BN, E),
//    one block per (column tile, expert) with every row in it (BM = 16 /
//    32 / 64 >= t), walking the full K. The block offsets the stacks'
//    pointers by its expert, and xq / xs too where each expert has its
//    own rows (down; gate and up share one [t, K] block), then runs
//    Stream::run and Stream::finish<false>, whose epilogue is this
//    kernel's order. One K split: E x N / BN blocks fill the SMs in
//    whole waves without one (at the qwen3-30b-a3b shapes 768 blocks for
//    gate and up, 2048 for down, at BN 128), so there are no partial
//    planes, no arrival counters and no scratch. The launcher picks BN
//    and the thread count by the E x N / BN tiles and the ring's depth
//    by BM (its rule lines below; on an H100 each pick beat the others
//    at every qwen3-30b-a3b site, PERF.md).
//  - grouped at decode sizes (A <= 256 rows): the same loop with the
//    expert as a grid axis, grid (N / BN, E). A block reads its expert's
//    row window [offsets[e], offsets[e + 1]) and walks it in chunks of BM
//    rows (an expert with no rows exits before any load), each chunk the
//    full K through Stream::run on xq + row_lo * K with M = the chunk's
//    rows (the loop zero-fills rows >= M), then finish<false, true>: the
//    chan-first epilogue, into the chunk's rows of out. Chunks are 16
//    rows: at top-8 routing a decode expert holds ~1-2 rows (at most A /
//    8), so one chunk is the usual case, and each touched expert's
//    weight tile is read once a chunk. No tile map: the offsets alone
//    place the rows. Its launcher picks the threads and the ring's depth
//    by the blocks the expected active experts make (its rule lines
//    below; PERF.md has the probes that chose them).
//  - grouped at prefill sizes: grid (N / BN, logical tiles). The host
//    bounds the logical tiles statically by ceil(A / 128) + E - 1 and the
//    device-side tile map (gid, mtid, valid; moe_gemm.py::group_tile_map,
//    the counterpart of _make_group_metadata) assigns each one an
//    (expert, m-tile) pair; a block whose tile is not valid, or whose
//    expert has no row in its m-tile, exits before any load. A block
//    stages only its expert's rows of the m-tile (the others zero-filled)
//    and writes only those rows: a row belongs to one expert, so a tile
//    shared by two experts is written by two blocks, each its own rows,
//    with no cross-block sum. No host sync: the grid is static and the
//    offsets stay on the device. It runs the dense prefill GEMM's
//    pipelined int8 wgmma main loop (w4a8tl_wgmma.cuh) on the expert's
//    weight, scales and chan, with the row window of the tile's expert
//    and the chan-first epilogue. Both of its warpgroups issue every
//    wgmma, also where the expert's rows all lie in the other one's 64
//    (zero rows): a wgmma behind a branch makes ptxas serialize them all.

#include <atomic>
#include <cmath>

#include "w4a8tl_stream.cuh"
#include "w4a8tl_wgmma.cuh"

namespace {

// One BM x BN tile of expert blockIdx.y, columns blockIdx.x * BN.., over
// the full K: the expert's stacks, its xq / xs rows (x_rows: the rows of
// one expert's block of xq3 / xs3; 0 where every expert shares one
// block), its chan, and its [T, N] plane of out.
template <int BM, int BN, int S, int kThreads>
__global__ void __launch_bounds__(kThreads)
moe_bmm_kernel(const int8_t* __restrict__ xq3, const float* __restrict__ xs3,
               const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
               const int8_t* __restrict__ zr, const float* __restrict__ chan,
               void* __restrict__ out, int x_rows, int T, int N, int K,
               int out_bf16) {
  using L = w4a8tl_stream::Stream<BM, BN, S, kThreads, false>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * BN;
  const size_t e = blockIdx.y;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a8tl_stream::kGroup) * N;
  const size_t ostride = (size_t)T * N * (out_bf16 ? 2 : 4);
  typename L::Acc acc;
  L::T::zero(acc);
  L::run(acc, smem, xq3 + e * x_rows * K, qw + e * wstride, s2 + e * gstride,
         zr + e * gstride, T, n0, N, K, 0, (K / 2) / w4a8tl_stream::kKP);
  L::template finish<false>(acc, xs3 + e * x_rows, chan + e * N,
                            static_cast<uint8_t*>(out) + e * ostride,
                            nullptr, nullptr, n0, T, N, out_bf16);
}

// Decode-sized grouped GEMM: columns blockIdx.x * BN.. of expert
// blockIdx.y over its rows [offsets[e], offsets[e + 1]), BM rows at a
// time, the full K each.
template <int BM, int BN, int S, int kThreads>
__global__ void __launch_bounds__(kThreads)
moe_grouped_stream_kernel(const int8_t* __restrict__ xq,
                          const float* __restrict__ xs,
                          const uint8_t* __restrict__ qw,
                          const int8_t* __restrict__ s2,
                          const int8_t* __restrict__ zr,
                          const float* __restrict__ chan,
                          const int* __restrict__ offsets,
                          void* __restrict__ out, int N, int K,
                          int out_bf16) {
  using L = w4a8tl_stream::Stream<BM, BN, S, kThreads, false>;
  extern __shared__ __align__(16) uint8_t smem[];
  const size_t e = blockIdx.y;
  const int row_lo = offsets[e];
  const int row_hi = offsets[e + 1];
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / w4a8tl_stream::kGroup) * N;
  const size_t row_bytes = (size_t)N * (out_bf16 ? 2 : 4);
  for (int r0 = row_lo; r0 < row_hi; r0 += BM) {
    if (r0 != row_lo) __syncthreads();     // the last chunk's ring reads
    typename L::Acc acc;
    L::T::zero(acc);
    L::run(acc, smem, xq + (size_t)r0 * K, qw + e * wstride,
           s2 + e * gstride, zr + e * gstride, min(BM, row_hi - r0), n0, N,
           K, 0, (K / 2) / w4a8tl_stream::kKP);
    L::template finish<false, true>(
        acc, xs + r0, chan + e * N,
        static_cast<uint8_t*>(out) + r0 * row_bytes, nullptr, nullptr, n0,
        min(BM, row_hi - r0), N, out_bf16);
  }
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

// ---------------------------------------------------------------------------
// The launchers of the bmm (bmm_any) and of the decode-sized grouped GEMM
// (grouped_any), with internal linkage like the decode launcher's
// (w4a8tl_stream.cuh): each library, and each rebuilt copy of one, keeps
// its own once-per-device state.
// ---------------------------------------------------------------------------

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes once per
// device (`ready`: a bit per device where it was raised; the launches are
// on every MoE decode layer's path). Returns a cudaError_t.
template <class Kernel>
int raise_smem(std::atomic<uint64_t>& ready, Kernel kernel, int smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit);
  }
  return (int)cudaSuccess;
}

// `kernel`'s resident blocks an SM at `threads` and `smem` bytes (1 where
// the runtime says 0).
template <class Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, threads, smem);
  return b > 0 ? b : 1;
}

// The ring's depth by the tile's rows: 3 stages where BM <= 32, so that
// a third block fits an SM at BN 128 (down's 6 K steps a block then hide
// its ring fill and epilogue better); 4 at BM 64, where two fit either
// way and the deeper ring wins.
template <int BM>
constexpr int kBmmStages = BM <= 32 ? 3 : 4;

// The arguments of a bmm launch. plan: when not null, the launch is not
// made and plan[0..4] get BM, BN, threads, stages and resident blocks
// per SM.
struct BmmArgs {
  const void *xq3, *xs3, *qw, *s2, *z, *chan;
  void* out;
  int E, T, N, K, shared, out_bf16;
  cudaStream_t st;
  int* plan;
};

template <int BM, int BN, int kThreads>
int bmm(const BmmArgs& a) {
  constexpr int S = kBmmStages<BM>;
  using L = w4a8tl_stream::Stream<BM, BN, S, kThreads, false>;
  const auto kernel = moe_bmm_kernel<BM, BN, S, kThreads>;
  static std::atomic<uint64_t> ready{0};
  const int err = raise_smem(ready, kernel, L::kSmemBytes);
  if (err != (int)cudaSuccess) return err;
  static const int per_sm = blocks_per_sm(kernel, kThreads, L::kSmemBytes);
  if (a.plan) {
    const int plan[5] = {BM, BN, kThreads, S, per_sm};
    for (int i = 0; i < 5; ++i) a.plan[i] = plan[i];
    return (int)cudaSuccess;
  }
  kernel<<<dim3(a.N / BN, a.E), kThreads, L::kSmemBytes, a.st>>>(
      static_cast<const int8_t*>(a.xq3), static_cast<const float*>(a.xs3),
      static_cast<const uint8_t*>(a.qw), static_cast<const int8_t*>(a.s2),
      static_cast<const int8_t*>(a.z), static_cast<const float*>(a.chan),
      a.out, a.shared ? 0 : a.T, a.T, a.N, a.K, a.out_bf16);
  return (int)cudaGetLastError();
}

// The thread count by the E x N / BN tiles: 128 threads where they fill
// the SMs (the rows of a block's mma on fewer warps), else 256.
template <int BM, int BN>
int bmm_threads(const BmmArgs& a) {
  const bool bmm_few = (long)a.E * (a.N / BN) >= w4a8tl_wgmma::num_sms();
  return bmm_few ? bmm<BM, BN, 128>(a) : bmm<BM, BN, 256>(a);
}

template <int BN>
int bmm_bm(const BmmArgs& a) {
  return a.T <= 16 ? bmm_threads<16, BN>(a)
       : a.T <= 32 ? bmm_threads<32, BN>(a)
                   : bmm_threads<64, BN>(a);
}

// A bmm launch (or its plan): all T rows (BM = 16 / 32 / 64) x BN
// columns of one expert a block, the full K. Requires E >= 1, 1 <= T <=
// 64, K % 256 == 0, N % 64 == 0.
int bmm_any(const BmmArgs& a) {
  if (a.E < 1 || a.T < 1 || a.T > 64 || a.K % 256 || a.N % 64) {
    return (int)cudaErrorInvalidValue;
  }
  // 128 columns wherever N allows and the E x N / 128 tiles fill the SMs
  // once: a block stages its BM lines of xq (BM x 144 bytes) every K
  // step beside its packed tile (64 x BN), and every block re-reads them
  // from L2, so wider tiles move fewer bytes; 64 columns only where 128
  // would leave SMs idle.
  const bool bmm_wide =
      a.N % 128 == 0 && (long)a.E * (a.N / 128) >= w4a8tl_wgmma::num_sms();
  return bmm_wide ? bmm_bm<128>(a) : bmm_bm<64>(a);
}

// The decode-sized grouped GEMM's chunk rows at every A <= 256: an
// expert with more rows takes more chunks (at 256 rows on an H100, 16-row
// chunks took 7% less time a qwen3 layer than 32-row ones, PERF.md).
constexpr int kGroupedBM = 16;

// The arguments of a decode-sized grouped launch: A expert-sorted rows,
// offsets int32 [E + 1] on the device. plan: when not null, the launch is
// not made and plan[0..4] get BM, BN, threads, stages and resident blocks
// per SM.
struct GroupedArgs {
  const void *xq, *xs, *qw, *s2, *z, *chan, *offsets;
  void* out;
  int A, E, N, K, out_bf16;
  cudaStream_t st;
  int* plan;
};

template <int BN, int S, int kThreads>
int grouped(const GroupedArgs& a) {
  constexpr int BM = kGroupedBM;
  using L = w4a8tl_stream::Stream<BM, BN, S, kThreads, false>;
  const auto kernel = moe_grouped_stream_kernel<BM, BN, S, kThreads>;
  static std::atomic<uint64_t> ready{0};
  const int err = raise_smem(ready, kernel, L::kSmemBytes);
  if (err != (int)cudaSuccess) return err;
  static const int per_sm = blocks_per_sm(kernel, kThreads, L::kSmemBytes);
  if (a.plan) {
    const int plan[5] = {BM, BN, kThreads, S, per_sm};
    for (int i = 0; i < 5; ++i) a.plan[i] = plan[i];
    return (int)cudaSuccess;
  }
  kernel<<<dim3(a.N / BN, a.E), kThreads, L::kSmemBytes, a.st>>>(
      static_cast<const int8_t*>(a.xq), static_cast<const float*>(a.xs),
      static_cast<const uint8_t*>(a.qw), static_cast<const int8_t*>(a.s2),
      static_cast<const int8_t*>(a.z), static_cast<const float*>(a.chan),
      static_cast<const int*>(a.offsets), a.out, a.N, a.K, a.out_bf16);
  return (int)cudaGetLastError();
}

// The resident blocks of grouped<BN, S, kThreads> on the whole card.
template <int BN, int S, int kThreads>
long grouped_slots(const GroupedArgs& a) {
  int plan[5] = {0, 0, 0, 0, 1};
  GroupedArgs q = a;
  q.plan = plan;
  grouped<BN, S, kThreads>(q);
  return (long)plan[4] * w4a8tl_wgmma::num_sms();
}

// The experts expected to hold rows when A rows fall on E experts at
// random, E (1 - (1 - 1/E)^A): the host cannot see the group sizes
// without a sync (at 128 experts 7.8 / 78 / 111 at 8 / 120 / 256 rows).
double grouped_active(const GroupedArgs& a) {
  return a.E * (1.0 - std::pow(1.0 - 1.0 / a.E, a.A));
}

long waves(double blocks, long slots) {
  return (long)std::ceil(blocks / slots);
}

template <int BN>
int grouped_bn(const GroupedArgs& a) {
  const double blocks = grouped_active(a) * (a.N / BN);
  // Blocks for fewer than half the SMs (t = 1 at gate and up): each
  // streams its tile alone on an SM, through an 8-deep ring on 256
  // threads.
  const bool grouped_few = 2 * blocks < w4a8tl_wgmma::num_sms();
  if (grouped_few) return grouped<BN, 8, 256>(a);
  // Else 128 threads and a 4-deep ring (2 blocks an SM at BN 128), unless
  // a 3-deep one (3 an SM) takes fewer waves.
  const bool grouped_deep = waves(blocks, grouped_slots<BN, 4, 128>(a))
                            <= waves(blocks, grouped_slots<BN, 3, 128>(a));
  return grouped_deep ? grouped<BN, 4, 128>(a) : grouped<BN, 3, 128>(a);
}

// A decode-sized grouped launch (or its plan): one block per (column
// tile, expert), the expert's rows in chunks of kGroupedBM, the full K.
// Requires E >= 1, 1 <= A <= 256, K % 256 == 0, N % 64 == 0.
int grouped_any(const GroupedArgs& a) {
  if (a.E < 1 || a.A < 1 || a.A > 256 || a.K % 256 || a.N % 64) {
    return (int)cudaErrorInvalidValue;
  }
  // 128 columns wherever N allows: a block stages its xq lines beside
  // every packed tile, so wider tiles move fewer bytes.
  const bool grouped_wide = a.N % 128 == 0;
  return grouped_wide ? grouped_bn<128>(a) : grouped_bn<64>(a);
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
// N % 64 == 0, and xq3, qweight, scales2 and zeros 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int ferrum_moe_bmm(const void* xq3, const void* xs3,
                              const void* qw, const void* s2, const void* z,
                              const void* chan, void* out, int E, int T,
                              int N, int K, int shared, int out_bf16,
                              void* stream) {
  return bmm_any({xq3, xs3, qw, s2, z, chan, out, E, T, N, K, shared,
                  out_bf16, static_cast<cudaStream_t>(stream), nullptr});
}

// The launch ferrum_moe_bmm would make for (E, T, N, K), without making
// it: plan[0..4] = BM, BN, threads, ring stages, resident blocks per SM.
// Returns a cudaError_t.
extern "C" int ferrum_moe_bmm_plan(int T, int N, int K, int E, int* plan) {
  return bmm_any({nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, E, T, N, K, 1, 0, nullptr, plan});
}

// Decode-sized grouped GEMM over expert-sorted rows (A <= 256). xq int8
// [A, K], xs f32 [A], out [A, N]: the rows [offsets[e], offsets[e + 1])
// of every expert e, and no other; offsets int32 [E + 1] on the device.
// Requires K % 256 == 0, N % 64 == 0, and xq, qweight, scales2 and
// zeros 16-byte aligned. Returns a cudaError_t.
extern "C" int ferrum_moe_grouped_decode(const void* xq, const void* xs,
                                         const void* qw, const void* s2,
                                         const void* z, const void* chan,
                                         const void* offsets, void* out,
                                         int A, int E, int N, int K,
                                         int out_bf16, void* stream) {
  return grouped_any({xq, xs, qw, s2, z, chan, offsets, out, A, E, N, K,
                      out_bf16, static_cast<cudaStream_t>(stream), nullptr});
}

// The launch ferrum_moe_grouped_decode would make for (A, N, K, E),
// without making it: plan[0..4] = BM, BN, threads, ring stages, resident
// blocks per SM. Returns a cudaError_t.
extern "C" int ferrum_moe_grouped_plan(int A, int N, int K, int E,
                                       int* plan) {
  return grouped_any({nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, A, E, N, K, 0, nullptr, plan});
}

// Prefill-sized grouped GEMM over expert-sorted rows (A > 256). xq int8
// [A, K], xs f32 [A], out [A, N]; gid/mtid/valid int32 [n_logical] and
// offsets int32 [E + 1] on the device (group_tile_map with bm 128): the
// wgmma main loop on 256- or 128-column tiles. Requires N % 128 == 0,
// K % 256 == 0, and xq and the stacks 16-byte aligned. Returns a
// cudaError_t.
extern "C" int ferrum_moe_grouped(const void* xq, const void* xs,
                                  const void* qw, const void* s2,
                                  const void* z, const void* chan,
                                  const void* gid, const void* mtid,
                                  const void* offsets, const void* valid,
                                  void* out, int n_logical, int N, int K,
                                  int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
