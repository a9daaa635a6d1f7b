// The w4a16 GEMMs' main loop at decode sizes on Hopper (sm_90a): one
// block's f32 tile of  acc[m, n] = sum_k x[m, k] * w[k, n]  with bf16 x and
//   w[k, n] = bf16( bf16(q[k, n] - zeros[g(k), n]) * bf16(scales[g(k), n]) ),
// g(k) = k / 128, bit for bit the dequant of the prefill loop
// (w4a16_wgmma.cuh) and of the TPU kernels it replaces at decode sizes in
// ferrum_tpu/ops/pallas/quant_matmul.py:
//   :60  _qmm_kernel   dense projections, m <= 64      (w4a16_gemm.cu)
//   :970 _qgmm_kernel  rows sorted by expert, 16-row tiles (w4a16_gemm.cu)
// and the launcher that plans both. q is packed int4 in GLOBAL HALVES
// (ops/quant.py): byte row r of qweight [K/2, N] holds row r in its low
// nibble and row K/2 + r in its high nibble. Scales are bf16 or f32 (f32
// scales are rounded to bf16 once, when a group's row is read).
//
// What bounds it on the H100: at decode the packed weight is streamed
// once for ~2m flops a weight, far below the tensor cores' rate, so HBM
// (3.35 TB/s) bounds it -- if enough bytes are in flight per SM and the
// per-byte work is off the copies' path. Against the w8 form of the
// streamed loop (w4a8tl_stream.cuh, whose structure this is), a bf16
// weight line is twice as wide: the dequant stores, and the mma reads,
// twice the shared-memory bytes for each packed byte.
//
// Design (the w8 form's, in bf16):
//  - 256 threads (8 warps, 2 x 4 over the tile, 1 x 8 where BM = 16);
//    BM = 16 / 32 / 64 rows, BN = 64 or 128 columns. Dense: all of m,
//    grid y is 1. Grouped: one 16-row m-tile of the
//    expert-sorted rows, staging only the rows of the tile's expert
//    ([row_lo, row_hi)); the others are zero lines.
//  - A K step is kKP = 64 packed rows: 64 low-nibble rows (k = r0 + i)
//    and the 64 matching high-nibble rows (k = K/2 + r0 + i), 128 k. One
//    K-major line per row of x holds [x low 64 | x high 64] and one per
//    column of w [w low 64 | w high 64], in bf16, each padded to kLine =
//    272 bytes (68 words: the 8 lines a fragment load touches start 4
//    banks apart, so the mma.sync fragment loads are free of bank
//    conflicts).
//  - A ring of S stages, filled by 16-byte cp.async, holds per step the
//    x lines (rows outside the window zero-filled), the packed tile
//    ([64, BN] bytes, 16-byte chunk c of row r at c ^ swz(r / R)) and, on
//    a split's first step and each step that starts a group, the group's
//    scale and zero rows of both halves.
//  - Dequant: each thread takes R = 8 packed rows x 4 columns. Per pair
//    of rows (r, r+1), one __byte_perm of the two rows' 32-bit words puts
//    column j's two bytes into bits 0-7 and 16-23, and
//    w4a16_wgmma.cuh's dequant2 makes the k-pair of each half: nibble |
//    0x4300 is bf16(128 + q), minus bf16(128 + z) is q - z exactly,
//    times the bf16 scale rounds once (sub / mul.rn.bf16x2, z and s
//    broadcast to both halves). One 16-byte store per column and half:
//    a quarter warp's stores fill one line's 128 bytes, free of bank
//    conflicts.
//  - mma.sync m16n8k16 bf16 x bf16 -> f32 on the x lines (A) and the w
//    lines (B): 8 k16 slices a step, 4 a half.
//  - Step j, one barrier: wait for step j+1's copies; barrier (step j's
//    w written, step j-1's reads done); start step j+S-1's copies into
//    step j-1's slot; mma on step j and, in the same basic block so the
//    two interleave, dequantize step j+1 into the w buffer step j-1 read.
//  - Split-K epilogue (`finish`): with more than one split (dense only),
//    each split stores its f32 partial sums of the rows below M, as they
//    lie in the fragments, into its own plane of part [splits, M, N]; the
//    tile's last arrival (counted in counters, which it leaves zeroed)
//    sums the planes in split order and writes bf16: the same bits from
//    launch to launch. One split: the block writes bf16 straight from its
//    fragments.
//  - The launcher (`decode_any`): BN 64 where N % 128 != 0 or the packed
//    weight is small, else 128; a 3-stage ring at BM 64, so that two
//    blocks fit an SM, else 4; dense K splits so the blocks
//    fill the resident slots in whole waves (w4a8tl_stream.cuh's
//    decode_splits); the grouped form runs the full K, one block per
//    (column tile, logical tile). Each instantiation keeps its own
//    shared-memory attribute and occupancy. Each rule won its probe at
//    the served qwen3-30b-a3b and llama-3.1-8b sites on an H100
//    (PERF.md, PR 13).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "w4a16_wgmma.cuh"    // cp.async, dequant2, num_sms
#include "w4a8tl_stream.cuh"  // Warps, decode_splits

namespace w4a16_stream {

using w4a16_wgmma::cp_async16;
using w4a16_wgmma::cp_async_commit;
using w4a16_wgmma::cp_async_wait;
using w4a16_wgmma::dequant2;
using w4a16_wgmma::smem_u32;

constexpr int kGroup = 128;
constexpr int kKP = 64;               // packed rows per K step (128 k)
constexpr int kStepsPerGroup = kGroup / kKP;
constexpr int kLine = 4 * kKP + 16;   // one padded K-major bf16 line, bytes
// Threads a block: with 4 warps in place of 8 the dequant's and the
// copies' latencies show (0-31% slower at every served site on an H100,
// also where the column tiles alone fill the SMs; PERF.md, PR 13).
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16_pair(float v) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return b * 0x00010001u;
}

template <int BM, int BN, int S, bool kF32>
struct Stream {
  static_assert(BM == 16 || BM == 32 || BM == 64, "BM is 16, 32 or 64");
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(S >= 3, "the ring holds the step the mma reads, the step "
                        "dequantized and at least one in flight");
  static constexpr int WM = w4a8tl_stream::Warps<BM, kThreads>::WM;
  static constexpr int WN = w4a8tl_stream::Warps<BM, kThreads>::WN;
  static constexpr int WTM = BM / WM;           // warp tile
  static constexpr int WTN = BN / WN;
  static constexpr int MT = WTM / 16;           // m16 tiles a warp
  static constexpr int NT = WTN / 8;            // n8 tiles a warp
  using Acc = float[MT][NT][4];
  static constexpr int kChunks = BN / 16;       // chunks per packed row
  static constexpr int kABytes = BM * kLine;    // x lines
  static constexpr int kPBytes = kKP * BN;      // packed weight tile
  static constexpr int kScBytes = kF32 ? 4 : 2;
  static constexpr int kScRow = BN * kScBytes;  // one scale row
  // scale lo, scale hi, zero lo, zero hi
  static constexpr int kStageBytes = kABytes + kPBytes + 2 * kScRow + 2 * BN;
  static constexpr int kBBytes = BN * kLine;    // w lines, per buffer
  static constexpr int kSmemBytes = 2 * kBBytes + S * kStageBytes;
  // Dequant units: R packed rows x 4 columns, one a thread; threads past
  // kUnits (half of them at BN 64) idle in the dequant.
  static constexpr int R = 8;
  static constexpr int kRowBlocks = kKP / R;
  static constexpr int kUnits = kRowBlocks * BN / 4;
  static_assert(BM * 16 % kThreads == 0 && kPBytes / 16 % kThreads == 0,
                "whole copy rounds");
  static_assert(2 * kScRow / 16 + 2 * kChunks <= kThreads,
                "one round of scale copies");

  // This thread's 4 columns' bf16(128 + z) and bf16 scale, each in both
  // 16-bit halves, per nibble half.
  struct Scales {
    uint32_t z[2][4];
    uint32_t s[2][4];
  };

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // The XOR of a packed-tile chunk index in rows R * rb .. + R - 1: the
  // row blocks of one warp's dequant loads land in distinct chunks.
  static __device__ __forceinline__ int swz(int rb) {
    return (rb * (R / 8)) & (kChunks - 1);
  }

  // Whether step s (global index) of a split starting at s_begin stages
  // its group's scale and zero rows.
  static __device__ __forceinline__ bool stages_scales(int s, int s_begin) {
    return s == s_begin || s % kStepsPerGroup == 0;
  }

  // Start step s's copies into stage `st`: line i holds row m0 + i of x,
  // zero outside [row_lo, row_hi).
  static __device__ __forceinline__ void load(
      uint8_t* st, int s, bool scales, const __nv_bfloat16* __restrict__ x,
      const uint8_t* __restrict__ qw, const void* __restrict__ sc,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K) {
    const int tid = threadIdx.x;
    const int K2 = K / 2;
    const int r0 = s * kKP;
    const uint32_t a_s = smem_u32(st);
    // x: BM lines of 16 chunks; chunks 0-7 the low half's 64 k, 8-15 the
    // high half's.
#pragma unroll
    for (int i = 0; i < BM * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 4;
      const int c = idx & 15;
      const int m = m0 + row;
      const bool ok = m >= row_lo && m < row_hi;
      const __nv_bfloat16* src =
          ok ? x + (size_t)m * K + (c < 8 ? r0 : K2 + r0 - 64) + c * 8 : x;
      cp_async16(a_s + row * kLine + c * 16, src, ok ? 16 : 0);
    }
    // Packed weight: 64 rows of BN bytes, chunk c of row r at
    // c ^ swz(r / R).
    const uint32_t p_s = a_s + kABytes;
#pragma unroll
    for (int i = 0; i < kPBytes / 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kChunks;
      const int c = idx % kChunks;
      cp_async16(p_s + row * BN + ((c ^ swz(row / R)) << 4),
                 qw + (size_t)(r0 + row) * N + n0 + c * 16, 16);
    }
    // Scale rows (glo, ghi), then zero rows (glo, ghi).
    constexpr int kScChunks = kScRow / 16;
    if (scales && tid < 2 * kScChunks + 2 * kChunks) {
      const int glo = r0 / kGroup;
      const int ghi = K2 / kGroup + glo;
      const uint32_t sc_s = p_s + kPBytes;
      if (tid < 2 * kScChunks) {
        const int h = tid / kScChunks;
        const int c = tid % kScChunks;
        const char* src = static_cast<const char*>(sc)
                          + ((size_t)(h ? ghi : glo) * N + n0) * kScBytes
                          + c * 16;
        cp_async16(sc_s + h * kScRow + c * 16, src, 16);
      } else {
        const int j = tid - 2 * kScChunks;
        const int h = j / kChunks;
        const int c = j % kChunks;
        cp_async16(sc_s + 2 * kScRow + h * BN + c * 16,
                   zr + (size_t)(h ? ghi : glo) * N + n0 + c * 16, 16);
      }
    }
  }

  // The scales of this thread's columns 4 * (tid / kRowBlocks) .. + 3
  // from the staged rows of stage `st`.
  static __device__ __forceinline__ void load_group(const uint8_t* st,
                                                    Scales& sc) {
    if (kUnits < kThreads && threadIdx.x >= kUnits) return;
    const int cu = threadIdx.x / kRowBlocks;
    const uint8_t* sc_s = st + kABytes + kPBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t zw = *reinterpret_cast<const uint32_t*>(
          sc_s + 2 * kScRow + h * BN + cu * 4);
      float s[4];
      if constexpr (kF32) {
        const float4 f = *reinterpret_cast<const float4*>(
            sc_s + h * kScRow + cu * 16);
        s[0] = f.x, s[1] = f.y, s[2] = f.z, s[3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc.z[h][j] = bf16_pair((float)(128 + (int)(int8_t)(zw >> (8 * j))));
        if constexpr (kF32) {
          sc.s[h][j] = bf16_pair(s[j]);
        } else {
          const uint32_t b = reinterpret_cast<const uint16_t*>(
              sc_s + h * kScRow)[cu * 4 + j];
          sc.s[h][j] = b * 0x00010001u;
        }
      }
    }
  }

  // Dequantize the packed tile of stage `st` into the w lines `b_s`:
  // thread u < kUnits takes packed rows R * rb .. + R - 1 (rb = u %
  // kRowBlocks) of columns 4 * cu .. + 3 (cu = u / kRowBlocks) and writes
  // per column n and half the R rows' bf16 (16 bytes) at byte 2 * R * rb
  // of the half's 128 in line n.
  static __device__ __forceinline__ void dequant(const uint8_t* st,
                                                 uint8_t* b_s,
                                                 const Scales& sc) {
    const int tid = threadIdx.x;
    if (kUnits < kThreads && tid >= kUnits) return;
    const int rb = tid % kRowBlocks;
    const int cu = tid / kRowBlocks;
    const uint8_t* p_s = st + kABytes + (((cu >> 2) ^ swz(rb)) << 4)
                         + ((cu & 3) << 2);
    const int r = R * rb;
    uint32_t lo[4][R / 2], hi[4][R / 2];     // [column][k pair]
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(p_s + (r + 2 * i) * BN);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(p_s + (r + 2 * i + 1) * BN);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte 0: column j of row r + 2i; byte 2: of row r + 2i + 1.
        const uint32_t t = __byte_perm(w0, w1, 0x4400 + 0x1111 * j);
        lo[j][i] = dequant2<0>(t, sc.z[0][j], sc.s[0][j]);
        hi[j][i] = dequant2<4>(t, sc.z[1][j], sc.s[1][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* line = b_s + (4 * cu + j) * kLine + 2 * r;
      *reinterpret_cast<uint4*>(line) =
          make_uint4(lo[j][0], lo[j][1], lo[j][2], lo[j][3]);
      *reinterpret_cast<uint4*>(line + 2 * kKP) =
          make_uint4(hi[j][0], hi[j][1], hi[j][2], hi[j][3]);
    }
  }

  // acc += the step's x lines `a_s` . w lines `b_s` over its 128 k: warp
  // (wm, wn) owns rows wm * WTM .. and columns wn * WTN ..
  static __device__ __forceinline__ void mma(Acc& acc, const uint8_t* a_s,
                                             const uint8_t* b_s) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;              // mma groupID
    const int t = lane & 3;               // mma threadID_in_group
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int kc = 0; kc < 2 * kKP / 16; ++kc) {
      const int k0 = kc * 32 + t * 4;     // bytes: k = 16 kc + 2t
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* ra = a_s + (wm * WTM + i * 16 + g) * kLine + k0;
        a[i][0] = *reinterpret_cast<const uint32_t*>(ra);
        a[i][1] = *reinterpret_cast<const uint32_t*>(ra + 8 * kLine);
        a[i][2] = *reinterpret_cast<const uint32_t*>(ra + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(ra + 8 * kLine + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* cb = b_s + (wn * WTN + j * 8 + g) * kLine + k0;
        b[j][0] = *reinterpret_cast<const uint32_t*>(cb);
        b[j][1] = *reinterpret_cast<const uint32_t*>(cb + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }

  // f(row, col, v0, v1) for each pair of adjacent accumulators of the
  // tile (columns col, col + 1 of tile row `row`).
  template <class F>
  static __device__ __forceinline__ void for_each_pair(const Acc& acc,
                                                       F&& f) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          f(wm * WTM + i * 16 + (lane >> 2) + 4 * e,
            wn * WTN + j * 8 + 2 * (lane & 3), acc[i][j][e], acc[i][j][e + 1]);
  }

  static __device__ __forceinline__ void store_pair(__nv_bfloat16* out,
                                                    size_t idx, float v0,
                                                    float v1) {
    *reinterpret_cast<__nv_bfloat162*>(out + idx) =
        __floats2bfloat162_rn(v0, v1);
  }

  // The epilogue of split blockIdx.z of gridDim.z, column tile n0, tile
  // rows m0 ..: one split, the rows in [row_lo, row_hi) straight to out;
  // else (dense: m0 = row_lo = 0, row_hi = M) through part [gridDim.z, M,
  // N] and counters[blockIdx.x] (zero on entry, zero again on return).
  static __device__ __forceinline__ void finish(
      const Acc& acc, __nv_bfloat16* __restrict__ out,
      float* __restrict__ part, int* __restrict__ counters, int n0, int m0,
      int row_lo, int row_hi, int N) {
    if (gridDim.z == 1) {
      for_each_pair(acc, [&](int row, int col, float v0, float v1) {
        const int r = m0 + row;
        if (r >= row_lo && r < row_hi) {
          store_pair(out, (size_t)r * N + n0 + col, v0, v1);
        }
      });
      return;
    }
    const size_t plane = (size_t)row_hi * N;
    float* mine = part + blockIdx.z * plane + n0;
    for_each_pair(acc, [&](int row, int col, float v0, float v1) {
      if (row < row_hi) {
        *reinterpret_cast<float2*>(mine + (size_t)row * N + col) =
            make_float2(v0, v1);
      }
    });
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.z - 1;
      if (last) counters[blockIdx.x] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for_each_pair(acc, [&](int row, int col, float, float) {
      if (row >= row_hi) return;
      const float* src = part + n0 + (size_t)row * N + col;
      float s0 = 0.f, s1 = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(src + z * plane));
        s0 += v.x;
        s1 += v.y;
      }
      store_pair(out, (size_t)row * N + n0 + col, s0, s1);
    });
  }

  // acc += x[rows m0 .., window [row_lo, row_hi)] . w[:, n0 .. n0 + BN)
  // over K steps [s_begin, s_end). x is row-major bf16 [*, K]; qw/sc/zr
  // one weight ([K/2, N], [K/128, N] x2). `smem` is the block's dynamic
  // shared memory (16-byte aligned, kSmemBytes).
  static __device__ __forceinline__ void run(
      Acc& acc, uint8_t* smem, const __nv_bfloat16* __restrict__ x,
      const uint8_t* __restrict__ qw, const void* __restrict__ sc,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K, int s_begin, int s_end) {
    uint8_t* const wl[2] = {smem, smem + kBBytes};
    uint8_t* const ring = smem + 2 * kBBytes;
    const int n = s_end - s_begin;
    auto stage = [&](int j) { return ring + (j % S) * kStageBytes; };
    auto fetch = [&](int j) {
      const int s = s_begin + j;
      if (j < n) {
        load(stage(j), s, stages_scales(s, s_begin), x, qw, sc, zr, m0,
             row_lo, row_hi, n0, N, K);
      }
      cp_async_commit();
    };

#pragma unroll
    for (int j = 0; j < S - 1; ++j) fetch(j);
    Scales scl;                   // of the step the dequant takes (j + 1)
    cp_async_wait<S - 2>();       // step 0's copies (this thread's)
    __syncthreads();
    load_group(stage(0), scl);
    dequant(stage(0), wl[0], scl);

    for (int j = 0; j + 1 < n; ++j) {
      cp_async_wait<S - 3>();     // step j+1's copies
      __syncthreads();            // ... everyone's; w of step j written;
                                  // step j-1's reads done
      fetch(j + S - 1);           // into step j-1's slot
      // One basic block, the mma's shared loads first: the dequant's
      // loads and arithmetic fill the mma's latencies.
      if (stages_scales(s_begin + j + 1, s_begin)) {
        load_group(stage(j + 1), scl);
      }
      mma(acc, stage(j), wl[j & 1]);
      dequant(stage(j + 1), wl[(j + 1) & 1], scl);
    }
    __syncthreads();              // the last step's w written
    mma(acc, stage(n - 1), wl[(n - 1) & 1]);
    cp_async_wait<0>();
  }
};

// Dense: one BM x BN tile of K split blockIdx.z (steps [z * per, (z+1) *
// per)), grid (N / BN, 1, splits); more than one split sums through
// part / counters (Stream::finish).
template <int BM, int BN, int S, bool kF32>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ qw, const void* __restrict__ sc,
             const int8_t* __restrict__ zr, __nv_bfloat16* __restrict__ out,
             float* __restrict__ part, int* __restrict__ counters, int M,
             int N, int K, int per) {
  using L = Stream<BM, BN, S, kF32>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * BN;
  const int nsteps = (K / 2) / kKP;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(nsteps, s_begin + per);
  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, smem, x, qw, sc, zr, 0, 0, M, n0, N, K, s_begin, s_end);
  L::finish(acc, out, part, counters, n0, 0, 0, M, N);
}

// Grouped: logical tile blockIdx.y of the tile map (16-row m-tiles),
// columns blockIdx.x * BN .., only the rows of the tile's expert, on the
// expert's weight, over the full K.
template <int BN, int S, bool kF32>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ qw, const void* __restrict__ sc,
               const int8_t* __restrict__ zr, const int* __restrict__ gid,
               const int* __restrict__ mtid, const int* __restrict__ offsets,
               const int* __restrict__ valid, __nv_bfloat16* __restrict__ out,
               int N, int K) {
  constexpr int BM = 16;
  using L = Stream<BM, BN, S, kF32>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int i = blockIdx.y;                  // logical tile
  if (!valid[i]) return;
  const int g = gid[i];
  const int m0 = mtid[i] * BM;
  const int row_lo = max(offsets[g], m0);
  const int row_hi = min(offsets[g + 1], m0 + BM);
  if (row_lo >= row_hi) return;
  const int n0 = blockIdx.x * BN;
  const size_t wstride = (size_t)(K / 2) * N;
  const size_t gstride = (size_t)(K / kGroup) * N;
  const char* sc_g = static_cast<const char*>(sc)
                     + g * gstride * (kF32 ? 4 : 2);
  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, smem, x, qw + g * wstride, sc_g, zr + g * gstride, m0, row_lo,
         row_hi, n0, N, K, 0, (K / 2) / kKP);
  L::finish(acc, out, nullptr, nullptr, n0, m0, row_lo, row_hi, N);
}

// ---------------------------------------------------------------------------
// The launcher (decode_any<kGrouped>), with internal linkage: each library
// that includes it (and each rebuilt copy of one) keeps its own
// once-per-device state -- function-local statics of an external template
// are one object process-wide (STB_GNU_UNIQUE), across dlopen'ed copies.
// ---------------------------------------------------------------------------

namespace {

// The ring's depth by the tile's rows: 3 stages at BM 64, where a
// second block then fits an SM; 4 elsewhere.
template <int BM>
constexpr int kStreamStages = BM == 64 ? 3 : 4;
// Packed weights (one expert's, where grouped) of at most this many bytes
// take 64-column tiles.
constexpr long kStreamNarrowBytes = 16L << 20;

// The arguments of a launch. Dense: M rows, part / counters the split-K
// scratch. Grouped: M the logical tiles of the tile map gid / mtid /
// offsets / valid. plan: when not null, the launch is not made and
// plan[0..6] get BM, BN, threads, stages, splits, K steps per split and
// resident blocks per SM.
struct Args {
  const void *x, *qw, *sc, *z;
  const int *gid, *mtid, *offsets, *valid;
  void* out;
  float* part;
  int* counters;
  int M, N, K, splits, scales_f32;
  cudaStream_t st;
  int* plan;
};

template <bool kGrouped, bool kF32, int BM, int BN>
int launch(const Args& a) {
  constexpr int S = kStreamStages<BM>;
  using L = Stream<BM, BN, S, kF32>;
  const void* kernel;
  if constexpr (kGrouped) {
    kernel = (const void*)grouped_kernel<BN, S, kF32>;
  } else {
    kernel = (const void*)dense_kernel<BM, BN, S, kF32>;
  }
  // The shared-memory limit is raised once per device (the launch is on
  // every decode projection's path; the host holds the serve loop).
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit);
  }
  static const int per_sm = [&] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads,
                                                  L::kSmemBytes);
    return b > 0 ? b : 1;
  }();
  const int nsteps = (a.K / 2) / kKP;
  int splits = 1, per = nsteps;
  if constexpr (!kGrouped) {
    splits = a.splits > 0 ? min(a.splits, nsteps)
        : w4a8tl_stream::decode_splits(a.M, BN, a.N / BN, nsteps,
                                       w4a16_wgmma::num_sms() * per_sm);
    per = (nsteps + splits - 1) / splits;
    splits = (nsteps + per - 1) / per;      // every split gets steps
  }
  if (a.plan) {
    const int plan[7] = {BM, BN, kThreads, S, splits, per, per_sm};
    for (int i = 0; i < 7; ++i) a.plan[i] = plan[i];
    return (int)cudaSuccess;
  }
  const auto* x = static_cast<const __nv_bfloat16*>(a.x);
  const auto* qw = static_cast<const uint8_t*>(a.qw);
  const auto* z = static_cast<const int8_t*>(a.z);
  auto* out = static_cast<__nv_bfloat16*>(a.out);
  if constexpr (kGrouped) {
    grouped_kernel<BN, S, kF32>
        <<<dim3(a.N / BN, a.M), kThreads, L::kSmemBytes, a.st>>>(
            x, qw, a.sc, z, a.gid, a.mtid, a.offsets, a.valid, out, a.N,
            a.K);
  } else {
    if (splits > 1 && (!a.part || !a.counters)) {
      return (int)cudaErrorInvalidValue;
    }
    dense_kernel<BM, BN, S, kF32>
        <<<dim3(a.N / BN, 1, splits), kThreads, L::kSmemBytes, a.st>>>(
            x, qw, a.sc, z, out, a.part, a.counters, a.M, a.N, a.K, per);
  }
  return (int)cudaGetLastError();
}

template <bool kGrouped, bool kF32, int BN>
int launch_bm(const Args& a) {
  if constexpr (kGrouped) {
    return launch<true, kF32, 16, BN>(a);
  } else {
    return a.M <= 16 ? launch<false, kF32, 16, BN>(a)
         : a.M <= 32 ? launch<false, kF32, 32, BN>(a)
                     : launch<false, kF32, 64, BN>(a);
  }
}

template <bool kGrouped, bool kF32>
int launch_bn(const Args& a) {
  // 64 columns where N % 128 != 0, or where the packed weight is small:
  // there the fixed costs of a launch and a split dominate, and twice the
  // column tiles at about half the shared memory fill the SMs with fewer
  // K splits.
  const bool stream_narrow =
      a.N % 128 != 0 || (long)a.K / 2 * a.N <= kStreamNarrowBytes;
  return stream_narrow ? launch_bm<kGrouped, kF32, 64>(a)
                       : launch_bm<kGrouped, kF32, 128>(a);
}

// A launch (or its plan). Dense (kGrouped false): all M rows (BM = 16 /
// 32 / 64) x BN columns, 64 packed rows (128 k) a K step, K split across
// blockIdx.z into a.splits parts (0: the count decode_splits picks; at
// most one split per K step); requires 1 <= M <= 64. Grouped: BM = 16,
// grid (N / BN, a.M logical tiles), the full K. Both require K % 256 ==
// 0, N % 64 == 0, and x, qweight, scales and zeros 16-byte aligned.
template <bool kGrouped>
int decode_any(const Args& a) {
  if (a.M < 1 || (!kGrouped && a.M > 64) || a.K % 256 || a.N % 64) {
    return (int)cudaErrorInvalidValue;
  }
  return a.scales_f32 ? launch_bn<kGrouped, true>(a)
                      : launch_bn<kGrouped, false>(a);
}

}  // namespace

}  // namespace w4a16_stream
