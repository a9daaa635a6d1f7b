// The two-level w4a8 decode GEMMs' main loop on Hopper (sm_90a): one
// block's int32 tile of  acc[m, n] = sum_k xq[m, k] * w8[k, n],
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128,
// over the K steps of one split, for m <= 64, and the launcher that plans
// the tiles, threads and K splits. Two forms of the same function, and a
// third form of the loop for the float-scale GEMM (`FloatScale`, below:
// its own function, f32 sums in the TPU kernel's order):
//  - kGD false, the w8 form: w4a8tl_gemm.cu's ferrum_w4a8tl_decode
//    (replaces ferrum_tpu/ops/pallas/quant_matmul.py:601
//    _qmm_w4a8tl_mxu_kernel). The packed tile is dequantized to w8.
//    moe_gemm.cu runs this form's Stream::run and finish<false> once per
//    (column tile, expert), each with its own launcher: the all-experts
//    bmm (replaces quant_matmul.py:1290 _qbmm_w4a8tl_mxu_kernel), and
//    the grouped GEMM at decode sizes (replaces :1098
//    _qgmm_w4a8tl_kernel there), over its expert's rows in chunks, with
//    finish's chan-first epilogue.
//  - kGD true, the group-dot form: w4a8tl_gd.cu's ferrum_w4a8tl_gd_decode
//    (replaces quant_matmul.py:543 _qmm_w4a8tl_gd_kernel). The raw
//    nibbles q go into the mma, and each half step's dot is rescaled on
//    the output side:  acc += s2 * (xq . q) - (sum_k xq) * (s2 * z).
// q is packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of qweight
// [K/2, N] holds row r in its low nibble and row K/2 + r in its high
// nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31 for
// K <= 14336: the int32 sums are exact, in any order. The group-dot
// rescale runs in unsigned 32-bit arithmetic (mma.sync has no
// .satfinite), so it is modular and its sum is the same integer.
//
// At decode m the packed weight is streamed once for ~2m int8 ops a byte,
// so the loop has to keep HBM busy: enough bytes in flight per SM and the
// per-byte work (the dequant, or the unpack) off the copies' path. Built
// from parts of the prefill loop (w4a8tl_wgmma.cuh: cp.async, dequant4)
// and the accumulator layout of w4a8tl_tile.cuh:
//  - 256 threads (8 warps, 2 x 4 over the tile, 1 x 8 where BM = 16) or
//    128 (1 x 4), as the launcher picks; BM = 16 / 32 / 64 rows (all of
//    m: grid y is 1), BN = 64 or 128 columns.
//  - A K step is kKP = 64 packed rows: 64 low-nibble rows (k = r0 + i) and
//    the 64 matching high-nibble rows (k = K/2 + r0 + i), 128 k-values.
//    The sums are integers, so the k order inside a step is free: one line
//    per row of xq holds [xq low 64 | xq high 64] and one per column of w8
//    [w8 low 64 | w8 high 64], each padded to kLine = 144 bytes (36 words:
//    the 8 lines a fragment load touches start 4 banks apart, so the
//    mma.sync fragment loads and the dequant's 16-byte stores are free of
//    bank conflicts).
//  - A ring of S stages, filled by 16-byte cp.async, holds per step the
//    xq lines (rows >= M zero-filled), the packed weight tile ([64, BN]
//    bytes as it lies in global memory, 16-byte chunk c of row r at
//    c ^ (r / 8) mod BN/16 (r / 16 * 2 at 128 threads), so the dequant's
//    loads are free of bank conflicts at BN 128) and, on the split's
//    first step and each step that starts a group, the group's scales2
//    and zero rows of both halves. Loads past the split's last step are
//    skipped and their commit groups left empty (short K: one or two
//    steps a split).
//  - Dequant (w4a8tl_wgmma.cuh's, into padded lines): each thread takes
//    R = 8 packed rows (16 at 128 threads) x 4 columns: four 32-bit loads
//    per 4 rows, a 4 x 4 byte transpose by __byte_perm, then per column
//    and nibble half q * s + (-z * s mod 256) in two 16-bit lanes
//    (dequant4), one R-byte store per column and half. The group-dot
//    form's unpack takes the same units, loads and transpose and stores
//    the raw nibbles, t & 0x0F0F0F0F and (t >> 4) & 0x0F0F0F0F.
//  - mma.sync m16n8k32 s8 x s8 -> s32 on the xq lines (A) and the w8
//    lines (B) in w4a8tl::Tile's accumulator layout. The
//    group-dot form runs each half (two of the four 32-k chunks) into a
//    `dot` fragment of its own, and rescales modulo 2^32: acc += dot * s2
//    -- every step (the first chunk's mma with a zero accumulator), or,
//    at BN 128, once a group on dots kept over its steps (the shared
//    memory already holds an SM to 2 such blocks, so the registers are
//    free) -- and acc -= sx * (s2 * z) once a group. s2 and s2 * z of
//    the fragment's columns sit in registers (read on the step that
//    staged them: a group's first step, or the split's); each lane's part
//    of sx = sum_k xq of the fragment's rows comes from the A fragments
//    already in registers (dp4a) and is summed over the mma group's 4
//    lanes by two shuffles once a group: no shared array, no extra
//    barrier. The multiply-adds bind (64 a clock an SM): at m = 32 this
//    way takes ~9% of the layer, against ~14% when every rescale runs
//    every step (tools/torch_w4a8tl_ab.py's gd_* probes).
//  - Step j, one barrier: wait for step j+1's copies; barrier (step j's
//    w8 written, step j-1's reads done); start step j+S-1's copies into
//    step j-1's slot; mma on step j and, in the same basic block so the
//    two interleave, dequantize (unpack) step j+1 into the w8 buffer
//    step j-1 read. Copies, dequant and mma overlap.
//  - Split-K epilogue (`finish`): each split stores its int32 partial
//    sums of the tile's rows below M, as they lie in the mma fragments
//    (8-byte stores), into its own plane of part [splits, M, N]; the
//    tile's last arrival (counted in counters, which it leaves zeroed)
//    sums the planes and writes f32(acc) * xs[m] * chan[n] -- integer
//    sums, so exact in any order. Plain stores and loads: integer atomics
//    into one [M, N] plane cost ~8 us per million on the H100, a third
//    of a small projection's time. One split: the block writes the
//    output straight from its fragments.
//  - The launcher (`decode_any`): BN 64 where N % 128 != 0 or the packed
//    weight is small, else 128; 128 threads where the column tiles alone
//    fill the SMs, else 256; K splits so the blocks fill the resident
//    slots in whole waves. Each form keeps its own shared-memory
//    attribute and occupancy (their registers differ).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "w4a8tl_tile.cuh"    // accumulator layout, mma_s8
#include "w4a8tl_wgmma.cuh"   // cp.async, dequant4

namespace w4a8tl_stream {

using w4a8tl_wgmma::cp_async16;
using w4a8tl_wgmma::cp_async_commit;
using w4a8tl_wgmma::cp_async_wait;
using w4a8tl_wgmma::dequant4;
using w4a8tl_wgmma::smem_u32;

constexpr int kGroup = 128;
constexpr int kKP = 64;               // packed rows per K step (128 k)
constexpr int kStepsPerGroup = kGroup / kKP;
constexpr int kLine = 2 * kKP + 16;   // one padded K-major line, bytes
// The group-dot form's rule: the dot of both halves is kept over a
// group's steps and rescaled once a group where BN is at least this (and
// the extra accumulators fit), else rescaled every step.
constexpr int kGdPerGroupMinBN = 128;

// The block's kThreads / 32 warps over the BM x BN tile: 1 x 4 at 128
// threads; 2 x 4 at 256, or 1 x 8 where BM = 16.
template <int BM, int kThreads>
struct Warps {
  static constexpr int WM = kThreads == 256 && BM >= 32 ? 2 : 1;
  static constexpr int WN = kThreads / 32 / WM;
};

// kGD: the group-dot form (raw nibbles into the mma, the scales on the
// output side); else the w8 form.
template <int BM, int BN, int S, int kThreads, bool kGD>
struct Stream {
  static_assert(BM == 16 || BM == 32 || BM == 64, "BM is 16, 32 or 64");
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(kThreads == 128 || kThreads == 256, "128 or 256 threads");
  static_assert(S >= 3, "the ring holds the step the mma reads, the step "
                        "dequantized and at least one in flight");
  static constexpr int WM = Warps<BM, kThreads>::WM;
  static constexpr int WN = Warps<BM, kThreads>::WN;
  // The accumulator layout of the shared tile.
  using T = w4a8tl::Tile<BM, BN, kKP, WM, WN>;
  using Acc = typename T::Acc;
  static constexpr int WTM = BM / WM;           // warp tile
  static constexpr int WTN = BN / WN;
  static constexpr int MT = WTM / 16;           // m16 tiles a warp
  static constexpr int NT = WTN / 8;            // n8 tiles a warp
  static constexpr int kChunks = BN / 16;       // chunks per packed row
  static constexpr int kABytes = BM * kLine;    // xq lines
  static constexpr int kPBytes = kKP * BN;      // packed weight tile
  static constexpr int kScBytes = 4 * BN;       // s2 lo, s2 hi, z lo, z hi
  static constexpr int kStageBytes = kABytes + kPBytes + kScBytes;
  static constexpr int kBBytes = BN * kLine;    // w8 lines, per buffer
  static constexpr int kSmemBytes = 2 * kBBytes + S * kStageBytes;
  // The group-dot dot rescaled once a group (see kGdPerGroupMinBN).
  static constexpr bool kPerGroup =
      kGD && BN >= kGdPerGroupMinBN && MT * NT <= 8;
  // Dequant units: R packed rows x 4 columns, one a thread (R = 16 at
  // 128 threads, 8 at 256); threads past kUnits idle in the dequant.
  static constexpr int R = kThreads == 256 ? 8 : 16;
  static constexpr int kRowBlocks = kKP / R;
  static constexpr int kUnits = kRowBlocks * BN / 4;

  // This thread's 4 columns' scales2 (as unsigned bytes) and -z * s2 mod
  // 256 (in both 16-bit fields), both halves.
  struct Scales {
    uint32_t s[2][4];
    uint32_t c[2][4];
  };

  // The group-dot form's scales at this lane's accumulator columns
  // wn * WTN + j * 8 + 2t + e, both halves: scales2 and scales2 * zeros.
  struct ColScales {
    uint32_t s2[2][NT][2];
    uint32_t s2z[2][NT][2];
  };

  // The XOR of a packed-tile chunk index in rows R * rb .. + R - 1: the
  // row blocks of one warp's dequant loads land in distinct chunks.
  static __device__ __forceinline__ int swz(int rb) {
    return (rb * (R / 8)) & (kChunks - 1);
  }

  // Whether step s (global index) of a split starting at s_begin stages
  // its group's scales2 and zero rows.
  static __device__ __forceinline__ bool stages_scales(int s, int s_begin) {
    return s == s_begin || s % kStepsPerGroup == 0;
  }

  // Start step s's copies into stage `st`.
  static __device__ __forceinline__ void load(
      uint8_t* st, int s, bool scales, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int M, int n0, int N, int K) {
    const int tid = threadIdx.x;
    const int K2 = K / 2;
    const int r0 = s * kKP;
    const uint32_t a_s = smem_u32(st);
    // xq: BM lines of 8 chunks; chunks 0-3 the low half's 64 k, 4-7 the
    // high half's.
    constexpr int kAChunks = BM * 8;
#pragma unroll
    for (int i = 0; i < (kAChunks + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (kAChunks % kThreads != 0 && idx >= kAChunks) break;
      const int row = idx >> 3;
      const int c = idx & 7;
      const bool ok = row < M;
      const int8_t* src =
          ok ? xq + (size_t)row * K + (c < 4 ? r0 : K2 + r0 - 64) + c * 16
             : xq;
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
    // scales2 rows (glo, ghi), then zero rows (glo, ghi).
    if (scales && tid < 4 * kChunks) {
      const int glo = r0 / kGroup;
      const int ghi = K2 / kGroup + glo;
      const int h = tid / kChunks;
      const int c = tid % kChunks;
      const int8_t* src = (h < 2 ? s2 : zr)
                          + (size_t)((h & 1) ? ghi : glo) * N + n0 + c * 16;
      cp_async16(p_s + kPBytes + h * BN + c * 16, src, 16);
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
      const uint32_t sw =
          *reinterpret_cast<const uint32_t*>(sc_s + h * BN + cu * 4);
      const uint32_t zw =
          *reinterpret_cast<const uint32_t*>(sc_s + (2 + h) * BN + cu * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = (int)(int8_t)(sw >> (8 * j));
        const int z = (int)(int8_t)(zw >> (8 * j));
        sc.s[h][j] = (uint32_t)s & 0xFFu;
        sc.c[h][j] = ((uint32_t)(-z * s) & 0xFFu) * 0x00010001u;
      }
    }
  }

  // The columns' scales of the group-dot rescale from the staged rows of
  // stage `st` (the lane's columns: see ColScales).
  static __device__ __forceinline__ void load_cols(const uint8_t* st,
                                                   ColScales& cs) {
    const int wn = (threadIdx.x >> 5) % WN;
    const int t = threadIdx.x & 3;
    const uint8_t* sc_s = st + kABytes + kPBytes + wn * WTN + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t sw =
            *reinterpret_cast<const uint16_t*>(sc_s + h * BN + j * 8);
        const uint32_t zw =
            *reinterpret_cast<const uint16_t*>(sc_s + (2 + h) * BN + j * 8);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s2 = (int)(int8_t)(sw >> (8 * e));
          const int z = (int)(int8_t)(zw >> (8 * e));
          cs.s2[h][j][e] = (uint32_t)s2;
          cs.s2z[h][j][e] = (uint32_t)(s2 * z);
        }
      }
    }
  }

  // The packed tile of stage `st` into the lines `b_s`: thread u <
  // kUnits takes packed rows R * rb .. + R - 1 (rb = u % kRowBlocks) of
  // columns 4 * cu .. + 3 (cu = u / kRowBlocks), 4 x 4 byte transposes
  // t[j] (byte i: packed row r + i of column j), and writes per column n,
  // bytes R * rb .. + R - 1 (low half) and 64 + R * rb .. (high half) of
  // line n: f(t[j], j, lo, hi) gives the low and high half's 4 bytes.
  template <class F>
  static __device__ __forceinline__ void convert(const uint8_t* st,
                                                 uint8_t* b_s, F&& f) {
    const int tid = threadIdx.x;
    if (kUnits < kThreads && tid >= kUnits) return;
    const int rb = tid % kRowBlocks;
    const int cu = tid / kRowBlocks;
    const uint8_t* p_s = st + kABytes + (((cu >> 2) ^ swz(rb)) << 4)
                         + ((cu & 3) << 2);
    constexpr int Q = R / 4;          // k quads a unit
    uint32_t lo[4][Q], hi[4][Q];      // [column][k quad]
#pragma unroll
    for (int i4 = 0; i4 < Q; ++i4) {
      const int r = R * rb + 4 * i4;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(p_s + (r + i) * BN);
      }
      // 4 x 4 byte transpose: t[j] byte i = w[i] byte j.
      const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t x2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t x3 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t t[4] = {__byte_perm(x0, x2, 0x5410),
                             __byte_perm(x0, x2, 0x7632),
                             __byte_perm(x1, x3, 0x5410),
                             __byte_perm(x1, x3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) f(t[j], j, lo[j][i4], hi[j][i4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* line = b_s + (4 * cu + j) * kLine + R * rb;
      if constexpr (Q == 4) {
        *reinterpret_cast<uint4*>(line) =
            make_uint4(lo[j][0], lo[j][1], lo[j][2], lo[j][3]);
        *reinterpret_cast<uint4*>(line + kKP) =
            make_uint4(hi[j][0], hi[j][1], hi[j][2], hi[j][3]);
      } else {
        *reinterpret_cast<uint2*>(line) = make_uint2(lo[j][0], lo[j][1]);
        *reinterpret_cast<uint2*>(line + kKP) =
            make_uint2(hi[j][0], hi[j][1]);
      }
    }
  }

  // Dequantize the packed tile of stage `st` into the w8 lines `b_s`
  // (the thread's columns' scales `sc`, load_group's).
  static __device__ __forceinline__ void dequant(const uint8_t* st,
                                                 uint8_t* b_s,
                                                 const Scales& sc) {
    convert(st, b_s, [&](uint32_t t, int j, uint32_t& lo, uint32_t& hi) {
      lo = dequant4<0>(t, sc.s[0][j], sc.c[0][j]);
      hi = dequant4<4>(t, sc.s[1][j], sc.c[1][j]);
    });
  }

  // The group-dot form's unpack: the raw nibbles 0..15 of the packed tile
  // of stage `st` into the lines `b_s`.
  static __device__ __forceinline__ void unpack(const uint8_t* st,
                                                uint8_t* b_s) {
    convert(st, b_s, [](uint32_t t, int, uint32_t& lo, uint32_t& hi) {
      lo = t & 0x0F0F0F0Fu;
      hi = (t >> 4) & 0x0F0F0F0Fu;
    });
  }

  // This lane's A fragments (a[i]: m16 tile i) and B fragments (b[j]: n8
  // tile j) of 32-k chunk kc of the step's lines `a_s`, `b_s`.
  static __device__ __forceinline__ void fragments(
      const uint8_t* a_s, const uint8_t* b_s, int kc, uint32_t (&a)[MT][4],
      uint32_t (&b)[NT][2]) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;              // mma groupID
    const int t = lane & 3;               // mma threadID_in_group
    const int wm = warp / WN;
    const int wn = warp % WN;
    const int k0 = kc * 32 + t * 4;
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
  }

  // acc += the step's xq lines `a_s` . w8 lines `b_s` over its 128 k:
  // warp (wm, wn) owns rows wm * WTM .. and columns wn * WTN ..
  static __device__ __forceinline__ void mma(Acc& acc, const uint8_t* a_s,
                                             const uint8_t* b_s) {
#pragma unroll
    for (int kc = 0; kc < 2 * kKP / 32; ++kc) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
      fragments(a_s, b_s, kc, a, b);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) w4a8tl::mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // The group-dot form's dot of half h of a step (chunks kc = 2h, 2h + 1:
  // the low, or the high 64 k of the lines): dot += xq . q on the raw
  // nibbles `b_s` (kFresh: dot = on the first chunk), and sx += this
  // lane's part of sum_k xq of the C fragment's rows g and g + 8 (dp4a on
  // its A words).
  template <bool kFresh>
  static __device__ __forceinline__ void dot_half(Acc& dot, int (&sx)[MT][2],
                                                  const uint8_t* a_s,
                                                  const uint8_t* b_s, int h) {
#pragma unroll
    for (int kc = 2 * h; kc < 2 * h + 2; ++kc) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
      fragments(a_s, b_s, kc, a, b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // a[i][0], a[i][2]: row g; a[i][1], a[i][3]: row g + 8.
        sx[i][0] = __dp4a((int)a[i][0], 0x01010101, sx[i][0]);
        sx[i][0] = __dp4a((int)a[i][2], 0x01010101, sx[i][0]);
        sx[i][1] = __dp4a((int)a[i][1], 0x01010101, sx[i][1]);
        sx[i][1] = __dp4a((int)a[i][3], 0x01010101, sx[i][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (kFresh && kc == 2 * h) {
            mma_s8_fresh(dot[i][j], a[i], b[j]);
          } else {
            w4a8tl::mma_s8(dot[i][j], a[i], b[j]);
          }
        }
      }
    }
  }

  // c = a . b (mma.sync with a zero accumulator).
  static __device__ __forceinline__ void mma_s8_fresh(
      int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0));
  }

  // The group-dot rescale of half h, modulo 2^32 (all of it unsigned
  // 32-bit): scale_dot adds dot * s2, correct subtracts sx * (s2 * z)
  // with sx first summed over the mma group's 4 lanes (two xor shuffles)
  // and then zeroed; `cs` the group's column scales. Rows >= M are zero
  // lines: their sx is 0.
  static __device__ __forceinline__ void scale_dot(Acc& acc, const Acc& dot,
                                                   const ColScales& cs,
                                                   int h) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = (int)((uint32_t)acc[i][j][e]
                               + (uint32_t)dot[i][j][e] * cs.s2[h][j][e & 1]);
  }

  static __device__ __forceinline__ void correct(Acc& acc, int (&sx)[MT][2],
                                                 const ColScales& cs, int h) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sx[i][r] += __shfl_xor_sync(0xffffffffu, sx[i][r], 1);
        sx[i][r] += __shfl_xor_sync(0xffffffffu, sx[i][r], 2);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = (int)((uint32_t)acc[i][j][e]
                               - (uint32_t)sx[i][e >> 1] * cs.s2z[h][j][e & 1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) sx[i][0] = sx[i][1] = 0;
  }

  // f(row, col, v0, v1) for each pair of adjacent accumulators of the
  // tile (columns col, col + 1; Tile::for_each_elem's layout) in a row
  // below M.
  template <class F>
  static __device__ __forceinline__ void for_each_pair(const Acc& acc, int M,
                                                       F&& f) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = wm * WTM + i * 16 + (lane >> 2) + 4 * e;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          f(row, wn * WTN + j * 8 + 2 * (lane & 3), acc[i][j][e],
            acc[i][j][e + 1]);
        }
      }
    }
  }

  // out[row, n0 + col] = out_t(f32(v) * xs[row] * chan[n0 + col]), both
  // products rounded, then round-to-nearest-even for bf16; kChanFirst:
  // (f32(v) * chan) * xs, the grouped GEMM's order.
  template <bool kChanFirst = false>
  static __device__ __forceinline__ void store_pair(
      void* __restrict__ out, const float* __restrict__ xs,
      const float* __restrict__ chan, int N, int row, int col, int v0,
      int v1, int out_bf16) {
    const float sx = xs[row];
    float a, b;
    if constexpr (kChanFirst) {
      a = __fmul_rn(__fmul_rn(__int2float_rn(v0), chan[col]), sx);
      b = __fmul_rn(__fmul_rn(__int2float_rn(v1), chan[col + 1]), sx);
    } else {
      a = __fmul_rn(__fmul_rn(__int2float_rn(v0), sx), chan[col]);
      b = __fmul_rn(__fmul_rn(__int2float_rn(v1), sx), chan[col + 1]);
    }
    const size_t idx = (size_t)row * N + col;
    if (out_bf16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out)
                                         + idx) = __floats2bfloat162_rn(a, b);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
          make_float2(a, b);
    }
  }

  // The epilogue of split blockIdx.z of gridDim.z, column tile n0 (see
  // the header): kSplit false, one split, straight to out (kChanFirst:
  // store_pair's grouped order); else through part [gridDim.z, M, N] and
  // counters[blockIdx.x] (zero on entry, zero again on return).
  template <bool kSplit, bool kChanFirst = false>
  static __device__ __forceinline__ void finish(
      const Acc& acc, const float* __restrict__ xs,
      const float* __restrict__ chan, void* __restrict__ out,
      int* __restrict__ part, int* __restrict__ counters, int n0, int M,
      int N, int out_bf16) {
    if constexpr (!kSplit) {
      for_each_pair(acc, M, [&](int row, int col, int v0, int v1) {
        store_pair<kChanFirst>(out, xs, chan, N, row, n0 + col, v0, v1,
                               out_bf16);
      });
    } else {
      const size_t plane = (size_t)M * N;
      int* mine = part + blockIdx.z * plane + n0;
      for_each_pair(acc, M, [&](int row, int col, int v0, int v1) {
        *reinterpret_cast<int2*>(mine + (size_t)row * N + col) =
            make_int2(v0, v1);
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
      for_each_pair(acc, M, [&](int row, int col, int, int) {
        const int* src = part + n0 + (size_t)row * N + col;
        int s0 = 0, s1 = 0;
        for (int z = 0; z < (int)gridDim.z; ++z) {
          const int2 v =
              __ldcg(reinterpret_cast<const int2*>(src + z * plane));
          s0 += v.x;
          s1 += v.y;
        }
        store_pair(out, xs, chan, N, row, n0 + col, s0, s1, out_bf16);
      });
    }
  }

  // acc += xq[0 .. M) . w8[:, n0 .. n0 + BN) over K steps [s_begin,
  // s_end). xq is row-major int8 [M, K]; qw/s2/zr one weight ([K/2, N],
  // [K/128, N] x2). `smem` is the block's dynamic shared memory (16-byte
  // aligned, kSmemBytes).
  static __device__ __forceinline__ void run(
      Acc& acc, uint8_t* smem, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int M, int n0, int N, int K,
      int s_begin, int s_end) {
    uint8_t* const w8[2] = {smem, smem + kBBytes};  // or raw nibbles
    uint8_t* const ring = smem + 2 * kBBytes;
    const int n = s_end - s_begin;
    auto stage = [&](int j) { return ring + (j % S) * kStageBytes; };
    auto fetch = [&](int j) {
      const int s = s_begin + j;
      if (j < n) {
        load(stage(j), s, stages_scales(s, s_begin), xq, qw, s2, zr, M, n0,
             N, K);
      }
      cp_async_commit();
    };

#pragma unroll
    for (int j = 0; j < S - 1; ++j) fetch(j);
    // w8 form: the dequant's scales, of the step it dequantizes (j + 1).
    // Group-dot form: the rescale's, of the step it multiplies (j), read
    // on the step whose slot holds them (a group's first, or the split's)
    // and kept for the group's second step: that slot is refilled before.
    [[maybe_unused]] Scales sc;
    [[maybe_unused]] ColScales cs;
    // Group-dot: both halves' row sums, kept over a group, and dots
    // (kPerGroup: kept over a group).
    [[maybe_unused]] Acc dot[kPerGroup ? 2 : 1];
    [[maybe_unused]] int sx[2][MT][2];
    if constexpr (kGD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kPerGroup) T::zero(dot[h]);
#pragma unroll
        for (int i = 0; i < MT; ++i) sx[h][i][0] = sx[h][i][1] = 0;
      }
    }
    // The group-dot step j: its dots, and those rescales that are made
    // every step.
    auto gd_step = [&](int j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kPerGroup) {
          dot_half<false>(dot[h], sx[h], stage(j), w8[j & 1], h);
        } else {
          Acc d;
          dot_half<true>(d, sx[h], stage(j), w8[j & 1], h);
          scale_dot(acc, d, cs, h);
        }
      }
    };
    // After step j: the rescales made once a group, if j ends its group
    // (or the split).
    auto gd_group_end = [&](int j) {
      const int s = s_begin + j;
      if (s % kStepsPerGroup == kStepsPerGroup - 1 || s + 1 == s_end) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (kPerGroup) {
            scale_dot(acc, dot[h], cs, h);
            T::zero(dot[h]);
          }
          correct(acc, sx[h], cs, h);
        }
      }
    };
    cp_async_wait<S - 2>();       // step 0's copies (this thread's)
    __syncthreads();
    if constexpr (kGD) {
      unpack(stage(0), w8[0]);
    } else {
      load_group(stage(0), sc);
      dequant(stage(0), w8[0], sc);
    }

    for (int j = 0; j + 1 < n; ++j) {
      cp_async_wait<S - 3>();     // step j+1's copies
      __syncthreads();            // ... everyone's; w8 of step j written;
                                  // step j-1's reads done
      fetch(j + S - 1);           // into step j-1's slot
      // One basic block, the mma's shared loads first: the dequant's
      // loads and arithmetic fill the mma's latencies.
      if constexpr (kGD) {
        if (stages_scales(s_begin + j, s_begin)) load_cols(stage(j), cs);
        gd_step(j);
        unpack(stage(j + 1), w8[(j + 1) & 1]);
        gd_group_end(j);
      } else {
        if (stages_scales(s_begin + j + 1, s_begin)) {
          load_group(stage(j + 1), sc);
        }
        mma(acc, stage(j), w8[j & 1]);
        dequant(stage(j + 1), w8[(j + 1) & 1], sc);
      }
    }
    __syncthreads();              // the last step's w8 written
    if constexpr (kGD) {
      if (stages_scales(s_begin + n - 1, s_begin)) {
        load_cols(stage(n - 1), cs);
      }
      gd_step(n - 1);
      gd_group_end(n - 1);
    } else {
      mma(acc, stage(n - 1), w8[(n - 1) & 1]);
    }
    cp_async_wait<0>();
  }
};

// One BM x BN tile of K split blockIdx.z (steps [z * per, (z+1) * per)),
// grid (N / BN, 1, splits), of form kGD; kSplit: more than one split,
// summed through part / counters (Stream::finish).
template <int BM, int BN, int S, int kThreads, bool kGD, bool kSplit>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
              const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
              const int8_t* __restrict__ zr, const float* __restrict__ chan,
              void* __restrict__ out, int* __restrict__ part,
              int* __restrict__ counters, int M, int N, int K, int per,
              int out_bf16) {
  using L = Stream<BM, BN, S, kThreads, kGD>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * BN;
  const int nsteps = (K / 2) / kKP;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(nsteps, s_begin + per);
  typename L::Acc acc;
  L::T::zero(acc);
  L::run(acc, smem, xq, qw, s2, zr, M, n0, N, K, s_begin, s_end);
  L::template finish<kSplit>(acc, xs, chan, out, part, counters, n0, M, N,
                             out_bf16);
}

// ---------------------------------------------------------------------------
// The float-scale form (w4a8_gemm.cu's ferrum_w4a8_decode; replaces
// ferrum_tpu/ops/pallas/quant_matmul.py:172 _qmm_w4a8_kernel):
//
//   y[m, n] = out_t( acc[m, n] * xs[m] ),
//   acc     = left fold over the TPU K steps kk of  (acc + lo(kk)) + hi(kk),
//   lo(kk)  = ((term(g0) + term(g0 + 1)) + ...), gpt terms, g0 = kk * gpt,
//   hi(kk)  = the same over the high plane's groups K/256 + kk * gpt + t,
//   term(g) = f32(sum_{k in g} xq[m, k] * (q[k, n] - z[g, n])) * f32(s[g, n])
//
// in f32, each add and multiply rounded (__fadd_rn / __fmul_rn, no FMA),
// with float group scales s (bf16 or f32) and gpt = the TPU wrapper's
// bkb / 128 (1, 2 or 4: quant_matmul.py::w4a8_step_rows). The float order
// is the TPU kernel's and is kept bit for bit. The integer in a term is
// below 2^24 in magnitude (128 * 127 * 143), so it is taken in int32 as
// dot(xq, q) - z * sum(xq) and converted exactly.
//
// The group-dot form's parts as they are: the ring of 16-byte cp.async
// copies (Stream::load, no scales2 rows), the raw-nibble unpack, the
// per-half int32 dots of mma.sync and the per-half row sums sum(xq) from
// the A fragments (Stream::dot_half). New: each half's dot and row sums
// are kept over the group's two streamed steps; on the group's last step
// the term is made per half (int32 correction, one conversion, one
// multiply) and added to that half's plane sum (lo or hi), which restarts
// at each TPU step's first group; at the TPU step's last group the block
// folds acc = (acc + lo) + hi. A TPU step is 2 * gpt streamed steps; every
// boundary comes from gpt. The scales and zero rows of both halves ride in
// the ring's scale slot on each group's second step, where the group's
// term reads them (f32 scale rows of 4 * BN bytes; bf16 ones fill half).
// BN 64 or 128 columns (at 128, tiles of 16 or 32 rows: the five fragments
// of a larger one spill).
//
// K splits fall on TPU-step boundaries only, so no group or TPU step is
// cut. Split 0 folds its steps from zero and writes its acc into plane 0
// of part [planes, M, N] (f32); each later split writes its steps' (lo,
// hi) plane pairs (planes 1 + 2 * (kk - per), + 1) as it reaches each TPU
// step's end; the tile's last arrival continues the fold from plane 0 in
// TPU-step order and leaves its counter zero. One split: the block writes
// the output from its registers. Row tiles (grid x, 16 / 32 / 64 rows of
// m, side by side in launch order) each walk the whole weight tile; the
// second read comes from L2.
// ---------------------------------------------------------------------------

template <int BM, int BN, int S, int kThreads>
struct FloatScale {
  using L = Stream<BM, BN, S, kThreads, true>;
  using Acc = typename L::Acc;
  static constexpr int MT = L::MT;
  static constexpr int NT = L::NT;
  static constexpr int WN = L::WN;
  static constexpr int WTM = L::WTM;
  static constexpr int WTN = L::WTN;
  using FAcc = float[MT][NT][4];
  // Scale slot: s lo, s hi (BN f32, or BN bf16 in the first half of the
  // row), z lo, z hi (BN int8).
  static constexpr int kSRow = 4 * BN;
  static constexpr int kScBytes = 2 * kSRow + 2 * BN;
  static constexpr int kStageBytes = L::kABytes + L::kPBytes + kScBytes;
  static constexpr int kSmemBytes = 2 * L::kBBytes + S * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "stages stay 16-byte aligned");

  static __device__ __forceinline__ void zero(FAcc& a) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
  }

  // Start the copies of group (s / 2)'s scale and zero rows of both
  // halves into the scale slot of stage `st` (step s, the group's second).
  static __device__ __forceinline__ void load_scales(
      uint8_t* st, int s, const uint8_t* __restrict__ sc,
      const int8_t* __restrict__ zr, int sf32, int N, int K, int n0) {
    const int glo = (s * kKP) / kGroup;
    const int ghi = (K / 2) / kGroup + glo;
    const int sbytes = sf32 ? 4 : 2;
    const int sch = BN * sbytes / 16;     // chunks a scale row
    constexpr int zch = BN / 16;
    const uint32_t sc_s = smem_u32(st) + L::kABytes + L::kPBytes;
    int i = threadIdx.x;
    if (i < 2 * sch) {
      const int h = i / sch;
      const int c = i - h * sch;
      cp_async16(sc_s + h * kSRow + c * 16,
                 sc + ((size_t)(h ? ghi : glo) * N + n0) * sbytes + c * 16,
                 16);
    } else if ((i -= 2 * sch) < 2 * zch) {
      const int h = i / zch;
      const int c = i - h * zch;
      cp_async16(sc_s + 2 * kSRow + h * BN + c * 16,
                 zr + (size_t)(h ? ghi : glo) * N + n0 + c * 16, 16);
    }
  }

  // The group's terms of both halves into the plane sums pl (first: the
  // TPU step's first group, pl = term), from the dots and this lane's row
  // sum parts (summed over the mma group's 4 lanes by two shuffles), with
  // the scales and zeros of stage `st`; then dot and sx are zeroed.
  static __device__ __forceinline__ void group_terms(
      Acc (&dot)[2], int (&sx)[2][MT][2], FAcc (&pl)[2], const uint8_t* st,
      int sf32, bool first) {
    const int wn = (threadIdx.x >> 5) % WN;
    const int t = threadIdx.x & 3;
    const uint8_t* sc_s = st + L::kABytes + L::kPBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[NT][2];
      int z[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * WTN + j * 8 + 2 * t;
        if (sf32) {
          const float2 v =
              *reinterpret_cast<const float2*>(sc_s + h * kSRow + col * 4);
          s[j][0] = v.x;
          s[j][1] = v.y;
        } else {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              sc_s + h * kSRow + col * 2);
          s[j][0] = __low2float(v);
          s[j][1] = __high2float(v);
        }
        const uint32_t zw = *reinterpret_cast<const uint16_t*>(
            sc_s + 2 * kSRow + h * BN + col);
        z[j][0] = (int)(int8_t)(zw & 0xFFu);
        z[j][1] = (int)(int8_t)(zw >> 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sx[h][i][r] += __shfl_xor_sync(0xffffffffu, sx[h][i][r], 1);
          sx[h][i][r] += __shfl_xor_sync(0xffffffffu, sx[h][i][r], 2);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = dot[h][i][j][e] - z[j][e & 1] * sx[h][i][e >> 1];
            const float term = __fmul_rn(__int2float_rn(v), s[j][e & 1]);
            pl[h][i][j][e] = first ? term : __fadd_rn(pl[h][i][j][e], term);
          }
      L::T::zero(dot[h]);
#pragma unroll
      for (int i = 0; i < MT; ++i) sx[h][i][0] = sx[h][i][1] = 0;
    }
  }

  // f(row, col, e) for each pair of adjacent elements e, e + 1 of the
  // fragments (columns col, col + 1) in a row below M.
  template <class F>
  static __device__ __forceinline__ void for_each_pair(int M, F&& f) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = wm * WTM + i * 16 + (lane >> 2) + 4 * e;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          f(row, wn * WTN + j * 8 + 2 * (lane & 3), i, j, e);
        }
      }
    }
  }

  // acc folded over streamed steps [s_begin, s_end) (whole TPU steps) of
  // rows [0, M) of xq and columns n0 .. n0 + BN: lohi null (split 0), the
  // TPU steps fold into acc; else each TPU step's (lo, hi) goes to planes
  // lohi + 2 * i * plane and + plane (its i-th TPU step).
  static __device__ __forceinline__ void run(
      FAcc& acc, uint8_t* smem, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const uint8_t* __restrict__ sc,
      const int8_t* __restrict__ zr, int sf32, int M, int n0, int N, int K,
      int s_begin, int s_end, int gpt, float* __restrict__ lohi,
      size_t plane) {
    uint8_t* const nib[2] = {smem, smem + L::kBBytes};
    uint8_t* const ring = smem + 2 * L::kBBytes;
    const int n = s_end - s_begin;
    auto stage = [&](int j) { return ring + (j % S) * kStageBytes; };
    auto fetch = [&](int j) {
      const int s = s_begin + j;
      if (j < n) {
        L::load(stage(j), s, false, xq, qw, nullptr, nullptr, M, n0, N, K);
        if (s & 1) load_scales(stage(j), s, sc, zr, sf32, N, K, n0);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < S - 1; ++j) fetch(j);
    Acc dot[2];
    int sx[2][MT][2];
    FAcc pl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      L::T::zero(dot[h]);
#pragma unroll
      for (int i = 0; i < MT; ++i) sx[h][i][0] = sx[h][i][1] = 0;
    }
    zero(pl[0]);
    zero(pl[1]);
    auto dots = [&](int j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        L::template dot_half<false>(dot[h], sx[h], stage(j), nib[j & 1], h);
      }
    };
    // After step j, the second of its group (s_begin is even): the
    // group's terms, and at the TPU step's last group its fold or planes.
    auto group_end = [&](int j) {
      const int g = (s_begin + j) >> 1;
      const int gi = g & (gpt - 1);
      group_terms(dot, sx, pl, stage(j), sf32, gi == 0);
      if (gi != gpt - 1) return;
      if (lohi == nullptr) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jj = 0; jj < NT; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][jj][e] = __fadd_rn(__fadd_rn(acc[i][jj][e],
                                                  pl[0][i][jj][e]),
                                        pl[1][i][jj][e]);
      } else {
        float* lo = lohi + (size_t)(2 * (g / gpt - s_begin / (2 * gpt)))
                           * plane + n0;
        for_each_pair(M, [&](int row, int col, int i, int jj, int e) {
          const size_t idx = (size_t)row * N + col;
          *reinterpret_cast<float2*>(lo + idx) =
              make_float2(pl[0][i][jj][e], pl[0][i][jj][e + 1]);
          *reinterpret_cast<float2*>(lo + plane + idx) =
              make_float2(pl[1][i][jj][e], pl[1][i][jj][e + 1]);
        });
      }
    };
    cp_async_wait<S - 2>();       // step 0's copies (this thread's)
    __syncthreads();
    L::unpack(stage(0), nib[0]);
    for (int j = 0; j + 1 < n; ++j) {
      cp_async_wait<S - 3>();     // step j+1's copies
      __syncthreads();            // ... everyone's; step j's nibbles
                                  // written; step j-1's reads done
      fetch(j + S - 1);           // into step j-1's slot
      dots(j);
      L::unpack(stage(j + 1), nib[(j + 1) & 1]);
      if (j & 1) group_end(j);
    }
    __syncthreads();              // the last step's nibbles written
    dots(n - 1);
    group_end(n - 1);             // n is even: a group's second step
    cp_async_wait<0>();
  }

  // out[row, n0 + col .. + 1] = out_t(a * xs[row]), out_t(b * xs[row]).
  static __device__ __forceinline__ void store_pair(
      void* __restrict__ out, const float* __restrict__ xs, int N, int row,
      int col, float a, float b, int out_bf16) {
    const float sx = xs[row];
    a = __fmul_rn(a, sx);
    b = __fmul_rn(b, sx);
    const size_t idx = (size_t)row * N + col;
    if (out_bf16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out)
                                         + idx) = __floats2bfloat162_rn(a, b);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
          make_float2(a, b);
    }
  }

  // The epilogue of split blockIdx.z of gridDim.z (see the header):
  // kSplit false, straight to out; else split 0's acc into plane 0 of
  // part, then the tile's last arrival (*counter: zero on entry, zero
  // again on return) folds plane 0 with the (lo, hi) planes of TPU
  // steps per .. T - 1 in order.
  template <bool kSplit>
  static __device__ __forceinline__ void finish(
      const FAcc& acc, const float* __restrict__ xs, void* __restrict__ out,
      float* __restrict__ part, int* __restrict__ counter, int n0, int M,
      int N, size_t plane, int T, int per, int out_bf16) {
    if constexpr (!kSplit) {
      for_each_pair(M, [&](int row, int col, int i, int j, int e) {
        store_pair(out, xs, N, row, n0 + col, acc[i][j][e],
                   acc[i][j][e + 1], out_bf16);
      });
    } else {
      if (blockIdx.z == 0) {
        for_each_pair(M, [&](int row, int col, int i, int j, int e) {
          *reinterpret_cast<float2*>(part + (size_t)row * N + n0 + col) =
              make_float2(acc[i][j][e], acc[i][j][e + 1]);
        });
      }
      __shared__ int last;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
        if (last) *counter = 0;
      }
      __syncthreads();
      if (!last) return;
      __threadfence();
      for_each_pair(M, [&](int row, int col, int, int, int) {
        const float* src = part + (size_t)row * N + n0 + col;
        float2 a = __ldcg(reinterpret_cast<const float2*>(src));
        for (int kk = per; kk < T; ++kk) {
          const float* p = src + (size_t)(1 + 2 * (kk - per)) * plane;
          const float2 lo = __ldcg(reinterpret_cast<const float2*>(p));
          const float2 hi = __ldcg(reinterpret_cast<const float2*>(p + plane));
          a.x = __fadd_rn(__fadd_rn(a.x, lo.x), hi.x);
          a.y = __fadd_rn(__fadd_rn(a.y, lo.y), hi.y);
        }
        store_pair(out, xs, N, row, n0 + col, a.x, a.y, out_bf16);
      });
    }
  }
};

// One BM x BN tile of the float-scale form: row tile blockIdx.x (rows
// BM * x ..; the row tiles of a column tile run side by side, so the
// second read of its weight tile comes from L2), column tile blockIdx.y,
// TPU steps [z * per, (z+1) * per) of K split blockIdx.z; grid
// (ceil(M / BM), N / BN, splits). part: f32 [1 + 2 * (T - per), M, N]
// where kSplit; counters one per (column tile, row tile).
// kMinBlocks: the resident blocks an SM the kernel is compiled to fit
// (a register cap of 65536 / (kMinBlocks * kThreads); 1 leaves ptxas its
// own count).
template <int BM, int BN, int S, int kThreads, int kMinBlocks, bool kSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fs_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const uint8_t* __restrict__ qw, const uint8_t* __restrict__ sc,
                 const int8_t* __restrict__ zr, void* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters, int M,
                 int N, int K, int gpt, int per, int sf32, int out_bf16) {
  using F = FloatScale<BM, BN, S, kThreads>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int rows = min(BM, M - row0);
  const int T = (K / 2) / (gpt * kGroup);
  const int t_begin = blockIdx.z * per;
  const int t_end = min(T, t_begin + per);
  const size_t plane = (size_t)M * N;
  float* const rpart = part + (size_t)row0 * N;
  float* const lohi = blockIdx.z == 0
      ? nullptr : rpart + (size_t)(1 + 2 * (t_begin - per)) * plane;
  typename F::FAcc acc;
  F::zero(acc);
  F::run(acc, smem, xq + (size_t)row0 * K, qw, sc, zr, sf32, rows, n0, N, K,
         t_begin * 2 * gpt, t_end * 2 * gpt, gpt, lohi, plane);
  void* const rout = static_cast<uint8_t*>(out)
                     + (size_t)row0 * N * (out_bf16 ? 2 : 4);
  F::template finish<kSplit>(acc, xs + row0, rout, rpart,
                             counters + blockIdx.y * gridDim.x + blockIdx.x,
                             n0, rows, N, plane, T, per, out_bf16);
}

// ---------------------------------------------------------------------------
// The launcher of both forms (decode_any<kGD>), with internal linkage: each
// library that includes it (and each rebuilt copy of one) keeps its own
// once-per-device state -- function-local statics of an external template
// are one object process-wide (STB_GNU_UNIQUE), across dlopen'ed copies.
// ---------------------------------------------------------------------------

namespace {

constexpr int kDecodeStages = 4;
// The split count's cost model, in K steps of one block: a block's fixed
// cost (ring fill, epilogue), and the split-K partial sums whose stores
// and loads take a step's time (each split adds M x N of them).
constexpr double kBlockSteps = 2;
constexpr double kPartialsPerStep = 1e6;
// Packed weights of at most this many bytes take 64-column tiles.
constexpr long kNarrowBytes = 16L << 20;

// The arguments of a decode launch. plan: when not null, the launch is
// not made and plan[0..6] get BM, BN, threads, stages, splits, K steps
// per split and resident blocks per SM.
struct DecodeArgs {
  const void *xq, *xs, *qw, *s2, *z, *chan;
  void* out;
  int *part, *counters;
  int M, N, K, splits, out_bf16;
  cudaStream_t st;
  int* plan;
};

// The split count: the fewest of those with the least waves * (steps a
// split + kBlockSteps) + splits * M * N / kPartialsPerStep (one split:
// no partials), for `tiles` column tiles of BN and `nsteps` K steps on
// `slots` resident blocks.
int decode_splits(int M, int BN, int tiles, int nsteps, int slots) {
  int best = 1;
  double best_cost = -1;
  for (int s = 1; s <= nsteps; ++s) {
    const int per = (nsteps + s - 1) / s;
    if ((nsteps + per - 1) / per != s) continue;
    const int waves = (tiles * s + slots - 1) / slots;
    const double cost = waves * (per + kBlockSteps)
        + (s > 1 ? (double)s * M * BN * tiles / kPartialsPerStep : 0.0);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <bool kGD, int BM, int BN, int kThreads>
int decode(const DecodeArgs& a) {
  constexpr int S = kDecodeStages;
  using L = Stream<BM, BN, S, kThreads, kGD>;
  const auto split_k = decode_kernel<BM, BN, S, kThreads, kGD, true>;
  const auto whole = decode_kernel<BM, BN, S, kThreads, kGD, false>;
  // The shared-memory limit is raised once per device (the launch is on
  // every decode projection's path; the host holds the serve loop).
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    for (auto kernel : {split_k, whole}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
      if (e != cudaSuccess) return (int)e;
    }
    ready.fetch_or(bit);
  }
  static const int per_sm = [&] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, split_k, kThreads, L::kSmemBytes);
    return b > 0 ? b : 1;
  }();
  const int nsteps = (a.K / 2) / kKP;
  const int tiles = a.N / BN;
  int splits = a.splits > 0 ? min(a.splits, nsteps)
      : decode_splits(a.M, BN, tiles, nsteps,
                      w4a8tl_wgmma::num_sms() * per_sm);
  const int per = (nsteps + splits - 1) / splits;
  splits = (nsteps + per - 1) / per;        // every split gets steps
  if (a.plan) {
    const int plan[7] = {BM, BN, kThreads, S, splits, per, per_sm};
    for (int i = 0; i < 7; ++i) a.plan[i] = plan[i];
    return (int)cudaSuccess;
  }
  const auto kernel = splits > 1 ? split_k : whole;
  kernel<<<dim3(tiles, 1, splits), kThreads, L::kSmemBytes, a.st>>>(
      static_cast<const int8_t*>(a.xq), static_cast<const float*>(a.xs),
      static_cast<const uint8_t*>(a.qw), static_cast<const int8_t*>(a.s2),
      static_cast<const int8_t*>(a.z), static_cast<const float*>(a.chan),
      a.out, a.part, a.counters, a.M, a.N, a.K, per, a.out_bf16);
  return (int)cudaGetLastError();
}

// 128 threads where the column tiles alone fill the SMs (the rows of a
// block's mma on fewer warps); 256 elsewhere (twice the warps to cover
// the dequant's and the copies' latencies).
template <bool kGD, int BM, int BN>
int decode_threads(const DecodeArgs& a) {
  const bool few = a.N / BN >= w4a8tl_wgmma::num_sms();
  return few ? decode<kGD, BM, BN, 128>(a) : decode<kGD, BM, BN, 256>(a);
}

template <bool kGD, int BN>
int decode_bm(const DecodeArgs& a) {
  return a.M <= 16 ? decode_threads<kGD, 16, BN>(a)
       : a.M <= 32 ? decode_threads<kGD, 32, BN>(a)
                   : decode_threads<kGD, 64, BN>(a);
}

// A decode launch of form kGD (or its plan): all M rows (BM = 16 / 32 /
// 64) x 128 columns (64 where N % 128 != 0 or K/2 x N <= 16 MiB), 64
// packed rows (128 k) per K step, K split across blockIdx.z into
// a.splits parts (0: the count decode_splits picks; at most one split
// per K step). Requires 1 <= M <= 64, K % 256 == 0, N % 64 == 0.
template <bool kGD>
int decode_any(const DecodeArgs& a) {
  if (a.M < 1 || a.M > 64 || a.K % 256 || a.N % 64) {
    return (int)cudaErrorInvalidValue;
  }
  // 64 columns where N % 128 != 0, or where the packed weight is small:
  // there the fixed costs of a launch and a split dominate, and twice the
  // column tiles (at half the shared memory: 4 resident blocks an SM, not
  // 2) fill the SMs with fewer K splits.
  const bool narrow = a.N % 128 != 0 || (long)a.K / 2 * a.N <= kNarrowBytes;
  return narrow ? decode_bm<kGD, 64>(a) : decode_bm<kGD, 128>(a);
}

}  // namespace

}  // namespace w4a8tl_stream
