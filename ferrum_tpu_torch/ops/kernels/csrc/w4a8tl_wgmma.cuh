// The two-level w4a8 GEMMs' main loop at prefill sizes on Hopper (sm_90a):
// one block's int32 tile of  acc[m, n] = sum_k xq[m, k] * w8[k, n],
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128,
// then the epilogue y = out_t(f32(acc) * xs[m] * chan[n]) (or with chan
// before xs), bit for bit the plain versions w4a8tl_plain
// (ops/kernels/quant_matmul.py) and grouped_plain (moe_gemm.py) and the
// TPU kernels it replaces in ferrum_tpu/ops/pallas/quant_matmul.py:
//   :289  _qmm_w4a8tl_kernel         128-row tiles   (w4a8tl_gemm.cu)
//   :339  _qmm_w4a8tl_mcache_kernel  256-row tiles   (w4a8tl_mcache.cu)
//   :1098 _qgmm_w4a8tl_kernel        128-row tiles of one expert's rows
//                                    (moe_gemm.cu)
// q is packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of qweight
// [K/2, N] holds row r in its low nibble and row K/2 + r in its high
// nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31 for
// K <= 14336: the int32 sums are exact, in any order.
//
// What bounds them on the H100: at m = 2048 a llama layer does ~4100 int8
// ops per weight byte it reads, so the int8 tensor cores (1979 TOP/s)
// bound it. An s8 wgmma reads ~80-96 bytes of shared memory a cycle of
// the SM's 128 at its full rate, so every other shared-memory byte a
// step moves (copies in, dequant out) competes with the tensor cores;
// and the dequant runs once per block and K step, so a taller block
// spends fewer instructions per tensor op.
//
// Design:
//  - 256 threads: two consumer warpgroups, each owning BM / 2 rows of the
//    block's BM = 128 (one m64 tile each; kernel 2) or 256 (two m64 tiles
//    each, one shared w8 buffer; kernel 8) rows; BN = 128 or 256 columns.
//    Every thread also loads; the first BN threads also dequantize. No
//    producer warp.
//  - A K step is KP = 64 packed rows: 64 low-nibble rows (k = r0 + i)
//    and the 64 matching high-nibble rows (k = K/2 + r0 + i), 128
//    k-values. The sums are integers, so the k order inside a step is
//    free: one 128-byte line per row of xq holds [xq low 64 | xq high 64]
//    and one per column of w8 holds [w8 low 64 | w8 high 64].
//  - s8 wgmma takes both shared-memory operands K-major only, so the w8
//    tile is written transposed to the packed weight's N-contiguous rows:
//    [BN lines][128 k] with the hardware's 128-byte swizzle (16-byte chunk
//    c of line n at c ^ (n % 8)), like the xq tile [BM lines][128 k].
//  - A ring of S stages, filled by 16-byte cp.async, holds per step the
//    xq tile (rows outside the window [row_lo, row_hi) zero-filled: [0,
//    M) for a dense GEMM, one expert's rows of the tile for the grouped
//    one), the packed weight tile
//    ([64, BN] bytes as it lies in the global-halves layout, chunks
//    XOR-swizzled by 16-row block so the dequant's loads are free of bank
//    conflicts) and the step's scales2 / zero rows of both halves (groups
//    r0 / 128 and K/256 + r0 / 128). Loads for steps s+1 .. s+S-2 are in
//    flight while step s computes.
//  - Dequant: a thread takes 16 packed rows x 4 columns: per 4 rows four
//    32-bit loads, a 4 x 4 byte transpose (8 prmt) into one word of 4
//    consecutive k per column, then per column and nibble half
//    (q - z) * s in two 16-bit lanes per IMAD, q * s + (-z * s mod 256):
//    the low byte of each lane is w8 (its value fits int8, so mod-256
//    arithmetic is exact); a prmt packs the 4 bytes. One 16-byte store per
//    column and half (conflict-free by the swizzle).
//  - Step s: barrier; wgmma on stage s (async), then wait for step s-1's
//    wgmma only; wait for step s+1's tiles; barrier; issue the loads of
//    step s+S-1 into step s-1's slot; dequantize step s+1 into the w8
//    buffer step s-1 read, overlapping step s's wgmma. Generic-proxy
//    writes that wgmma reads (the dequant's stores, the cp.async tiles)
//    are each followed by fence.proxy.async before the barrier ahead of
//    the wgmma. Every warpgroup issues its wgmma, also where its rows lie
//    outside the window (zeros): a wgmma in a divergent branch makes
//    ptxas serialize every wgmma of the kernel (C7518).
//  - Epilogue, for the window's rows: f32(acc) * xs[m] * chan[n] (the
//    dense kernels) or f32(acc) * chan[n] * xs[m] (the grouped one,
//    moe_gemm.cu), in that order, each product rounded (no FMA), then
//    round-to-nearest-even to bf16 (or f32 out).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "w4a16_wgmma.cuh"   // cp.async, fences, wgmma sync, descriptors,
                              // shared-memory alignment, SM count

namespace w4a8tl_wgmma {

using w4a16_wgmma::aligned_smem;
using w4a16_wgmma::cp_async16;
using w4a16_wgmma::cp_async_commit;
using w4a16_wgmma::cp_async_wait;
using w4a16_wgmma::desc_sw128;
using w4a16_wgmma::fence_proxy_async;
using w4a16_wgmma::num_sms;
using w4a16_wgmma::smem_u32;
using w4a16_wgmma::wgmma_commit;
using w4a16_wgmma::wgmma_fence;
using w4a16_wgmma::wgmma_wait;

constexpr int kGroup = 128;
constexpr int kKP = 64;          // packed rows per K step (128 k-values)
constexpr int kThreads = 256;    // two consumer warpgroups
constexpr int kLine = 128;       // one swizzled K-major line: 128 int8 k
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kRasterRows = 2048;  // rows of one raster group of m-tiles

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64xN] += A[64x32] . B[32xN], s8 x s8 -> s32, both K-major in shared
// memory; N/2 int32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Column word t (4 packed rows' bytes of one column, row i in byte i) ->
// the 4 w8 of nibble half kShift (0: low, 4: high): lanes (q0, q2) and
// (q1, q3) as 16-bit fields, q * s + c with c = -z * s mod 256 (one
// IMAD each; no field exceeds 15 * 255 + 255), bytes 0 of the four
// fields packed in row order.
template <int kShift>
__device__ __forceinline__ uint32_t dequant4(uint32_t t, uint32_t s,
                                             uint32_t c) {
  const uint32_t e = ((t >> kShift) & 0x000F000Fu) * s + c;
  const uint32_t o = ((t >> (kShift + 8)) & 0x000F000Fu) * s + c;
  return __byte_perm(e, o, 0x6240);
}

template <int BM, int BN>
struct Mainloop {
  static_assert(BM == 128 || BM == 256, "BM is 128 or 256");
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static constexpr int MT = BM / 128;            // m64 tiles a warpgroup
  static constexpr int kBBytes = BN * kLine;     // w8, per buffer
  static constexpr int kABytes = BM * kLine;
  static constexpr int kPBytes = kKP * BN;
  static constexpr int kScBytes = 4 * BN;        // s2 lo, s2 hi, z lo, z hi
  static constexpr int kStageBytes =
      (kABytes + kPBytes + kScBytes + 1023) / 1024 * 1024;
  static constexpr int kOffA = 2 * kBBytes;
  // + 1024: the kernel aligns the dynamic shared memory's base itself.
  static constexpr int kSmemBytes = kOffA + kStages * kStageBytes + 1024;
  // Dequant units: 16 packed rows x 4 columns; one per thread below BN.
  static constexpr int kUnits = BN;

  using Acc = int[MT][BN / 2];    // m64nBN: BN / 2 int32 a thread a tile

  // This thread's 4 columns' scales2 (as unsigned bytes) and -z * s2 mod
  // 256 (in both 16-bit fields), both halves.
  struct Scales {
    uint32_t s[2][4];
    uint32_t c[2][4];
  };

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0;
  }

  static __device__ __forceinline__ uint8_t* stage(uint8_t* base, int slot) {
    return base + kOffA + slot * kStageBytes;
  }

  // Issue step s's copies into ring slot `slot`.
  static __device__ __forceinline__ void load(
      uint8_t* base, int slot, int s, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K) {
    const int tid = threadIdx.x;
    const int K2 = K / 2;
    const int r0 = s * kKP;
    uint8_t* st = stage(base, slot);
    const uint32_t a_s = smem_u32(st);
    // xq: BM rows x 8 chunks; chunks 0-3 the low half's 64 k, 4-7 the
    // high half's, at chunk c ^ (row % 8) of the row's line.
#pragma unroll
    for (int i = 0; i < BM * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;
      const int c = idx & 7;
      const int m = m0 + row;
      // row_lo <= m < row_hi in one compare (row_lo is 0 for the dense
      // kernels).
      const bool ok = (unsigned)(m - row_lo) < (unsigned)(row_hi - row_lo);
      const int8_t* src =
          ok ? xq + (size_t)m * K + (c < 4 ? r0 : K2 + r0 - 64) + c * 16 : xq;
      cp_async16(a_s + row * kLine + ((c ^ (row & 7)) << 4), src,
                 ok ? 16 : 0);
    }
    // Packed weight: 64 rows of BN bytes, chunk c of row r at
    // c ^ (2 * ((r / 16) % 4)).
    const uint32_t p_s = a_s + kABytes;
#pragma unroll
    for (int i = 0; i < kPBytes / 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / (BN / 16);
      const int c = idx % (BN / 16);
      cp_async16(p_s + row * BN + ((c ^ ((row >> 3) & 6)) << 4),
                 qw + (size_t)(r0 + row) * N + n0 + c * 16, 16);
    }
    // scales2 rows (glo, ghi), then zero rows (glo, ghi).
    const int glo = r0 / kGroup;
    const int ghi = K2 / kGroup + glo;
    if (tid < kScBytes / 16) {
      const int h = tid / (BN / 16);
      const int c = tid % (BN / 16);
      const int8_t* src = (h < 2 ? s2 : zr)
                          + (size_t)((h & 1) ? ghi : glo) * N + n0 + c * 16;
      cp_async16(p_s + kPBytes + h * BN + c * 16, src, 16);
    }
  }

  // The scales of this thread's columns 4 * (tid / 4) .. + 3 from the
  // staged rows of `slot`.
  static __device__ __forceinline__ void load_group(uint8_t* base, int slot,
                                                    Scales& sc) {
    if (kUnits < kThreads && threadIdx.x >= kUnits) return;
    const int cu = threadIdx.x >> 2;
    const uint8_t* sc_s = stage(base, slot) + kABytes + kPBytes;
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

  // Dequantize the packed tile of `slot` into w8 buffer `bbuf`: thread u
  // < BN takes packed rows 16 * (u % 4) .. + 15 of columns 4 * (u / 4)
  // .. + 3 and writes, per column n, chunk u % 4 (low half) and 4 + u % 4
  // (high half) of line n.
  static __device__ __forceinline__ void dequant(uint8_t* base, int slot,
                                                 int bbuf, const Scales& sc) {
    const int tid = threadIdx.x;
    if (kUnits < kThreads && tid >= kUnits) return;
    const int rb = tid & 3;
    const int cu = tid >> 2;
    const uint8_t* p_s = stage(base, slot) + kABytes
                         + (((cu >> 2) ^ (2 * rb)) << 4) + ((cu & 3) << 2);
    uint8_t* b_s = base + bbuf * kBBytes;
    uint32_t lo[4][4], hi[4][4];      // [column][k quad]
#pragma unroll
    for (int i4 = 0; i4 < 4; ++i4) {
      const int r = 16 * rb + 4 * i4;
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
      for (int j = 0; j < 4; ++j) {
        lo[j][i4] = dequant4<0>(t[j], sc.s[0][j], sc.c[0][j]);
        hi[j][i4] = dequant4<4>(t[j], sc.s[1][j], sc.c[1][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * cu + j;
      uint8_t* line = b_s + n * kLine;
      *reinterpret_cast<uint4*>(line + ((rb ^ (n & 7)) << 4)) =
          make_uint4(lo[j][0], lo[j][1], lo[j][2], lo[j][3]);
      *reinterpret_cast<uint4*>(line + (((4 + rb) ^ (n & 7)) << 4)) =
          make_uint4(hi[j][0], hi[j][1], hi[j][2], hi[j][3]);
    }
  }

  // Four k32 slices of step data: the MT m64 tiles of warpgroup `wg` in
  // `slot` against w8 buffer `bbuf`. Both K-major: 8-line groups 1024
  // bytes apart (SBO), k32 = 32 bytes along the line.
  static __device__ __forceinline__ void mma(Acc& acc, uint8_t* base,
                                             int slot, int bbuf, int wg) {
    const uint32_t a0 =
        smem_u32(stage(base, slot)) + wg * MT * 64 * kLine;
    const uint32_t b0 = smem_u32(base + bbuf * kBBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(b0 + kk * 32, 16, 1024);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint64_t da = desc_sw128(a0 + t * 64 * kLine + kk * 32, 16,
                                       1024);
        if constexpr (BN == 256) {
          wgmma_m64n256k32(acc[t], da, db);
        } else {
          wgmma_m64n128k32(acc[t], da, db);
        }
      }
    }
  }

  // acc += xq[rows m0 .. m0+BM) . w8[:, n0 .. n0+BN) over all of K. xq is
  // row-major int8 [*, K]; rows outside [row_lo, row_hi) read as zero.
  // qw/s2/zr point at
  // one weight ([K/2, N], [K/128, N] x2). `base` is the block's dynamic
  // shared memory, 1024-byte aligned.
  static __device__ __forceinline__ void run(
      Acc& acc, uint8_t* base, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K) {
    constexpr int S = kStages;
    static_assert(S >= 3, "the ring holds the step whose wgmma runs, the "
                          "step dequantized and at least one in flight");
    const int wg = threadIdx.x / 128;
    const int nsteps = (K / 2) / kKP;
    constexpr int kStepsPerGroup = kGroup / kKP;

#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < nsteps) {
        load(base, st, st, xq, qw, s2, zr, m0, row_lo, row_hi, n0, N, K);
      }
      cp_async_commit();
    }
    Scales sc;
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
    load_group(base, 0, sc);
    dequant(base, 0, 0, sc);
    fence_proxy_async();

    for (int s = 0; s < nsteps; ++s) {
      __syncthreads();
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_operands(acc[t]);
      wgmma_fence();
      mma(acc, base, s % S, s & 1, wg);
      wgmma_commit();
      wgmma_wait<1>();            // step s-1's wgmma done, step s's in flight
      cp_async_wait<S - 3>();     // step s+1's tiles landed
      fence_proxy_async();
      __syncthreads();            // ... for every thread; s-1's reads done
      const int ahead = s + S - 1;
      if (ahead < nsteps) {
        load(base, ahead % S, ahead, xq, qw, s2, zr, m0, row_lo, row_hi, n0,
             N, K);
      }
      cp_async_commit();
      const int nx = s + 1;
      if (nx < nsteps) {
        if (nx % kStepsPerGroup == 0) load_group(base, nx % S, sc);
        dequant(base, nx % S, nx & 1, sc);
        fence_proxy_async();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_operands(acc[t]);
    cp_async_wait<0>();
  }

  // out[row, col] = out_t(f32(acc) * xs[row] * chan[col]), or with
  // kChanFirst out_t(f32(acc) * chan[col] * xs[row]), for the rows in
  // [row_lo, row_hi). Fragment of m64nN: warp w of the warpgroup holds
  // rows 16w + lane/4 (+8) of its tile, columns 8j + 2 (lane % 4) (+1).
  template <bool kChanFirst>
  static __device__ __forceinline__ void store(
      const Acc& acc, const float* __restrict__ xs,
      const float* __restrict__ chan, void* __restrict__ out, int m0,
      int row_lo, int row_hi, int n0, int N, int out_bf16) {
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int rlo = m0 + (wg * MT + t) * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = rlo + 8 * e;
        if ((unsigned)(row - row_lo) >= (unsigned)(row_hi - row_lo)) continue;
        const float sx = xs[row];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + j * 8 + (lane % 4) * 2;
          const float a0 = __int2float_rn(acc[t][j * 4 + 2 * e]);
          const float a1 = __int2float_rn(acc[t][j * 4 + 2 * e + 1]);
          const float v0 = kChanFirst
              ? __fmul_rn(__fmul_rn(a0, chan[col]), sx)
              : __fmul_rn(__fmul_rn(a0, sx), chan[col]);
          const float v1 = kChanFirst
              ? __fmul_rn(__fmul_rn(a1, chan[col + 1]), sx)
              : __fmul_rn(__fmul_rn(a1, sx), chan[col + 1]);
          const size_t idx = (size_t)row * N + col;
          if (out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(out) + idx) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
};

// One BM x BN output tile per block, grid 1-D over the tiles in raster
// groups of kRasterRows / BM m-tiles (m fastest inside a group), so a wave
// shares weight tiles in L2.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
            const int8_t* __restrict__ zr, const float* __restrict__ chan,
            void* __restrict__ out, int M, int N, int K, int out_bf16) {
  using L = Mainloop<BM, BN>;
  constexpr int kGroupM = kRasterRows / BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tiles_m = (M + BM - 1) / BM;
  const int per_group = kGroupM * (N / BN);
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int gm = min(kGroupM, tiles_m - first_m);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * BM;
  const int n0 = (in_group / gm) * BN;

  typename L::Acc acc;
  L::zero(acc);
  L::run(acc, base, xq, qw, s2, zr, m0, 0, M, n0, N, K);
  L::template store<false>(acc, xs, chan, out, m0, 0, M, n0, N, out_bf16);
}

// Launch `kernel`, a kernel on Mainloop<BM, BN>, with the main loop's
// dynamic shared memory (above the 48 KB default, so the limit is raised
// first). Returns a cudaError_t.
template <int BM, int BN, class Kernel, class... Args>
int launch_on(Kernel kernel, dim3 grid, cudaStream_t st, Args... args) {
  constexpr int smem = Mainloop<BM, BN>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The dense BM x BN kernel over [M, N]. Returns a cudaError_t.
template <int BM, int BN>
int launch(const void* xq, const void* xs, const void* qw, const void* s2,
           const void* z, const void* chan, void* out, int M, int N, int K,
           int out_bf16, cudaStream_t st) {
  const int tiles = (M + BM - 1) / BM * (N / BN);
  return launch_on<BM, BN>(
      gemm_kernel<BM, BN>, dim3(tiles), st, static_cast<const int8_t*>(xq),
      static_cast<const float*>(xs), static_cast<const uint8_t*>(qw),
      static_cast<const int8_t*>(s2), static_cast<const int8_t*>(z),
      static_cast<const float*>(chan), out, M, N, K, out_bf16);
}

}  // namespace w4a8tl_wgmma
