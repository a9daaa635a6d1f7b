// Shared building blocks of the two-level w4a8 GEMMs for Hopper (sm_90a):
// one block's int32 tile of  acc[m, n] = sum_k xq[m, k] * w8[k, n],
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128,
// with q packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of
// qweight [K/2, N] holds row r in its low nibble and row K/2 + r in its
// high nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31
// for K <= 14336: the int32 sums are exact.
//
// Used by moe_gemm.cu's grouped GEMM at its 16-row tiles (its 128-row
// ones run on w4a8tl_wgmma.cuh), which applies its own float epilogue to
// the tile. The streamed decode loop (w4a8tl_stream.cuh: both dense
// decode forms and the all-experts bmm) takes only its accumulator layout
// and mma_s8.
//
// The block owns a BM x BN output tile and walks K in steps of KP packed
// rows (2*KP k-values: KP low-nibble rows and the matching KP high-nibble
// rows). Each step stages the xq tile (16-byte loads; rows outside
// [row_lo, row_hi) are zero; `stage_a`) and the weight tile -- dequantized
// to int8 w8 (`stage_b`), transposed to [n][k] so a B fragment is one
// 32-bit shared load -- in
// shared memory, then runs mma.sync m16n8k32 s8 x s8 -> s32 from it, one
// nibble plane (half) at a time (`mma_half`). Rows are padded by 16 bytes
// so fragment loads hit 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace w4a8tl {

constexpr int kGroup = 128;
constexpr int kPad = 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(void* out, size_t idx, float v,
                                          int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[idx] = v;
  }
}

template <int BM, int BN, int KP, int WM, int WN>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDS = KP + kPad;  // bytes per shared row
  static constexpr int WTM = BM / WM;    // warp tile
  static constexpr int WTN = BN / WN;
  static constexpr int MT = WTM / 16;    // m16 tiles per warp
  static constexpr int NT = WTN / 8;     // n8 tiles per warp
  static_assert(kGroup % KP == 0, "a K step must stay inside one group");
  static_assert(MT >= 1 && NT >= 1, "warp tile too small");

  // [0] = low-nibble half (k = r), [1] = high-nibble half (k = K/2 + r)
  struct Smem {
    int8_t A[2][BM][LDS];
    int8_t B[2][BN][LDS];
  };
  using Acc = int[MT][NT][4];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }

  // sm.A <- xq rows m0.. of the K step at packed row r0: columns r0..
  // (low half) and K/2 + r0.. (high half); rows outside [row_lo, row_hi)
  // read as zero. xq is row-major [*, K].
  static __device__ __forceinline__ void stage_a(
      Smem& sm, const int8_t* __restrict__ xq, int m0, int row_lo,
      int row_hi, int K, int r0) {
    const int K2 = K / 2;
    constexpr int kAVec = BM * KP / 16;
#pragma unroll 2
    for (int i = threadIdx.x; i < 2 * kAVec; i += kThreads) {
      const int h = i / kAVec;
      const int j = i - h * kAVec;
      const int row = j / (KP / 16);
      const int c16 = j - row * (KP / 16);
      const int m = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m >= row_lo && m < row_hi) {
        v = *reinterpret_cast<const uint4*>(
            xq + (size_t)m * K + (size_t)h * K2 + r0 + c16 * 16);
      }
      *reinterpret_cast<uint4*>(&sm.A[h][row][c16 * 16]) = v;
    }
  }

  // sm.B <- the weight tile of the K step at packed row r0, columns n0..,
  // written transposed ([n][k], 4 k-values per 32-bit word): the
  // dequantized w8 = (q - z) * scales2 of the step's two groups (low
  // plane: group r0 / 128, high plane: K/256 + r0 / 128). 4 packed rows x
  // 4 columns per unit.
  static __device__ __forceinline__ void stage_b(
      Smem& sm, const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int n0, int N, int K, int r0) {
    const int glo = r0 / kGroup;
    const int ghi = (K / 2) / kGroup + glo;
    constexpr int kUnits = (KP / 4) * (BN / 4);
#pragma unroll 2
    for (int u = threadIdx.x; u < kUnits; u += kThreads) {
      const int cu = u % (BN / 4);
      const int ru = u / (BN / 4);
      const int n = n0 + cu * 4;
      const int r = r0 + ru * 4;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(qw + (size_t)(r + i) * N + n);
      }
      const uint32_t zl =
          *reinterpret_cast<const uint32_t*>(zr + (size_t)glo * N + n);
      const uint32_t sl =
          *reinterpret_cast<const uint32_t*>(s2 + (size_t)glo * N + n);
      const uint32_t zh =
          *reinterpret_cast<const uint32_t*>(zr + (size_t)ghi * N + n);
      const uint32_t sh =
          *reinterpret_cast<const uint32_t*>(s2 + (size_t)ghi * N + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int z_lo = (int)(int8_t)(zl >> (8 * j));
        const int s_lo = (int)(int8_t)(sl >> (8 * j));
        const int z_hi = (int)(int8_t)(zh >> (8 * j));
        const int s_hi = (int)(int8_t)(sh >> (8 * j));
        uint32_t plo = 0u, phi = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = (int)((w[i] >> (8 * j)) & 0xFFu);
          const int lo = ((b & 0xF) - z_lo) * s_lo;
          const int hi = ((b >> 4) - z_hi) * s_hi;
          plo |= ((uint32_t)lo & 0xFFu) << (8 * i);
          phi |= ((uint32_t)hi & 0xFFu) << (8 * i);
        }
        *reinterpret_cast<uint32_t*>(&sm.B[0][cu * 4 + j][ru * 4]) = plo;
        *reinterpret_cast<uint32_t*>(&sm.B[1][cu * 4 + j][ru * 4]) = phi;
      }
    }
  }

  // acc += sm.A[h] . sm.B[h] over the staged step's KP k-values of half h.
  static __device__ __forceinline__ void mma_half(Acc& acc, const Smem& sm,
                                                  int h) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;              // mma groupID
    const int t = lane & 3;               // mma threadID_in_group
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int kc = 0; kc < KP / 32; ++kc) {
      const int k0 = kc * 32 + t * 4;
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int ra = wm * WTM + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra][k0]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra + 8][k0]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra][k0 + 16]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra + 8][k0 + 16]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cb = wn * WTN + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&sm.B[h][cb][k0]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&sm.B[h][cb][k0 + 16]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // acc += xq[rows m0.., K steps s_begin..s_end) . w8[.., n0 .. n0 + BN).
  // qw/s2/zr point at one weight ([K/2, N], [K/128, N], [K/128, N]).
  static __device__ __forceinline__ void mainloop(
      Acc& acc, Smem& sm, const int8_t* __restrict__ xq,
      const uint8_t* __restrict__ qw, const int8_t* __restrict__ s2,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K, int s_begin, int s_end) {
    for (int s = s_begin; s < s_end; ++s) {
      const int r0 = s * KP;
      stage_a(sm, xq, m0, row_lo, row_hi, K, r0);
      stage_b(sm, qw, s2, zr, n0, N, K, r0);
      __syncthreads();
      mma_half(acc, sm, 0);
      mma_half(acc, sm, 1);
      __syncthreads();
    }
  }

  // f(i, j, e, r, c) for every accumulator element acc[i][j][e], with r, c
  // its row and column inside the tile. C fragment: c0,c1 -> row g, cols
  // 2t, 2t+1; c2,c3 -> row g + 8.
  template <class F>
  static __device__ __forceinline__ void for_each_elem(F&& f) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wm = warp / WN;
    const int wn = warp % WN;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f(i, j, e, wm * WTM + i * 16 + g + ((e >> 1) << 3),
            wn * WTN + j * 8 + t * 2 + (e & 1));
        }
      }
    }
  }

  // f(row, col, acc value) for every element of the tile whose row lies
  // in [row_lo, row_hi).
  template <class F>
  static __device__ __forceinline__ void for_each_out(const Acc& acc, int m0,
                                                      int n0, int row_lo,
                                                      int row_hi, F&& f) {
    for_each_elem([&](int i, int j, int e, int r, int c) {
      const int row = m0 + r;
      if (row >= row_lo && row < row_hi) f(row, n0 + c, acc[i][j][e]);
    });
  }
};

}  // namespace w4a8tl
