// Shared building blocks of the w4a16 GEMMs for Hopper (sm_90a): one
// block's f32 tile of  acc[m, n] = sum_k x[m, k] * w[k, n]  with bf16 x and
//   w[k, n] = bf16( bf16(q[k, n] - zeros[g(k), n]) * bf16(scales[g(k), n]) ),
// g(k) = k / 128, exactly the TPU kernel's dequant (_qmm_kernel and
// _qgmm_kernel: (q - z) cast to bf16, times the scale cast to bf16, the
// product rounded to bf16). (q - z) has 5 bits and a bf16 scale 8, so the
// f32 product is exact and rounds once, to nearest even.
//
// q is packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of qweight
// [K/2, N] holds row r in its low nibble and row K/2 + r in its high
// nibble. Scales are bf16 or f32 (f32 scales are rounded to bf16 first,
// as the TPU kernel casts them).
//
// Used by w4a16_gemm.cu (dense projections and MoE expert stacks); each
// kernel writes or reduces the tile itself.
//
// The block owns a BM x BN output tile and walks K in steps of KP packed
// rows (2*KP k-values: KP low-nibble rows and the matching KP high-nibble
// rows). Each step stages the x tile (16-byte loads; rows outside
// [row_lo, row_hi) are zero) and the dequantized weight tile --
// transposed to [n][k] so a B fragment is one 32-bit shared load -- in
// shared memory, then runs mma.sync m16n8k16 bf16 x bf16 -> f32 from it.
// Rows are padded by 16 bytes so fragment loads hit 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace w4a16 {

constexpr int kGroup = 128;
constexpr int kPad = 8;  // bf16 elements (16 bytes) of padding per row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// scales[idx] as the bf16 value the TPU kernel multiplies by, in f32.
template <bool kF32>
__device__ __forceinline__ float bf16_scale(const void* s, size_t idx) {
  if constexpr (kF32) {
    return __bfloat162float(
        __float2bfloat16_rn(static_cast<const float*>(s)[idx]));
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(s)[idx]);
  }
}

__device__ __forceinline__ uint32_t dequant_pair(int q0, int q1, int z,
                                                 float s) {
  const __nv_bfloat16 lo = __float2bfloat16_rn((float)(q0 - z) * s);
  const __nv_bfloat16 hi = __float2bfloat16_rn((float)(q1 - z) * s);
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int BM, int BN, int KP, int WM, int WN, bool kF32>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDS = KP + kPad;  // bf16 per shared row
  static constexpr int WTM = BM / WM;    // warp tile
  static constexpr int WTN = BN / WN;
  static constexpr int MT = WTM / 16;    // m16 tiles per warp
  static constexpr int NT = WTN / 8;     // n8 tiles per warp
  static_assert(kGroup % KP == 0, "a K step must stay inside one group");
  static_assert(KP % 16 == 0, "a K step holds whole mma k16 slices");
  static_assert(MT >= 1 && NT >= 1, "warp tile too small");

  // [0] = low-nibble half (k = r), [1] = high-nibble half (k = K/2 + r)
  struct Smem {
    __nv_bfloat16 A[2][BM][LDS];
    __nv_bfloat16 B[2][BN][LDS];
  };
  using Acc = float[MT][NT][4];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // acc += x[rows m0.., K steps s_begin..s_end) . w[.., n0 .. n0 + BN).
  // x is row-major bf16 [*, K]; rows outside [row_lo, row_hi) read as
  // zero. qw/sc/zr point at one weight ([K/2, N], [K/128, N] x2).
  static __device__ __forceinline__ void mainloop(
      Acc& acc, Smem& sm, const __nv_bfloat16* __restrict__ x,
      const uint8_t* __restrict__ qw, const void* __restrict__ sc,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K, int s_begin, int s_end) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;              // mma groupID
    const int t = lane & 3;               // mma threadID_in_group
    const int wm = warp / WN;
    const int wn = warp % WN;
    const int K2 = K / 2;
    const int half_groups = K2 / kGroup;

    for (int s = s_begin; s < s_end; ++s) {
      const int r0 = s * KP;

      // Activation tiles: rows m0.., columns r0.. (low) and K2 + r0.. (high).
      constexpr int kAVec = BM * KP / 8;
#pragma unroll 2
      for (int i = tid; i < 2 * kAVec; i += kThreads) {
        const int h = i / kAVec;
        const int j = i - h * kAVec;
        const int row = j / (KP / 8);
        const int c8 = j - row * (KP / 8);
        const int m = m0 + row;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m >= row_lo && m < row_hi) {
          v = *reinterpret_cast<const uint4*>(
              x + (size_t)m * K + (size_t)h * K2 + r0 + c8 * 8);
        }
        *reinterpret_cast<uint4*>(&sm.A[h][row][c8 * 8]) = v;
      }

      // Weight tile: 4 packed rows x 4 columns per unit, dequantized to
      // bf16 and written transposed ([n][k], 4 k-values per 8 bytes).
      const int glo = r0 / kGroup;
      const int ghi = half_groups + glo;
      constexpr int kUnits = (KP / 4) * (BN / 4);
#pragma unroll 2
      for (int u = tid; u < kUnits; u += kThreads) {
        const int cu = u % (BN / 4);
        const int ru = u / (BN / 4);
        const int n = n0 + cu * 4;
        const int r = r0 + ru * 4;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = *reinterpret_cast<const uint32_t*>(qw + (size_t)(r + i) * N + n);
        }
        const uint32_t zl = *reinterpret_cast<const uint32_t*>(zr + (size_t)glo * N + n);
        const uint32_t zh = *reinterpret_cast<const uint32_t*>(zr + (size_t)ghi * N + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int z_lo = (int)(int8_t)(zl >> (8 * j));
          const int z_hi = (int)(int8_t)(zh >> (8 * j));
          const float s_lo = bf16_scale<kF32>(sc, (size_t)glo * N + n + j);
          const float s_hi = bf16_scale<kF32>(sc, (size_t)ghi * N + n + j);
          int b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) b[i] = (int)((w[i] >> (8 * j)) & 0xFFu);
          uint2 plo, phi;
          plo.x = dequant_pair(b[0] & 0xF, b[1] & 0xF, z_lo, s_lo);
          plo.y = dequant_pair(b[2] & 0xF, b[3] & 0xF, z_lo, s_lo);
          phi.x = dequant_pair(b[0] >> 4, b[1] >> 4, z_hi, s_hi);
          phi.y = dequant_pair(b[2] >> 4, b[3] >> 4, z_hi, s_hi);
          *reinterpret_cast<uint2*>(&sm.B[0][cu * 4 + j][ru * 4]) = plo;
          *reinterpret_cast<uint2*>(&sm.B[1][cu * 4 + j][ru * 4]) = phi;
        }
      }
      __syncthreads();

#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kc = 0; kc < KP / 16; ++kc) {
          const int k0 = kc * 16 + t * 2;
          uint32_t a[MT][4];
          uint32_t b[NT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int ra = wm * WTM + i * 16 + g;
            a[i][0] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra][k0]);
            a[i][1] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra + 8][k0]);
            a[i][2] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra][k0 + 8]);
            a[i][3] = *reinterpret_cast<const uint32_t*>(&sm.A[h][ra + 8][k0 + 8]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int cb = wn * WTN + j * 8 + g;
            b[j][0] = *reinterpret_cast<const uint32_t*>(&sm.B[h][cb][k0]);
            b[j][1] = *reinterpret_cast<const uint32_t*>(&sm.B[h][cb][k0 + 8]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
        }
      }
      __syncthreads();
    }
  }

  // f(row, col, acc value) for every element of the tile whose row lies
  // in [row_lo, row_hi). C fragment: c0,c1 -> row g, cols 2t, 2t+1;
  // c2,c3 -> row g + 8.
  template <class F>
  static __device__ __forceinline__ void for_each_out(const Acc& acc, int m0,
                                                      int n0, int row_lo,
                                                      int row_hi, F&& f) {
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
          const int row = m0 + wm * WTM + i * 16 + g + ((e >> 1) << 3);
          const int col = n0 + wn * WTN + j * 8 + t * 2 + (e & 1);
          if (row >= row_lo && row < row_hi) f(row, col, acc[i][j][e]);
        }
      }
    }
  }
};

}  // namespace w4a16
