// Shared building blocks of the two-level w4a8 GEMMs for Hopper (sm_90a):
// one block's int32 tile of  acc[m, n] = sum_k xq[m, k] * w8[k, n],
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128,
// with q packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of
// qweight [K/2, N] holds row r in its low nibble and row K/2 + r in its
// high nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31
// for K <= 14336: the int32 sums are exact.
//
// The streamed decode loop (w4a8tl_stream.cuh: both dense decode forms,
// the float-scale form, the all-experts bmm and the decode-sized grouped
// GEMM) takes from here its int32 accumulator layout -- an m16n8k32
// mma.sync fragment grid over a BM x BN tile cut into WM x WN warp tiles
// -- and mma_s8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8tl {

constexpr int kGroup = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int KP, int WM, int WN>
struct Tile {
  static constexpr int WTM = BM / WM;    // warp tile
  static constexpr int WTN = BN / WN;
  static constexpr int MT = WTM / 16;    // m16 tiles per warp
  static constexpr int NT = WTN / 8;     // n8 tiles per warp
  static_assert(kGroup % KP == 0, "a K step must stay inside one group");
  static_assert(MT >= 1 && NT >= 1, "warp tile too small");

  using Acc = int[MT][NT][4];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
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
};

}  // namespace w4a8tl
