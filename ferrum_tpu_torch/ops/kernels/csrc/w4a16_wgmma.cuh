// The w4a16 GEMMs' main loop at prefill sizes on Hopper (sm_90a): one
// block's f32 tile of  acc[m, n] = sum_k x[m, k] * w[k, n]  with bf16 x and
//   w[k, n] = bf16( bf16(q[k, n] - zeros[g(k), n]) * bf16(scales[g(k), n]) ),
// g(k) = k / 128, bit for bit the dequant of w4a16_stream.cuh and of the
// TPU kernels it replaces in ferrum_tpu/ops/pallas/quant_matmul.py:
//   :60  _qmm_kernel   dense projections, m > 64   (w4a16_gemm.cu)
//   :970 _qgmm_kernel  rows sorted by expert, 128-row tiles (w4a16_gemm.cu)
//
// What bounds them on the H100: the dense GEMM at m = 2048 does ~220
// flops per weight byte it reads, so the bf16 tensor cores (989 TFLOP/s)
// bound it; the grouped GEMM at 16384 rows over 128 experts gives each
// expert ~128 rows, and its bound is the HBM bytes of the expert stacks
// (3.35 TB/s). Either way every block dequantizes its weight tile, once
// per 128 rows of x, and the loads must overlap the math.
//
// Design:
//  - 256 threads: two warpgroups, each the consumer of 64 of the block's
//    BM = 128 rows; BN = 128 or 256 columns. Every thread also loads and
//    dequantizes: there is no producer warp.
//  - A K step is KP = 32 packed rows: 32 low-nibble rows (k = r0 + i) and
//    the matching 32 high-nibble rows (k = K/2 + r0 + i), 64 k-values.
//    A ring of S >= 3 shared-memory stages, filled by 16-byte cp.async,
//    holds per step the x tile (bf16, K-major, 128 rows of 128 bytes, the
//    hardware's 128-byte swizzle; rows outside [row_lo, row_hi) are
//    zero-filled), the packed weight tile ([KP, BN] bytes, as it lies in
//    the global-halves layout of ops/quant.py) and the step's scale and
//    zero rows of both halves (groups glo and K/256 + glo). Loads for
//    steps s+1 .. s+S-2 are in flight while step s computes.
//  - Dequant in packed bf16x2, exactly the TPU kernels' arithmetic: a
//    nibble OR 0x4300 is bf16(128 + q); minus bf16(128 + z) gives q - z
//    exactly (|q - z| <= 143 < 256); times the bf16 scale rounds once to
//    nearest even, as __float2bfloat16_rn((float)(q - z) * s) does. f32
//    scales are rounded to bf16 when a thread loads a group's row.
//  - The dequantized tile is written to one of two bf16 B buffers,
//    N-contiguous (MN-major, 128-byte swizzle): the packed weight's own
//    orientation, no transpose. wgmma m64nBNk16 bf16 x bf16 -> f32
//    reads both operands from shared memory.
//  - Step s: barrier; wgmma on stage s (async), then wait for step
//    s-1's wgmma only, so the tensor cores always hold a queued step;
//    wait for step s+1's tiles; barrier; issue the loads of step s+S-1
//    into step s-1's slot; dequantize step s+1 into the B buffer step
//    s-1 read, overlapping step s's wgmma.
//    Generic-proxy writes that wgmma reads (the dequant's stores and the
//    cp.async tiles) are each followed by fence.proxy.async before the
//    barrier that precedes the wgmma.
//  - f32 sums in a fixed order: no split-K, no atomics, the same bits
//    from launch to launch.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace w4a16_wgmma {

constexpr int kGroup = 128;
constexpr int kBM = 128;      // two consumer warpgroups of 64 rows
constexpr int kKP = 32;       // packed rows per K step (64 k-values)
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;  // one swizzled line: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma's operand reads) once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are
// pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A block's dynamic shared memory, aligned to the 1024-byte swizzle atom.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

inline int num_sms() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32)
         | (1ull << 62);
}

// d[64xN] += A[64x16] . B[16xN]: A K-major, B MN-major (trans-b 1); N/2
// f32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Columns n, n+1 of packed bytes b0, b1 (in bits 0-7 and 16-23 of t) →
// the two dequantized bf16 of their low (shift 0) or high (shift 4)
// nibbles: ((128 + q) - (128 + z)) * s.
template <int kShift>
__device__ __forceinline__ uint32_t dequant2(uint32_t t, uint32_t z128,
                                             uint32_t s) {
  const uint32_t q128 = ((t >> kShift) & 0x000F000Fu) | 0x43004300u;
  return bf16x2_mul(bf16x2_sub(q128, z128), s);
}

template <int BN, int S, bool kF32>
struct Mainloop {
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static_assert(S >= 3, "the ring holds the step whose wgmma runs, the "
                        "step dequantized and at least one in flight");
  static constexpr int kScBytes = kF32 ? 4 : 2;
  // Shared memory, every tile 1024-byte aligned (the swizzle atom).
  static constexpr int kBBytes = 64 * BN * 2;    // dequantized, per buffer
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kPBytes = kKP * BN;
  static constexpr int kScRow = BN * kScBytes;
  static constexpr int kStageBytes =
      (kABytes + kPBytes + 2 * kScRow + 2 * BN + 1023) / 1024 * 1024;
  static constexpr int kOffA = 2 * kBBytes;
  // + 1024: the kernel aligns the dynamic shared memory's base itself.
  static constexpr int kSmemBytes = kOffA + S * kStageBytes + 1024;
  // Dequant units: 8 columns of one packed row per unit.
  static constexpr int kChunks = BN / 8;
  static constexpr int kRowStride = kThreads / kChunks;
  static constexpr int kRowsPerThread = kKP / kRowStride;

  using Acc = float[BN / 2];   // m64nBN: BN / 2 f32 a thread

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }

  static __device__ __forceinline__ uint8_t* stage(uint8_t* base, int slot) {
    return base + kOffA + slot * kStageBytes;
  }

  // Issue step s's copies into ring slot `slot`.
  static __device__ __forceinline__ void load(
      uint8_t* base, int slot, int s, const __nv_bfloat16* __restrict__ x,
      const uint8_t* __restrict__ qw, const void* __restrict__ sc,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K) {
    const int tid = threadIdx.x;
    const int K2 = K / 2;
    const int r0 = s * kKP;
    uint8_t* st = stage(base, slot);
    const uint32_t a_s = smem_u32(st);
    // x: 128 rows x 8 chunks; chunks 0-3 the low half's 32 k, 4-7 the
    // high half's, at chunk c ^ (row % 8) of the row's 128-byte line.
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;
      const int c = idx & 7;
      const int m = m0 + row;
      const bool ok = m >= row_lo && m < row_hi;
      const __nv_bfloat16* src =
          ok ? x + (size_t)m * K + (c < 4 ? r0 : K2 + r0 - 32) + c * 8 : x;
      cp_async16(a_s + row * kRowBytes + ((c ^ (row & 7)) << 4), src,
                 ok ? 16 : 0);
    }
    // Packed weight: KP rows of BN bytes.
    const uint32_t p_s = a_s + kABytes;
#pragma unroll
    for (int i = 0; i < kPBytes / 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / (BN / 16);
      const int c = idx % (BN / 16);
      cp_async16(p_s + row * BN + c * 16,
                 qw + (size_t)(r0 + row) * N + n0 + c * 16, 16);
    }
    // Scale rows (glo, ghi), then zero rows.
    const int glo = r0 / kGroup;
    const int ghi = K2 / kGroup + glo;
    const uint32_t sc_s = p_s + kPBytes;
    constexpr int kScChunks = kScRow / 16;
    for (int idx = tid; idx < 2 * kScChunks + 2 * (BN / 16);
         idx += kThreads) {
      if (idx < 2 * kScChunks) {
        const int h = idx / kScChunks;
        const int c = idx % kScChunks;
        const char* src = static_cast<const char*>(sc)
                          + ((size_t)(h ? ghi : glo) * N + n0) * kScBytes
                          + c * 16;
        cp_async16(sc_s + h * kScRow + c * 16, src, 16);
      } else {
        const int j = idx - 2 * kScChunks;
        const int h = j / (BN / 16);
        const int c = j % (BN / 16);
        cp_async16(sc_s + 2 * kScRow + h * BN + c * 16,
                   zr + (size_t)(h ? ghi : glo) * N + n0 + c * 16, 16);
      }
    }
  }

  // This thread's 8 columns' (128 + z) and bf16 scale pairs, both halves,
  // from the staged rows of `slot`.
  static __device__ __forceinline__ void load_group(
      uint8_t* base, int slot, uint32_t (&z128)[2][4], uint32_t (&s2)[2][4]) {
    const int cc = threadIdx.x % kChunks;
    const uint8_t* sc_s = stage(base, slot) + kABytes + kPBytes;
    const int8_t* z_s = reinterpret_cast<const int8_t*>(sc_s + 2 * kScRow);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* zz = z_s + h * BN + cc * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z128[h][j] = bf16x2_bits((float)(128 + zz[2 * j]),
                                 (float)(128 + zz[2 * j + 1]));
        if constexpr (kF32) {
          const float* sf =
              reinterpret_cast<const float*>(sc_s + h * kScRow) + cc * 8;
          s2[h][j] = bf16x2_bits(sf[2 * j], sf[2 * j + 1]);
        } else {
          s2[h][j] = reinterpret_cast<const uint32_t*>(
              sc_s + h * kScRow)[cc * 4 + j];
        }
      }
    }
  }

  // Dequantize the packed tile of `slot` into B buffer `bbuf`: for each
  // of this thread's packed rows r, 8 columns → line k = r (low nibbles)
  // and line k = 32 + r (high nibbles), 16 bytes each.
  static __device__ __forceinline__ void dequant(
      uint8_t* base, int slot, int bbuf, const uint32_t (&z128)[2][4],
      const uint32_t (&s2)[2][4]) {
    const int cc = threadIdx.x % kChunks;
    const int rb = threadIdx.x / kChunks;
    const uint8_t* p_s = stage(base, slot) + kABytes;
    uint8_t* b_s = base + bbuf * kBBytes + (cc >> 3) * 8192;
    const int c = cc & 7;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rb + i * kRowStride;
      const uint2 w = *reinterpret_cast<const uint2*>(p_s + r * BN + cc * 8);
      const uint32_t t[4] = {__byte_perm(w.x, 0, 0x4140),
                             __byte_perm(w.x, 0, 0x4342),
                             __byte_perm(w.y, 0, 0x4140),
                             __byte_perm(w.y, 0, 0x4342)};
      uint4 lo, hi;
      lo.x = dequant2<0>(t[0], z128[0][0], s2[0][0]);
      lo.y = dequant2<0>(t[1], z128[0][1], s2[0][1]);
      lo.z = dequant2<0>(t[2], z128[0][2], s2[0][2]);
      lo.w = dequant2<0>(t[3], z128[0][3], s2[0][3]);
      hi.x = dequant2<4>(t[0], z128[1][0], s2[1][0]);
      hi.y = dequant2<4>(t[1], z128[1][1], s2[1][1]);
      hi.z = dequant2<4>(t[2], z128[1][2], s2[1][2]);
      hi.w = dequant2<4>(t[3], z128[1][3], s2[1][3]);
      // Line k of an atom: (k / 8) * 1024 + (k % 8) * 128, chunk c ^ (k % 8).
      const int kl = r, kh = 32 + r;
      *reinterpret_cast<uint4*>(b_s + (kl >> 3) * 1024 + (kl & 7) * 128
                                + ((c ^ (kl & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(b_s + (kh >> 3) * 1024 + (kh & 7) * 128
                                + ((c ^ (kh & 7)) << 4)) = hi;
    }
  }

  // Four k16 slices of step data: A rows of warpgroup `wg` in `slot`,
  // B buffer `bbuf`.
  static __device__ __forceinline__ void mma(Acc& acc, uint8_t* base,
                                             int slot, int bbuf, int wg) {
    const uint32_t a0 = smem_u32(stage(base, slot)) + wg * 64 * kRowBytes;
    const uint32_t b0 = smem_u32(base + bbuf * kBBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: K-major, 8-row groups 1024 bytes apart, k16 = 32 bytes along
      // the line. B: MN-major, 64-column atoms 8192 bytes apart (LBO),
      // 8-line k groups 1024 bytes apart (SBO), k16 = two groups.
      const uint64_t da = desc_sw128(a0 + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(b0 + kk * 2 * 1024, 8192, 1024);
      if constexpr (BN == 256) {
        wgmma_m64n256k16(acc, da, db);
      } else {
        wgmma_m64n128k16(acc, da, db);
      }
    }
  }

  // acc += x[rows m0 .. m0+128) . w[:, n0 .. n0+BN) over all of K. x is
  // row-major bf16 [*, K]; rows outside [row_lo, row_hi) read as zero.
  // Every warpgroup runs its wgmma, also on a 64-row slice with no row
  // in range: a branch around wgmma makes ptxas serialize every wgmma
  // of the kernel (C7518, "WG.DP in divergent path"). qw/sc/zr point at one weight ([K/2, N], [K/128, N] x2). `base` is
  // the block's dynamic shared memory, 1024-byte aligned.
  static __device__ __forceinline__ void run(
      Acc& acc, uint8_t* base, const __nv_bfloat16* __restrict__ x,
      const uint8_t* __restrict__ qw, const void* __restrict__ sc,
      const int8_t* __restrict__ zr, int m0, int row_lo, int row_hi, int n0,
      int N, int K) {
    const int wg = threadIdx.x / 128;
    const int nsteps = (K / 2) / kKP;
    constexpr int kStepsPerGroup = kGroup / kKP;

#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < nsteps) {
        load(base, st, st, x, qw, sc, zr, m0, row_lo, row_hi, n0, N, K);
      }
      cp_async_commit();
    }
    uint32_t z128[2][4], s2[2][4];
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();
    load_group(base, 0, z128, s2);
    dequant(base, 0, 0, z128, s2);
    fence_proxy_async();

    for (int s = 0; s < nsteps; ++s) {
      __syncthreads();
      fence_operands(acc);
      wgmma_fence();
      mma(acc, base, s % S, s & 1, wg);
      wgmma_commit();
      wgmma_wait<1>();            // step s-1's wgmma done, step s's in flight
      cp_async_wait<S - 3>();     // step s+1's tiles landed
      fence_proxy_async();
      __syncthreads();            // ... for every thread; s-1's reads done
      const int ahead = s + S - 1;
      if (ahead < nsteps) {
        load(base, ahead % S, ahead, x, qw, sc, zr, m0, row_lo, row_hi, n0,
             N, K);
      }
      cp_async_commit();
      const int nx = s + 1;
      if (nx < nsteps) {
        if (nx % kStepsPerGroup == 0) load_group(base, nx % S, z128, s2);
        dequant(base, nx % S, nx & 1, z128, s2);
        fence_proxy_async();
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    cp_async_wait<0>();
  }

  // Store acc as bf16 to out [*, N] for the rows in [row_lo, row_hi).
  // Fragment of m64nN: warp w of the warpgroup holds rows 16w + lane/4
  // (+8), columns 8j + 2 (lane % 4) (+1).
  static __device__ __forceinline__ void store(const Acc& acc,
                                               __nv_bfloat16* out, int m0,
                                               int row_lo, int row_hi, int n0,
                                               int N) {
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int rlo = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = rlo + 8 * e;
        if (row >= row_lo && row < row_hi) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[j * 4 + 2 * e],
                                    acc[j * 4 + 2 * e + 1]);
        }
      }
    }
  }
};

}  // namespace w4a16_wgmma
