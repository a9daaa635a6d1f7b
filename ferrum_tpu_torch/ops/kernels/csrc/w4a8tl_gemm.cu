// Two-level w4a8 GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
//   y[m, n] = out_t( f32(sum_k xq[m, k] * w8[k, n]) * xs[m] * chan[n] )
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n],  g(k) = k / 128
//
// q is packed int4 in GLOBAL HALVES (ops/quant.py): byte row r of
// qweight [K/2, N] holds row r in its low nibble and row K/2 + r in its
// high nibble. |xq| <= 127 and |w8| <= 127, so |acc| <= 127*127*K < 2^31
// for K <= 14336: the int32 sums are exact and the result matches the
// plain PyTorch version (ops/kernels/quant_matmul.py) bit for bit.
//
// Replaces two Pallas TPU kernels of ferrum_tpu/ops/pallas/quant_matmul.py:
//   ferrum_w4a8tl_decode  <- _qmm_w4a8tl_mxu_kernel (m <= 64, decode)
//   ferrum_w4a8tl_prefill <- _qmm_w4a8tl_kernel     (m > 64, prefill)
// The TPU tricks are not carried over: the "MXU-assisted unpack" exists
// because Mosaic lacks sub-32-bit shifts, and the m -> 32 padding exists
// for the int8 sublane tile. Here nibbles are unpacked with plain shifts.
//
// What bounds it on the H100: decode (m <= 64) streams the packed weight
// once per call and does ~2m int8 ops per weight, far below the tensor
// cores' 1979 TOP/s, so it is bound by the 3.35 TB/s of HBM. Prefill at
// m >= 256 is bound by the int8 tensor-core rate.
//
// Design (a first, simple kernel; wgmma/TMA/warp specialisation are for
// later): one block owns a BM x BN output tile and walks K in steps of
// KP packed rows (2*KP k-values: KP low-nibble rows and the matching KP
// high-nibble rows). Each step stages the xq tile (16-byte loads) and the
// weight tile dequantized to int8 w8 -- transposed to [n][k] so a B
// fragment is one 32-bit shared load -- in shared memory, then runs
// mma.sync m16n8k32 s8 x s8 -> s32 from it. Rows are padded by 16 bytes
// so fragment loads hit 32 distinct banks. Decode has few output tiles
// per call, so it splits K across blockIdx.z (enough blocks to cover the
// 132 SMs) and reduces the int32 partial sums with integer atomics into
// a workspace -- order-independent, so still exact. The block that
// finishes a tile last (a per-tile arrival counter) applies the epilogue
// from the workspace and leaves the workspace and the counter zeroed, so
// a decode projection is one launch with no memset. The float epilogue
// is f32(acc) * xs[m] * chan[n], in that order, then round-to-nearest-
// even to bf16 (or f32 output).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// Grid: x = N / BN, y = ceil(M / BM), z = K splits (each `steps_per_split`
// steps of KP packed rows). !kSplit (one split): write the output
// directly. kSplit: atomically add the int32 partial sums into ws [M, N]
// (all zero on entry) and count the tile's arrivals in
// counters[y * X + x] (zero on entry); the last arrival writes the output
// and re-zeroes both.
template <int BM, int BN, int KP, int WM, int WN, bool kSplit>
__global__ void __launch_bounds__(WM * WN * 32)
w4a8tl_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const uint8_t* __restrict__ qw,
                   const int8_t* __restrict__ s2,
                   const int8_t* __restrict__ zr,
                   const float* __restrict__ chan, void* __restrict__ out,
                   int* __restrict__ ws, int* __restrict__ counters, int M,
                   int N, int K, int steps_per_split, int out_bf16) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int LDS = KP + kPad;        // bytes per shared row
  constexpr int WTM = BM / WM;          // warp tile
  constexpr int WTN = BN / WN;
  constexpr int MT = WTM / 16;          // m16 tiles per warp
  constexpr int NT = WTN / 8;           // n8 tiles per warp
  static_assert(kGroup % KP == 0, "a K step must stay inside one group");
  static_assert(MT >= 1 && NT >= 1, "warp tile too small");

  // [0] = low-nibble half (k = r), [1] = high-nibble half (k = K/2 + r)
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;              // mma groupID
  const int t = lane & 3;               // mma threadID_in_group
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int K2 = K / 2;
  const int nsteps = K2 / KP;
  const int half_groups = K2 / kGroup;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int s = s_begin; s < s_end; ++s) {
    const int r0 = s * KP;

    // Activation tiles: rows m0.., columns r0.. (low) and K2 + r0.. (high).
    constexpr int kAVec = BM * KP / 16;
#pragma unroll 2
    for (int i = tid; i < 2 * kAVec; i += kThreads) {
      const int h = i / kAVec;
      const int j = i - h * kAVec;
      const int row = j / (KP / 16);
      const int c16 = j - row * (KP / 16);
      const int m = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        v = *reinterpret_cast<const uint4*>(
            xq + (size_t)m * K + (size_t)h * K2 + r0 + c16 * 16);
      }
      *reinterpret_cast<uint4*>(&As[h][row][c16 * 16]) = v;
    }

    // Weight tile: 4 packed rows x 4 columns per unit, dequantized to
    // int8 w8 and written transposed ([n][k], 4 k-values per 32-bit word).
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
      const uint32_t sl = *reinterpret_cast<const uint32_t*>(s2 + (size_t)glo * N + n);
      const uint32_t zh = *reinterpret_cast<const uint32_t*>(zr + (size_t)ghi * N + n);
      const uint32_t sh = *reinterpret_cast<const uint32_t*>(s2 + (size_t)ghi * N + n);
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
        *reinterpret_cast<uint32_t*>(&Bs[0][cu * 4 + j][ru * 4]) = plo;
        *reinterpret_cast<uint32_t*>(&Bs[1][cu * 4 + j][ru * 4]) = phi;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kc = 0; kc < KP / 32; ++kc) {
        const int k0 = kc * 32 + t * 4;
        uint32_t a[MT][4];
        uint32_t b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int ra = wm * WTM + i * 16 + g;
          a[i][0] = *reinterpret_cast<const uint32_t*>(&As[h][ra][k0]);
          a[i][1] = *reinterpret_cast<const uint32_t*>(&As[h][ra + 8][k0]);
          a[i][2] = *reinterpret_cast<const uint32_t*>(&As[h][ra][k0 + 16]);
          a[i][3] = *reinterpret_cast<const uint32_t*>(&As[h][ra + 8][k0 + 16]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cb = wn * WTN + j * 8 + g;
          b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[h][cb][k0]);
          b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[h][cb][k0 + 16]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
    }
    __syncthreads();
  }

  // C fragment: c0,c1 -> row g, cols 2t, 2t+1; c2,c3 -> row g + 8.
#define FOR_EACH_OUT(BODY)                                                   \
  _Pragma("unroll") for (int i = 0; i < MT; ++i) {                           \
    _Pragma("unroll") for (int j = 0; j < NT; ++j) {                         \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) {                        \
        const int row = m0 + wm * WTM + i * 16 + g + ((e >> 1) << 3);        \
        const int col = n0 + wn * WTN + j * 8 + t * 2 + (e & 1);             \
        if (row < M) {                                                       \
          const size_t idx = (size_t)row * N + col;                          \
          BODY;                                                              \
        }                                                                    \
      }                                                                      \
    }                                                                        \
  }
  if constexpr (!kSplit) {
    FOR_EACH_OUT(store_out(out, idx, (float)acc[i][j][e] * xs[row] * chan[col],
                           out_bf16));
  } else {
    FOR_EACH_OUT(atomicAdd(ws + idx, acc[i][j][e]));
    // The tile's last-arriving split takes the full sums back out of ws
    // (atomicExch: read at L2, where the other splits' adds landed, and
    // re-zeroed) and applies the epilogue.
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
      if (last) counters[tile] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    FOR_EACH_OUT(store_out(out, idx,
                           (float)atomicExch(ws + idx, 0) * xs[row] * chan[col],
                           out_bf16));
  }
#undef FOR_EACH_OUT
}

template <int BM, int BN, int KP, int WM, int WN>
void launch_gemm(const void* xq, const void* xs, const void* qw,
                 const void* s2, const void* z, const void* chan, void* out,
                 int* ws, int* counters, int M, int N, int K, int splits,
                 int out_bf16, cudaStream_t stream) {
  const int nsteps = (K / 2) / KP;
  const int per = (nsteps + splits - 1) / splits;
  const int used = (nsteps + per - 1) / per;
  dim3 grid(N / BN, (M + BM - 1) / BM, used);
  auto kernel = used > 1 ? w4a8tl_gemm_kernel<BM, BN, KP, WM, WN, true>
                         : w4a8tl_gemm_kernel<BM, BN, KP, WM, WN, false>;
  kernel<<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), static_cast<const int8_t*>(s2),
      static_cast<const int8_t*>(z), static_cast<const float*>(chan), out,
      ws, counters, M, N, K, per, out_bf16);
}

}  // namespace

// Decode tiles: BN = 64 columns, one group (128 packed rows) per K step,
// BM = 16/32/64 rows by m; split-K over blockIdx.z when splits > 1. Then
// `ws` (int32 [M, N]) and `counters` (int32, one per output tile: N / 64)
// are caller-owned scratch that must be all zero on entry and are all
// zero again on return, so one scratch serves every call on a stream.
// Requires M <= 64, K % 256 == 0, N % 64 == 0. Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_decode(const void* xq, const void* xs,
                                    const void* qw, const void* s2,
                                    const void* z, const void* chan, void* out,
                                    void* ws, void* counters, int M, int N,
                                    int K, int splits, int out_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* wsp = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (M <= 16) {
    launch_gemm<16, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else if (M <= 32) {
    launch_gemm<32, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else if (M <= 64) {
    launch_gemm<64, 64, 128, 1, 4>(xq, xs, qw, s2, z, chan, out, wsp, cnt, M,
                                   N, K, splits, out_bf16, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Prefill tiles: 128 x 128 output per block, 64 packed rows per K step,
// 8 warps each owning a 64 x 32 warp tile. Requires K % 256 == 0 and
// N % 128 == 0; any M. Returns cudaGetLastError().
extern "C" int ferrum_w4a8tl_prefill(const void* xq, const void* xs,
                                     const void* qw, const void* s2,
                                     const void* z, const void* chan,
                                     void* out, int M, int N, int K,
                                     int out_bf16, void* stream) {
  launch_gemm<128, 128, 64, 2, 4>(xq, xs, qw, s2, z, chan, out, nullptr,
                                  nullptr, M, N, K, 1, out_bf16,
                                  static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
