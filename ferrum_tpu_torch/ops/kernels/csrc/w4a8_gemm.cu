// Float-scale w4a8 decode GEMM for Hopper (sm_90a), plain C interface for
// ctypes:
//
//   y[m, n] = out_t( acc[m, n] * xs[m] ),
//   acc = sum over K steps kk, in order, of  lo(kk) then hi(kk),
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
// one rounding is the multiply by s. Every multiply and add here is an
// explicit __fmul_rn / __fadd_rn (no FMA contraction), so the kernel
// equals its plain version (ops/kernels/quant_matmul.py::w4a8_plain) and
// an interpret-mode run of the TPU kernel bit for bit. gpt (groups per
// K step) is the TPU wrapper's bkb / 128 (quant_matmul.py::w4a8_step_rows).
//
// What bounds it on the H100: it runs at decode (m <= 64), streaming the
// packed weight once per call for ~2m int8 ops per weight: HBM-bound
// (3.35 TB/s), like the two-level decode GEMM (w4a8tl_gemm.cu).
//
// Design (a first, simple kernel): grid (N / 64, 1, K steps). Each block
// owns 64 columns and one TPU K step (gpt groups of each plane); per group
// it stages xq and (q - z) as int8 in shared memory (w4a8tl_tile.cuh's
// layout) and runs mma.sync m16n8k32 s8 x s8 -> s32 into a fresh int32
// tile per plane, then folds the group's scaled term into the step's two
// f32 plane sums. The steps' plane sums go to a workspace [steps, 2, M, N];
// the block that arrives last at a column tile (a per-tile counter) adds
// them in K-step order, low before high, scales by xs and writes the
// output, then re-zeroes the counter: one launch per call, and the order
// of the sum never depends on which block finished first.

#include "w4a8tl_tile.cuh"

namespace {

using w4a8tl::mma_s8;
using w4a8tl::store_out;

constexpr int kGroup = 128;
constexpr int kBN = 64;                  // columns per block
constexpr int kWN = 4;                   // warps, each 16 columns
constexpr int kLDS = kGroup + w4a8tl::kPad;

template <bool kF32>
__device__ __forceinline__ float scale_f32(const void* s, size_t idx) {
  if constexpr (kF32) {
    return static_cast<const float*>(s)[idx];
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(s)[idx]);
  }
}

template <int BM, bool kF32>
__global__ void __launch_bounds__(kWN * 32)
w4a8_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const uint8_t* __restrict__ qw, const void* __restrict__ sc,
                   const int8_t* __restrict__ zr, void* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int M,
                   int N, int K, int gpt, int out_bf16) {
  constexpr int kThreads = kWN * 32;
  constexpr int MT = BM / 16;
  constexpr int NT = (kBN / kWN) / 8;
  __shared__ __align__(16) int8_t A[2][BM][kLDS];
  __shared__ __align__(16) int8_t B[2][kBN][kLDS];

  const int tid = threadIdx.x;
  const int wn = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int step = blockIdx.z;
  const int K2 = K / 2;
  const int half_groups = K2 / kGroup;

  float part[2][MT][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[h][i][j][e] = 0.f;

  for (int gi = 0; gi < gpt; ++gi) {
    const int glo = step * gpt + gi;     // low-plane group; packed rows too
    const int ghi = half_groups + glo;
    const int r0 = glo * kGroup;

    constexpr int kAVec = BM * kGroup / 16;
#pragma unroll 2
    for (int i = tid; i < 2 * kAVec; i += kThreads) {
      const int h = i / kAVec;
      const int j = i - h * kAVec;
      const int row = j / (kGroup / 16);
      const int c16 = j - row * (kGroup / 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        v = *reinterpret_cast<const uint4*>(
            xq + (size_t)row * K + (size_t)h * K2 + r0 + c16 * 16);
      }
      *reinterpret_cast<uint4*>(&A[h][row][c16 * 16]) = v;
    }

    // (q - z) in [-15, 15] as int8, transposed to [n][k].
    constexpr int kUnits = (kGroup / 4) * (kBN / 4);
#pragma unroll 2
    for (int u = tid; u < kUnits; u += kThreads) {
      const int cu = u % (kBN / 4);
      const int ru = u / (kBN / 4);
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
        uint32_t plo = 0u, phi = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = (int)((w[i] >> (8 * j)) & 0xFFu);
          plo |= ((uint32_t)((b & 0xF) - z_lo) & 0xFFu) << (8 * i);
          phi |= ((uint32_t)((b >> 4) - z_hi) & 0xFFu) << (8 * i);
        }
        *reinterpret_cast<uint32_t*>(&B[0][cu * 4 + j][ru * 4]) = plo;
        *reinterpret_cast<uint32_t*>(&B[1][cu * 4 + j][ru * 4]) = phi;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
      for (int kc = 0; kc < kGroup / 32; ++kc) {
        const int k0 = kc * 32 + t * 4;
        uint32_t a[MT][4];
        uint32_t b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int ra = i * 16 + g;
          a[i][0] = *reinterpret_cast<const uint32_t*>(&A[h][ra][k0]);
          a[i][1] = *reinterpret_cast<const uint32_t*>(&A[h][ra + 8][k0]);
          a[i][2] = *reinterpret_cast<const uint32_t*>(&A[h][ra][k0 + 16]);
          a[i][3] = *reinterpret_cast<const uint32_t*>(&A[h][ra + 8][k0 + 16]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cb = wn * (kBN / kWN) + j * 8 + g;
          b[j][0] = *reinterpret_cast<const uint32_t*>(&B[h][cb][k0]);
          b[j][1] = *reinterpret_cast<const uint32_t*>(&B[h][cb][k0 + 16]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
      // part[h] += s[group, col] * f32(acc), one group at a time.
      const size_t grow = (size_t)(h ? ghi : glo) * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * (kBN / kWN) + j * 8 + t * 2;
        const float s0 = scale_f32<kF32>(sc, grow + col);
        const float s1 = scale_f32<kF32>(sc, grow + col + 1);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float term = __fmul_rn((float)acc[i][j][e], (e & 1) ? s1 : s0);
            part[h][i][j][e] = __fadd_rn(part[h][i][j][e], term);
          }
      }
    }
    __syncthreads();
  }

  // This step's two plane sums -> ws[step][h][row][col], rows < M.
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = i * 16 + g + ((e >> 1) << 3);
          const int col = n0 + wn * (kBN / kWN) + j * 8 + t * 2 + (e & 1);
          if (row < M) {
            ws[((size_t)step * 2 + h) * plane + (size_t)row * N + col] =
                part[h][i][j][e];
          }
        }

  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.z - 1;
    if (last) counters[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int steps = (int)gridDim.z;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i * 16 + g + ((e >> 1) << 3);
        const int col = n0 + wn * (kBN / kWN) + j * 8 + t * 2 + (e & 1);
        if (row >= M) continue;
        const size_t idx = (size_t)row * N + col;
        float acc = 0.f;
        for (int s = 0; s < steps; ++s) {
          acc = __fadd_rn(acc, __ldcg(ws + (size_t)(2 * s) * plane + idx));
          acc = __fadd_rn(acc, __ldcg(ws + (size_t)(2 * s + 1) * plane + idx));
        }
        store_out(out, idx, __fmul_rn(acc, xs[row]), out_bf16);
      }
}

template <int BM, bool kF32>
void launch(const void* xq, const void* xs, const void* qw, const void* sc,
            const void* z, void* out, float* ws, int* counters, int M, int N,
            int K, int gpt, int out_bf16, cudaStream_t st) {
  const int steps = (K / 2) / (gpt * kGroup);
  dim3 grid(N / kBN, 1, steps);
  w4a8_decode_kernel<BM, kF32><<<grid, kWN * 32, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(qw), sc, static_cast<const int8_t*>(z),
      out, ws, counters, M, N, K, gpt, out_bf16);
}

template <bool kF32>
int decode(const void* xq, const void* xs, const void* qw, const void* sc,
           const void* z, void* out, float* ws, int* cnt, int M, int N, int K,
           int gpt, int out_bf16, cudaStream_t st) {
  if (M <= 16) {
    launch<16, kF32>(xq, xs, qw, sc, z, out, ws, cnt, M, N, K, gpt, out_bf16, st);
  } else if (M <= 32) {
    launch<32, kF32>(xq, xs, qw, sc, z, out, ws, cnt, M, N, K, gpt, out_bf16, st);
  } else {
    launch<64, kF32>(xq, xs, qw, sc, z, out, ws, cnt, M, N, K, gpt, out_bf16, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xq int8 [M, K], xs f32 [M], scales bf16 or f32 (scales_f32) [K/128, N],
// out [M, N] bf16 or f32. gpt = groups per K step (the TPU wrapper's
// bkb / 128; (K/2) % (gpt * 128) == 0). `ws` (f32, >= steps * 2 * M * N)
// and `counters` (int32, one per 64-column tile, all zero on entry and on
// return) are caller-owned scratch. Requires 1 <= M <= 64, K % 256 == 0,
// N % 64 == 0. Returns cudaGetLastError().
extern "C" int ferrum_w4a8_decode(const void* xq, const void* xs,
                                  const void* qw, const void* sc,
                                  const void* z, void* out, void* ws,
                                  void* counters, int M, int N, int K,
                                  int gpt, int scales_f32, int out_bf16,
                                  void* stream) {
  if (M < 1 || M > 64 || gpt < 1 || (K / 2) % (gpt * kGroup)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  return scales_f32
      ? decode<true>(xq, xs, qw, sc, z, out, wsp, cnt, M, N, K, gpt, out_bf16, st)
      : decode<false>(xq, xs, qw, sc, z, out, wsp, cnt, M, N, K, gpt, out_bf16, st);
}
