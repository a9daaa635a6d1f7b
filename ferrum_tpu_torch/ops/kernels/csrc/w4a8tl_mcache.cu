// Two-level w4a8 prefill GEMM with the dequantized weight shared across
// M-tiles, for Hopper (sm_90a), plain C interface for ctypes. The function
// of w4a8tl_gemm.cu (same exact int32 sums, same epilogue):
//
//   y[m, n] = out_t( f32(sum_k xq[m, k] * w8[k, n]) * xs[m] * chan[n] )
//   w8[k, n] = (q[k, n] - zeros[g(k), n]) * scales2[g(k), n]
//
// bit for bit equal to the plain PyTorch version w4a8tl_plain
// (ops/kernels/quant_matmul.py).
//
// Replaces ferrum_tpu/ops/pallas/quant_matmul.py::_qmm_w4a8tl_mcache_kernel
// (wrapper _quant_matmul_w4a8tl_2d_mcache). Like it, this kernel is wired
// into no route: it is reached only through its wrapper
// (quant_matmul.py::w4a8tl_prefill_mcache), as a schedule option of
// w4a8tl_prefill.
//
// What bounds it on the H100: at prefill m (>= 256) it does 2 * m * K * N
// int8 ops against one read of the packed weight: the int8 tensor-core
// rate (1979 TOP/s dense).
//
// Design: the TPU kernel walks m innermost so the weight prep of a (column
// tile, K step) runs once for every m-tile, carrying a whole-m int32
// accumulator in VMEM. That accumulator would be 1 MiB at m = 2048 and 128
// columns, which no SM holds, so the idea is kept and the shape is not:
// one block owns 128 columns and 256 rows -- two 128-row tiles -- and runs
// w4a8tl_gemm.cu's main loop (w4a8tl_wgmma.cuh) with each consumer
// warpgroup issuing two m64n128 wgmmas per k32 slice on the one w8 tile
// the block dequantized for the K step. So the dequant runs once per 256
// rows, where w4a8tl_prefill's runs once per 128, and each thread holds
// 2 x 64 int32 accumulators.

#include "w4a8tl_wgmma.cuh"

// Requires M >= 1, K % 256 == 0, N % 128 == 0, and xq, qweight, scales2
// and zeros 16-byte aligned. Returns a cudaError_t.
extern "C" int ferrum_w4a8tl_prefill_mcache(const void* xq, const void* xs,
                                            const void* qw, const void* s2,
                                            const void* z, const void* chan,
                                            void* out, int M, int N, int K,
                                            int out_bf16, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  return w4a8tl_wgmma::launch<256, 128>(xq, xs, qw, s2, z, chan, out, M, N,
                                        K, out_bf16,
                                        static_cast<cudaStream_t>(stream));
}
