// KV-cache append kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// The cache is a flat [B, page, F] array (ferrum_tpu's layer-merged layout,
// models/llama_family.py) updated IN PLACE. Both kernels are dtype-agnostic
// byte copies (bf16, f32 and int8 caches all go through them), and both
// drop a write whose block id is >= B (the OOB_SENTINEL = 1 << 30 of the
// model code): the block simply skips its store.
//
//   ferrum_kv_append_rows  replaces ferrum_tpu/ops/pallas/kv_append.py
//                          kv_append_rows: cache[blk[i], off[i], :] = rows[i]
//                          (decode: one row per (layer, slot)).
//   ferrum_kv_append_pages replaces kv_append.py kv_append_pages:
//                          cache[blk[i]] = pages[i] (prefill, whole pages).
//
// What bounds them on the H100: pure data movement -- each valid row/page
// is read once and written once, so HBM bandwidth (3.35 TB/s). The TPU
// kernels read-modify-write the whole target page because Mosaic has no
// dynamic sublane store; here a row is written directly. Design: one warp
// per row (decode rows are 2 KiB at the 8B shapes) and one block per page,
// both with 16-byte vector copies when the row/page size allows, bytes
// otherwise. (block, offset) pairs are unique within one call, so the
// writes never race.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src,
                                           long long nbytes, int vec16,
                                           int lane, int stride) {
  if (vec16) {
    const long long nv = nbytes >> 4;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long i = lane; i < nv; i += stride) d[i] = s[i];
  } else {
    for (long long i = lane; i < nbytes; i += stride) dst[i] = src[i];
  }
}

__global__ void append_rows_kernel(uint8_t* __restrict__ cache,
                                   const uint8_t* __restrict__ rows,
                                   const int* __restrict__ blk,
                                   const int* __restrict__ off, int n, int B,
                                   int page, long long row_bytes, int vec16) {
  const int warps_per_block = blockDim.x >> 5;
  const int row = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const long long b = (long long)(unsigned)blk[row];
  if (b >= B) return;                      // dropped write (sentinel / pad)
  const long long flat = b * page + off[row];
  if (flat < 0 || flat >= (long long)B * page) return;
  copy_bytes(cache + flat * row_bytes, rows + (long long)row * row_bytes,
             row_bytes, vec16, lane, 32);
}

__global__ void append_pages_kernel(uint8_t* __restrict__ cache,
                                    const uint8_t* __restrict__ pages,
                                    const int* __restrict__ blk, int B,
                                    long long page_bytes, int vec16) {
  const int p = blockIdx.x;
  const long long b = (long long)(unsigned)blk[p];
  if (b >= B) return;                      // dropped write (sentinel / pad)
  copy_bytes(cache + b * page_bytes, pages + (long long)p * page_bytes,
             page_bytes, vec16, threadIdx.x, blockDim.x);
}

int aligned16(const void* a, const void* b, long long nbytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           (uintptr_t)nbytes) & 15u) == 0;
}

}  // namespace

// cache [B, page, F] (row_bytes = F * element size), rows [n, F],
// blk/off int32 [n]. Returns cudaGetLastError().
extern "C" int ferrum_kv_append_rows(void* cache, const void* rows,
                                     const void* blk, const void* off, int n,
                                     int B, int page, long long row_bytes,
                                     void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int rows_per_block = threads / 32;
  append_rows_kernel<<<(n + rows_per_block - 1) / rows_per_block, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(rows),
      static_cast<const int*>(blk), static_cast<const int*>(off), n, B, page,
      row_bytes, aligned16(cache, rows, row_bytes));
  return (int)cudaGetLastError();
}

// cache [B, page, F], pages [p, page, F] (page_bytes = page * F * element
// size), blk int32 [p]. Returns cudaGetLastError().
extern "C" int ferrum_kv_append_pages(void* cache, const void* pages,
                                      const void* blk, int p, int B,
                                      long long page_bytes, void* stream) {
  if (p <= 0) return 0;
  append_pages_kernel<<<p, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(pages),
      static_cast<const int*>(blk), B, page_bytes,
      aligned16(cache, pages, page_bytes));
  return (int)cudaGetLastError();
}
