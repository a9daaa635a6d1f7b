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
//                          (decode: one row per (layer, slot)), for one to
//                          four (cache, rows) pairs that share blk and off
//                          (K and V; int8 KV's two scale planes would be
//                          two more) in one launch.
//   ferrum_kv_append_pages replaces kv_append.py kv_append_pages:
//                          cache[blk[i]] = pages[i] (prefill, whole pages).
//
// What bounds them on the H100: pure data movement -- each valid row/page
// is read once and written once, so HBM bandwidth (3.35 TB/s). The TPU
// kernels read-modify-write the whole target page because Mosaic has no
// dynamic sublane store; here a row is written directly. A decode step's
// rows are few MB (1024 rows x 2 KiB for K and again for V at the 8B
// shapes: a bound of ~2.5 us), so the rows kernel is bound by latency:
// the launch, and how many bytes are in flight at once. Design: one
// launch for every pair; each thread takes kRowChunks 16-byte chunks of
// one (pair, row), strided by the row's threads so a warp's loads are
// contiguous, reads the row's ids once, and issues all its loads before
// its first store; the grid spreads (pair, row, chunk) over enough
// blocks to fill the card. Bytes instead of 16-byte chunks where a
// pointer or row size is not a multiple of 16. Pages: one block per page
// with 16-byte vector copies when the page size allows, bytes otherwise.
// (block, offset) pairs are unique within one call, so the writes never
// race.

#include <cuda_runtime.h>
#include <limits.h>
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

// The (cache, rows) pairs of a rows launch, by value. units: 16-byte
// chunks (or bytes) a row; tpr: threads a row, ceil(units / kRowChunks);
// first: the pair's first thread; total: the launch's threads.
constexpr int kMaxPairs = 4;
constexpr int kRowChunks = 4;

struct RowPairs {
  uint8_t* cache[kMaxPairs];
  const uint8_t* rows[kMaxPairs];
  int units[kMaxPairs];
  int tpr[kMaxPairs];
  int first[kMaxPairs];
  int pairs, total;
};

// Thread g copies units slot, slot + tpr, .. (kRowChunks of them) of row
// `row` of its pair, V a 16-byte chunk or a byte.
template <typename V>
__global__ void append_rows_kernel(RowPairs rp, const int* __restrict__ blk,
                                   const int* __restrict__ off, int B,
                                   int page) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rp.total) return;
  // The pair, by static indices only (the parameters stay in the
  // constant bank).
  uint8_t* cache = rp.cache[0];
  const uint8_t* rows = rp.rows[0];
  int units = rp.units[0], tpr = rp.tpr[0], first = 0;
#pragma unroll
  for (int i = 1; i < kMaxPairs; ++i) {
    if (i < rp.pairs && g >= rp.first[i]) {
      cache = rp.cache[i];
      rows = rp.rows[i];
      units = rp.units[i];
      tpr = rp.tpr[i];
      first = rp.first[i];
    }
  }
  const int row = (g - first) / tpr;
  const int slot = g - first - row * tpr;
  const long long b = (long long)(unsigned)blk[row];
  if (b >= B) return;                      // dropped write (sentinel / pad)
  const long long flat = b * page + off[row];
  if (flat < 0 || flat >= (long long)B * page) return;
  const V* src = reinterpret_cast<const V*>(rows) + (long long)row * units;
  V* dst = reinterpret_cast<V*>(cache) + flat * units;
  V v[kRowChunks];
#pragma unroll
  for (int i = 0; i < kRowChunks; ++i) {
    const int u = slot + i * tpr;
    if (u < units) v[i] = src[u];
  }
#pragma unroll
  for (int i = 0; i < kRowChunks; ++i) {
    const int u = slot + i * tpr;
    if (u < units) dst[u] = v[i];
  }
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

// `pairs` (1 to 4) caches [B, page, F_i] and their rows [n, F_i]
// (row_bytes[i] = F_i * element size), caches[i] / rows[i] host arrays of
// device pointers; blk/off int32 [n], shared. Returns cudaGetLastError().
extern "C" int ferrum_kv_append_rows(void* const* caches,
                                     const void* const* rows,
                                     const long long* row_bytes, int pairs,
                                     const void* blk, const void* off, int n,
                                     int B, int page, void* stream) {
  if (pairs < 1 || pairs > kMaxPairs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int vec16 = 1;
  for (int i = 0; i < pairs; ++i) {
    vec16 &= aligned16(caches[i], rows[i], row_bytes[i]);
  }
  RowPairs rp{};
  long long total = 0;
  for (int i = 0; i < pairs; ++i) {
    const long long units = vec16 ? row_bytes[i] >> 4 : row_bytes[i];
    const long long tpr = (units + kRowChunks - 1) / kRowChunks;
    if (units < 1 || units > INT_MAX) return (int)cudaErrorInvalidValue;
    rp.cache[i] = static_cast<uint8_t*>(caches[i]);
    rp.rows[i] = static_cast<const uint8_t*>(rows[i]);
    rp.units[i] = (int)units;
    rp.tpr[i] = (int)tpr;
    rp.first[i] = (int)total;
    total += n * tpr;
    if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  rp.pairs = pairs;
  rp.total = (int)total;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec16) {
    append_rows_kernel<uint4><<<blocks, threads, 0, st>>>(
        rp, static_cast<const int*>(blk), static_cast<const int*>(off), B,
        page);
  } else {
    append_rows_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        rp, static_cast<const int*>(blk), static_cast<const int*>(off), B,
        page);
  }
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
