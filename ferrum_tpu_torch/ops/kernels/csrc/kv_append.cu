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
//                          cache[blk[i]] = pages[i] (prefill, whole pages,
//                          and the prefix store's block copies), for one
//                          to four (cache, pages) arrays that share blk
//                          (K, V and int8 KV's two scale planes) in one
//                          launch.
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

// The (cache, pages) arrays of a pages launch, by value; vec16: the
// array's pointers and page size are 16-byte multiples.
struct PageArrays {
  uint8_t* cache[kMaxPairs];
  const uint8_t* pages[kMaxPairs];
  long long page_bytes[kMaxPairs];
  int vec16[kMaxPairs];
};

// Page p of array A to block b, the array's fields read by a static
// index.
template <int A>
__device__ __forceinline__ void copy_array_page(const PageArrays& pa,
                                                long long b, int p) {
  const long long page_bytes = pa.page_bytes[A];
  copy_bytes(pa.cache[A] + b * page_bytes,
             pa.pages[A] + (long long)p * page_bytes, page_bytes,
             pa.vec16[A], threadIdx.x, blockDim.x);
}

// Block (p, a) copies page p of array a to its block blk[p]. One copy
// loop per array (the switch): picking the array's fields first and
// running one loop on them made the copy 24% slower (one array, 8192
// pages, H100), a block living for one page only.
__global__ void append_pages_kernel(PageArrays pa,
                                    const int* __restrict__ blk, int B) {
  const int p = blockIdx.x;
  const long long b = (long long)(unsigned)blk[p];
  if (b >= B) return;                      // dropped write (sentinel / pad)
  switch (blockIdx.y) {
    case 0: copy_array_page<0>(pa, b, p); break;
    case 1: copy_array_page<1>(pa, b, p); break;
    case 2: copy_array_page<2>(pa, b, p); break;
    default: copy_array_page<3>(pa, b, p); break;
  }
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

// `arrays` (1 to 4) caches [B, page, F_i] and their pages [p, page, F_i]
// (page_bytes[i] = page * F_i * element size), caches[i] / pages[i] host
// arrays of device pointers; blk int32 [p], shared. Returns
// cudaGetLastError().
extern "C" int ferrum_kv_append_pages(void* const* caches,
                                      const void* const* pages,
                                      const long long* page_bytes,
                                      int arrays, const void* blk, int p,
                                      int B, void* stream) {
  if (arrays < 1 || arrays > kMaxPairs) return (int)cudaErrorInvalidValue;
  if (p <= 0) return 0;
  PageArrays pa{};
  for (int i = 0; i < arrays; ++i) {
    if (page_bytes[i] < 1) return (int)cudaErrorInvalidValue;
    pa.cache[i] = static_cast<uint8_t*>(caches[i]);
    pa.pages[i] = static_cast<const uint8_t*>(pages[i]);
    pa.page_bytes[i] = page_bytes[i];
    pa.vec16[i] = aligned16(caches[i], pages[i], page_bytes[i]);
  }
  append_pages_kernel<<<dim3(p, arrays), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pa, static_cast<const int*>(blk), B);
  return (int)cudaGetLastError();
}
