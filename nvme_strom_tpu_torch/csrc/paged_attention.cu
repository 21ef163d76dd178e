// paged_attention.cu — one query token per row against a shared pool of
// fixed-size KV blocks named by a per-row block table, split-K.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/paged_attention.py
// `_paged_kernel`: the same decode as decode_attention.cu, but key j of
// row b lives in pool block table[b, j / block_k] at row j % block_k.
// The TPU prefetches the table as scalars and walks all max_blocks of
// every row; here each split loads its own table entries into shared
// memory once (the wrapper makes split_len a multiple of block_k, so a
// split covers whole pool blocks) and the splits past the row's live
// length exit without reading the table, so padding entries (which may
// point anywhere) are never dereferenced.  An entry outside the pool is
// skipped rather than read.  Bound and layout: see attn_common.cuh.

#include "attn_common.cuh"

namespace {

using namespace strom_attn;

template <typename T>
struct PagedRows {
  const T* k_pool;  // (n_pool, nkv, block_k, d)
  const T* v_pool;
  const int32_t* table;  // this row's max_blocks entries
  int* entries;          // shared: the split's table entries
  int first;             // table index of entries[0]
  int head, nkv, block_k, n_pool, d;
  int shift;             // log2(block_k) where it is a power of 2, else -1
  __device__ __forceinline__ int entry(int key) const {
    return shift >= 0 ? key >> shift : key / block_k;
  }
  __device__ __forceinline__ void prepare(int k0, int k1) {
    first = entry(k0);
    const int n = entry(k1 - 1) - first + 1;
    for (int i = threadIdx.x; i < n; i += kThreads)
      entries[i] = table[first + i];
    __syncthreads();
  }
  __device__ __forceinline__ bool operator()(int key, const T*& kr,
                                             const T*& vr) const {
    const int e = entry(key);
    const int blk = entries[e - first];
    if (blk < 0 || blk >= n_pool) return false;
    const size_t row =
        (((size_t)blk * nkv + head) * block_k + key - e * block_k) * d;
    kr = k_pool + row;
    vr = v_pool + row;
    return true;
  }
};

// The rows of grid row blockIdx.y (b · nkv + kv head); `entries` holds
// a split's table entries, at most split_len / block_k + 2 of them.
template <typename T>
__device__ __forceinline__ PagedRows<T> paged_rows(
    const SplitArgs& a, const T* k_pool, const T* v_pool,
    const int32_t* table, int* entries, int n_pool, int block_k,
    int max_blocks) {
  const int bh = blockIdx.y;
  const int shift = block_k & (block_k - 1) ? -1 : __ffs(block_k) - 1;
  return PagedRows<T>{k_pool, v_pool,
                      table + (size_t)(bh / a.nkv) * max_blocks, entries, 0,
                      bh % a.nkv, a.nkv, block_k, n_pool, a.d, shift};
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_split(SplitArgs a, const T* __restrict__ k_pool,
            const T* __restrict__ v_pool, const int32_t* __restrict__ table,
            int n_pool, int block_k, int max_blocks) {
  __shared__ int entries[kMaxSplit + 2];
  PagedRows<T> rows = paged_rows(a, k_pool, v_pool, table, entries, n_pool,
                                 block_k, max_blocks);
  split_attend<T, D, G>(a, rows);
}

// the combine of both paths: workspace rows of `width` floats
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_combine(SplitArgs a, int width) {
  combine_splits<T, G>(a, width);
}

// the any-width path (attn_common.cuh), for every other head_dim
template <typename T, int G, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
paged_split_any(SplitArgs a, const T* __restrict__ k_pool,
                const T* __restrict__ v_pool,
                const int32_t* __restrict__ table, int n_pool, int block_k,
                int max_blocks, int width) {
  __shared__ int entries[kMaxSplit + 2];
  PagedRows<T> rows = paged_rows(a, k_pool, v_pool, table, entries, n_pool,
                                 block_k, max_blocks);
  split_attend_any<T, G, ALIGNED>(a, rows, width);
}

template <typename T, int G, bool ALIGNED>
struct LaunchAny {
  static void run(const SplitArgs& a, int rows, const void* k_pool,
                  const void* v_pool, const int32_t* table, int n_pool,
                  int block_k, int max_blocks, int width,
                  cudaStream_t stream) {
    paged_split_any<T, G, ALIGNED>
        <<<split_grid(a, rows, G), kThreads, 0, stream>>>(
            a, static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), table, n_pool, block_k,
            max_blocks, width);
    if (a.n_splits > 1)
      paged_combine<T, G>
          <<<combine_grid(a, rows, G), kThreads, 0, stream>>>(a, width);
  }
};

template <typename T, int D, int G>
struct Launch {
  static void run(const SplitArgs& a, int rows, const void* k_pool,
                  const void* v_pool, const int32_t* table, int n_pool,
                  int block_k, int max_blocks, cudaStream_t stream) {
    paged_split<T, D, G><<<split_grid(a, rows, G), kThreads, 0, stream>>>(
        a, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        table, n_pool, block_k, max_blocks);
    if (a.n_splits > 1)
      paged_combine<T, G>
          <<<combine_grid(a, rows, G), kThreads, 0, stream>>>(a, D);
  }
};

}  // namespace

// width, rows_per_chunk, ws: as strom_decode_attention.
extern "C" int strom_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, void* out, void* ws,
                                     int b, int nkv, int g, int n_pool,
                                     int block_k, int max_blocks, int d,
                                     int width, int rows_per_chunk,
                                     int split_len, int dtype, float scale,
                                     void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long capacity = (long long)max_blocks * block_k;
  const long long n_splits =
      capacity > 0 && split_len > 0 ? (capacity - 1) / split_len + 1 : 0;
  if (b <= 0 || nkv <= 0 || g <= 0 || block_k <= 0 || max_blocks <= 0 ||
      capacity > 0x7fffffff || d <= 0 || d > width ||
      split_len <= 0 || split_len > kMaxSplit ||
      (long long)b * nkv > 65535 ||
      (g + rows_per_chunk - 1) / rows_per_chunk > 65535 ||
      (n_splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{q, out, static_cast<float*>(ws),
                    static_cast<const int32_t*>(pos), nkv, g, d,
                    (int)capacity, split_len, (int)n_splits, scale};
  if (!built_width(d))
    return (int)dispatch_any<LaunchAny>(
        dtype, d, rows_per_chunk, a, b * nkv, k_pool, v_pool,
        static_cast<const int32_t*>(table), n_pool, block_k, max_blocks,
        width, (cudaStream_t)stream);
  return (int)dispatch<Launch>(dtype, width, rows_per_chunk, a, b * nkv,
                               k_pool, v_pool,
                               static_cast<const int32_t*>(table), n_pool,
                               block_k, max_blocks, (cudaStream_t)stream);
}
