// paged_attention.cu — one query token per row against a shared pool of
// fixed-size KV blocks named by a per-row block table.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/paged_attention.py
// `_paged_kernel`: the same fused decode as decode_attention.cu, but key
// j of row b lives in pool block table[b, j / block_k] at row
// j % block_k.  The TPU prefetches the table as scalars and walks all
// max_blocks of every row; here each block reads its own table entries
// and stops at the row's live length ceil((pos+1)/block_k), so padding
// entries (which may point anywhere) are never dereferenced.  An entry
// outside the pool is skipped rather than read.  Bound and layout: see
// attn_common.cuh.

#include "attn_common.cuh"

namespace {

using namespace strom_attn;

template <typename T, int D>
struct PagedRows {
  const T* k_pool;  // (n_pool, nkv, block_k, D)
  const T* v_pool;
  const int32_t* table;  // this row's max_blocks entries
  int head, nkv, block_k, n_pool;
  __device__ __forceinline__ bool operator()(int key, const T*& kr,
                                             const T*& vr) const {
    const int blk = table[key / block_k];
    if (blk < 0 || blk >= n_pool) return false;
    const size_t row =
        (((size_t)blk * nkv + head) * block_k + key % block_k) * D;
    kr = k_pool + row;
    vr = v_pool + row;
    return true;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ pos, T* __restrict__ out,
                       int nkv, int n_pool, int block_k, int max_blocks,
                       float scale) {
  const int bh = blockIdx.x;  // b * nkv + kv head
  const int b = bh / nkv;
  const int last = min(pos[b], max_blocks * block_k - 1);
  const PagedRows<T, D> rows{k_pool, v_pool, table + (size_t)b * max_blocks,
                             bh % nkv, nkv, block_k, n_pool};
  attend<T, D, G>(q + (size_t)bh * G * D, last, scale, rows,
                  out + (size_t)bh * G * D);
}

template <typename T, int D, int G>
struct Launch {
  static void run(const void* q, const void* k_pool, const void* v_pool,
                  const int32_t* table, const int32_t* pos, void* out,
                  int b, int nkv, int n_pool, int block_k, int max_blocks,
                  float scale, cudaStream_t stream) {
    paged_attention_kernel<T, D, G><<<b * nkv, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), table, pos, static_cast<T*>(out),
        nkv, n_pool, block_k, max_blocks, scale);
  }
};

}  // namespace

extern "C" int strom_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* pos, void* out, int b,
                                     int nkv, int g, int n_pool, int block_k,
                                     int max_blocks, int d, int dtype,
                                     float scale, void* stream,
                                     int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (b <= 0 || nkv <= 0 || block_k <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(dtype, d, g, q, k_pool, v_pool,
                               static_cast<const int32_t*>(table),
                               static_cast<const int32_t*>(pos), out, b, nkv,
                               n_pool, block_k, max_blocks, scale,
                               (cudaStream_t)stream);
}
