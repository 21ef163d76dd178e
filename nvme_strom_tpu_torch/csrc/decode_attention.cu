// decode_attention.cu — one query token per row against a contiguous
// kv-head-width cache, split-K.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/decode_attention.py
// `_decode_kernel`: q (b, nh, 1, d) attends to k/v (b, nkv, S, d) at
// positions [0, pos[b]], the GQA group of nh/nkv query heads handled
// per kv head, fp32 online softmax.  Where the TPU walks every k-block
// of the grid and masks, the splits past pos[b] exit without reading;
// what bounds the kernel and how the split and the combine lay out the
// work is in attn_common.cuh.

#include "attn_common.cuh"

namespace {

using namespace strom_attn;

template <typename T>
struct DenseRows {
  const T* k;  // this (row, kv head)'s (S, d) slab
  const T* v;
  int d;
  __device__ __forceinline__ void prepare(int, int) const {}
  __device__ __forceinline__ bool operator()(int key, const T*& kr,
                                             const T*& vr) const {
    kr = k + (size_t)key * d;
    vr = v + (size_t)key * d;
    return true;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split(SplitArgs a, const T* __restrict__ k, const T* __restrict__ v) {
  const size_t slab = (size_t)blockIdx.y * a.capacity * a.d;
  DenseRows<T> rows{k + slab, v + slab, a.d};
  split_attend<T, D, G>(a, rows);
}

// the combine of both paths: workspace rows of `width` floats
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_combine(SplitArgs a, int width) {
  combine_splits<T, G>(a, width);
}

template <typename T, int D, int G>
struct Launch {
  static void run(const SplitArgs& a, int rows, const void* k,
                  const void* v, cudaStream_t stream) {
    decode_split<T, D, G><<<split_grid(a, rows, G), kThreads, 0, stream>>>(
        a, static_cast<const T*>(k), static_cast<const T*>(v));
    if (a.n_splits > 1)
      decode_combine<T, G>
          <<<combine_grid(a, rows, G), kThreads, 0, stream>>>(a, D);
  }
};

// the any-width path (attn_common.cuh), for every other head_dim
template <typename T, int G, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
decode_split_any(SplitArgs a, const T* __restrict__ k,
                 const T* __restrict__ v, int width) {
  const size_t slab = (size_t)blockIdx.y * a.capacity * a.d;
  DenseRows<T> rows{k + slab, v + slab, a.d};
  split_attend_any<T, G, ALIGNED>(a, rows, width);
}

template <typename T, int G, bool ALIGNED>
struct LaunchAny {
  static void run(const SplitArgs& a, int rows, const void* k,
                  const void* v, int width, cudaStream_t stream) {
    decode_split_any<T, G, ALIGNED>
        <<<split_grid(a, rows, G), kThreads, 0, stream>>>(
            a, static_cast<const T*>(k), static_cast<const T*>(v), width);
    if (a.n_splits > 1)
      decode_combine<T, G>
          <<<combine_grid(a, rows, G), kThreads, 0, stream>>>(a, width);
  }
};

}  // namespace

// width, rows_per_chunk: the head width (>= d) and the rows G of a query
// chunk the wrapper picked (ops/decode_attention.py `kernel_shape`): the
// built width D where `built_width(d)`, else the any-width path's
// workspace row; ws: n_splits > 1 ? the workspace : null.
extern "C" int strom_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* ws, int b, int nkv,
                                      int g, int S, int d, int width,
                                      int rows_per_chunk, int split_len,
                                      int dtype, float scale, void* stream,
                                      int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int n_splits = S > 0 && split_len > 0 ? (S - 1) / split_len + 1 : 0;
  if (b <= 0 || nkv <= 0 || g <= 0 || S <= 0 || d <= 0 || d > width ||
      split_len <= 0 || split_len > kMaxSplit ||
      (long long)b * nkv > 65535 ||
      (g + rows_per_chunk - 1) / rows_per_chunk > 65535 ||
      (n_splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{q, out, static_cast<float*>(ws),
                    static_cast<const int32_t*>(pos), nkv, g, d, S,
                    split_len, n_splits, scale};
  if (!built_width(d))
    return (int)dispatch_any<LaunchAny>(dtype, d, rows_per_chunk,
                                        a, b * nkv, k, v, width,
                                        (cudaStream_t)stream);
  return (int)dispatch<Launch>(dtype, width, rows_per_chunk, a, b * nkv, k,
                               v, (cudaStream_t)stream);
}
