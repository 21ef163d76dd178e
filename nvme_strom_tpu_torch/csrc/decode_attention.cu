// decode_attention.cu — one query token per row against a contiguous
// kv-head-width cache.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/decode_attention.py
// `_decode_kernel`: q (b, nh, 1, d) attends to k/v (b, nkv, S, d) at
// positions [0, pos[b]], the GQA group of nh/nkv query heads handled
// per kv head, fp32 online softmax.  Where the TPU walks every k-block
// of the grid and masks, this kernel stops at pos[b]; what bounds it and
// how the work is laid out is in attn_common.cuh.

#include "attn_common.cuh"

namespace {

using namespace strom_attn;

template <typename T, int D>
struct DenseRows {
  const T* k;  // this (row, kv head)'s (S, D) slab
  const T* v;
  __device__ __forceinline__ bool operator()(int key, const T*& kr,
                                             const T*& vr) const {
    kr = k + (size_t)key * D;
    vr = v + (size_t)key * D;
    return true;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ pos, T* __restrict__ out,
                        int nkv, int S, float scale) {
  const int bh = blockIdx.x;  // b * nkv + kv head
  const int b = bh / nkv;
  const int last = min(pos[b], S - 1);
  const size_t slab = (size_t)bh * S * D;
  const DenseRows<T, D> rows{k + slab, v + slab};
  attend<T, D, G>(q + (size_t)bh * G * D, last, scale, rows,
                  out + (size_t)bh * G * D);
}

template <typename T, int D, int G>
struct Launch {
  static void run(const void* q, const void* k, const void* v,
                  const int32_t* pos, void* out, int b, int nkv, int S,
                  float scale, cudaStream_t stream) {
    decode_attention_kernel<T, D, G><<<b * nkv, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos, static_cast<T*>(out), nkv, S, scale);
  }
};

}  // namespace

extern "C" int strom_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, int b, int nkv, int g,
                                      int S, int d, int dtype, float scale,
                                      void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (b <= 0 || nkv <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(dtype, d, g, q, k, v,
                               static_cast<const int32_t*>(pos), out, b,
                               nkv, S, scale, (cudaStream_t)stream);
}
