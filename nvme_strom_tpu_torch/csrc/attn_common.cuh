// attn_common.cuh — the fused one-token decode attention shared by the
// dense-cache kernel (decode_attention.cu) and the block-table kernel
// (paged_attention.cu).  The two differ only in where key j's K and V
// rows live, which a small "rows" functor answers.
//
// One thread block per (batch row, kv head): it holds that kv head's G
// query rows (the GQA group, so K/V are read at kv-head width, never
// expanded) and walks the keys 0..last, last = the row's newest
// position.  Keys past `last` are never read, so garbage (NaN) in an
// unfilled cache tail or a padding block cannot reach the output, and
// the walk stops at the row's live length.
//
// Layout of the work: D/8 lanes share one key, each lane holding 8
// elements of the head dimension (one 16-byte bf16 load per K or V
// row), so a warp scores 32/(D/8) keys at once and a block of 4 warps
// keeps 4*32/(D/8) keys in flight.  Each such key group keeps its own
// fp32 online-softmax state (running max m, denominator l, accumulator
// acc) for the G query rows; the groups are merged through shared
// memory at the end.  Scores are q·k with q scaled in fp32, as in the
// TPU kernel; the output is rounded once to the input dtype.
//
// Bound: K+V bytes of the live positions over HBM bandwidth.  At the
// flagship width (b=8, 8 kv heads) only 64 blocks exist for 132 SMs, so
// the kernel cannot reach that bound; split-K over the sequence with a
// combine pass is the design that fills the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace strom_attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// q_rows: the G query rows (G, D) of this (batch row, kv head);
// out: where their (G, D) result goes; rows(j, k, v) sets the K and V
// row pointers of key j and returns false if key j must be skipped.
template <typename T, int D, int G, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q_rows,
                                       int last, float scale,
                                       const Rows& rows,
                                       T* __restrict__ out) {
  constexpr int LPK = D / 8;            // lanes per key
  constexpr int KPW = 32 / LPK;         // keys per warp per trip
  constexpr int GROUPS = kWarps * KPW;  // keys per block per trip
  const int lane = threadIdx.x & 31;
  const int group = (threadIdx.x >> 5) * KPW + lane / LPK;
  const int part = lane % LPK;

  float q[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q_rows + g * D + part * 8, q[g]);
#pragma unroll
    for (int j = 0; j < 8; ++j) q[g][j] *= scale;
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  // block-uniform trip count: every lane takes part in the shuffles
  for (int base = 0; base <= last; base += GROUPS) {
    const int key = base + group;
    const T* krow = nullptr;
    const T* vrow = nullptr;
    const bool valid = key <= last && rows(key, krow, vrow);
    float kf[8];
    if (valid) {
      load8(krow + part * 8, kf);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) kf[j] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(q[g][j], kf[j], d);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[g] = d;
    }
    if (valid) {
      float vf[8];
      load8(vrow + part * 8, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mn = fmaxf(m[g], s[g]);
        const float alpha = expf(m[g] - mn);
        const float p = expf(s[g] - mn);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = acc[g][j] * alpha + p * vf[j];
        m[g] = mn;
      }
    }
  }

  __shared__ float sm_m[GROUPS][G];
  __shared__ float sm_l[GROUPS][G];
  __shared__ float sm_acc[GROUPS][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (part == 0) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sm_acc[group][g][part * 8 + j] = acc[g][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int col = idx % D;
    float mx = kNegInf;
    for (int r = 0; r < GROUPS; ++r) mx = fmaxf(mx, sm_m[r][g]);
    float den = 0.f, num = 0.f;
    for (int r = 0; r < GROUPS; ++r) {
      const float w = expf(sm_m[r][g] - mx);
      den += sm_l[r][g] * w;
      num += sm_acc[r][g][col] * w;
    }
    // no live key (pos < 0): the masked softmax's output is 0
    store(out + idx, den > 0.f ? num / den : 0.f);
  }
}

// dtype codes shared with the Python wrappers
constexpr int kBF16 = 0;
constexpr int kF32 = 1;

// Instantiate `Body<T, D, G>::run(args...)` for the (dtype, d, g) the
// caller asks for; returns cudaErrorInvalidValue for anything else.
template <template <typename, int, int> class Body, typename... Args>
cudaError_t dispatch(int dtype, int d, int g, Args... args) {
#define STROM_ATTN_CASE(T, DD, GG)                 \
  if (d == DD && g == GG) {                        \
    Body<T, DD, GG>::run(args...);                 \
    return cudaGetLastError();                     \
  }
#define STROM_ATTN_GROUPS(T, DD) \
  STROM_ATTN_CASE(T, DD, 1)      \
  STROM_ATTN_CASE(T, DD, 2)      \
  STROM_ATTN_CASE(T, DD, 4)      \
  STROM_ATTN_CASE(T, DD, 8)
  if (dtype == kBF16) {
    STROM_ATTN_GROUPS(__nv_bfloat16, 64)
    STROM_ATTN_GROUPS(__nv_bfloat16, 128)
  } else if (dtype == kF32) {
    STROM_ATTN_GROUPS(float, 64)
    STROM_ATTN_GROUPS(float, 128)
  }
#undef STROM_ATTN_GROUPS
#undef STROM_ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace strom_attn
