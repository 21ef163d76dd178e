// flash_common.cuh — what the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) share: the (b, h,
// seq, D) views, the dtype dispatch, and the fp32 FMA tiles.
//
// Which kernel takes which inputs (`tensor_cores` below): bf16 inputs
// run the forward, the dQ and the dK/dV kernel on the tensor cores
// (wgmma with TMA loads, hopper.cuh); fp32 and fp16 inputs run the FMA
// kernels built from the tiles here (no model the repo ships trains in
// fp16, so it has no tensor-core path).
//
// FMA tiles: every kernel works on 64-row tiles of one (batch, head): a
// tile of Q, K, V or dO rows is loaded from device memory once,
// converted to fp32 and kept in shared memory with a row stride of D+1
// floats.  The odd stride puts row r, column c in bank (r + c) mod 32,
// so the products below read shared memory without bank conflicts.
//
// A block has 256 threads laid out 16 x 16: thread (ty, tx) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j of every 64 x 64 score tile
// and of every 64 x D output tile, so the 16 threads sharing a row are
// one half-warp and reduce over the row with four shuffles.  All sums
// are fp32 FMAs.
//
// Tensors are (b, h, seq, D) views with unit stride along D and any
// other strides (multiples of 16 bytes), so the kernels read the
// projection layout (b, seq, h, D) in place.
#pragma once

#include <type_traits>

#include "attn_common.cuh"

namespace strom_flash {

using strom_attn::kNegInf;
using strom_attn::load8;
using strom_attn::store;

constexpr int kTile = 64;       // rows of a Q tile and of a K tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kTile + 1;  // row stride of a 64 x 64 score tile

// The three kernels, in the order of strom_flash_route's argument.
constexpr int kFwd = 0, kDq = 1, kDkv = 2;

// True where `kernel` runs on the tensor cores for inputs of type T.
template <typename T>
constexpr bool tensor_cores(int kernel) {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Dynamic shared memory rounded up to the 1024 bytes that a 128-byte
// swizzled TMA tile needs (the kernels ask for 1024 bytes more).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024 - (a & 1023)) & 1023);
}

// A (b, h, seq, D) tensor: base pointer and element strides of b, h and
// seq (D is contiguous).
struct Ten {
  void* p;
  long long sb, sh, ss;
};

template <typename T>
__device__ __forceinline__ T* head_ptr(const Ten& t, int b, int h) {
  return static_cast<T*>(t.p) + (long long)b * t.sb + (long long)h * t.sh;
}

__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tx() { return threadIdx.x & 15; }

// Rows [r0, r0 + 64) of one head into shared memory (64 x (D+1) fp32),
// multiplied by `mul`; rows at or past n read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, long long ss,
                                          int r0, int n, float mul,
                                          float* sm) {
  constexpr int C = D / 8;
  for (int idx = threadIdx.x; idx < kTile * C; idx += kThreads) {
    const int r = idx / C;
    const int c = (idx % C) * 8;
    float v[8];
    if (r0 + r < n) {
      load8(base + (long long)(r0 + r) * ss + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    float* dst = sm + r * (D + 1) + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = v[j] * mul;
  }
}

// c[i][j] = A[ty + 16 i] . B[tx + 16 j] over D for two row tiles A, B
// (64 x (D+1) each): one 64 x 64 product A Bᵀ, 16 entries a thread.
template <int D>
__device__ __forceinline__ void abt(const float* A, const float* B,
                                    float (&c)[4][4]) {
  const float* a0 = A + ty() * (D + 1);
  const float* b0 = B + tx() * (D + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[16 * i * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b0[16 * j * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * V[k][tx + 16 j] for a 64 x 64
// tile P (row stride kLd) and a row tile V (64 x (D+1)).
template <int D>
__device__ __forceinline__ void pv(const float* P, const float* V,
                                   float (&acc)[4][D / 16]) {
  const float* p0 = P + ty() * kLd;
  const float* v0 = V + tx();
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float p[4], v[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = p0[16 * i * kLd + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) v[j] = v0[k * (D + 1) + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
  }
}

// Reductions over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [r0, r0 + 64) of an output tile acc (rows ty + 16 i, columns
// tx + 16 j) times `mul[i]`, rows at or past n skipped.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* base, long long ss, int r0,
                                           int n, const float (&acc)[4][D / 16],
                                           const float (&mul)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty() + 16 * i;
    if (r >= n) continue;
    T* row = base + (long long)r * ss + tx();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) store(row + 16 * j, acc[i][j] * mul[i]);
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Instantiate `Body<T, D>::run(args...)` for the (dtype, d) asked for;
// cudaErrorInvalidValue for anything else.
template <template <typename, int> class Body, typename... Args>
cudaError_t dispatch(int dtype, int d, Args... args) {
  if (dtype == strom_attn::kBF16 && d == 64)
    return Body<__nv_bfloat16, 64>::run(args...);
  if (dtype == strom_attn::kBF16 && d == 128)
    return Body<__nv_bfloat16, 128>::run(args...);
  if (dtype == strom_attn::kF32 && d == 64) return Body<float, 64>::run(args...);
  if (dtype == strom_attn::kF32 && d == 128)
    return Body<float, 128>::run(args...);
  if (dtype == strom_attn::kF16 && d == 64)
    return Body<__half, 64>::run(args...);
  if (dtype == strom_attn::kF16 && d == 128)
    return Body<__half, 128>::run(args...);
  return cudaErrorInvalidValue;
}

// The 4-D views of the C entry points: `strides` holds (sb, sh, ss) of
// each tensor in the order of `ptrs`.
inline Ten make_ten(void* p, const long long* strides, int i) {
  return Ten{p, strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace strom_flash
