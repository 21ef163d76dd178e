// flash_attention_fwd.cu — tiled flash attention, forward.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/flash_attention.py
// `_fwd_kernel` (in `_fwd`): out = softmax(scale·Q Kᵀ) V over (b, h, s,
// d) tensors, causal or full, with the per-row log-sum-exp
// lse = m + log l that the backward kernels recompute probabilities
// from.  Inputs are bf16 or fp32; every product and the online softmax
// (running max m, denominator l, accumulator) are fp32, as in the TPU
// kernel, and the output is rounded once to the input dtype.
//
// One block per (q tile of 64 rows, head, batch row).  The Q tile is
// loaded once, pre-scaled; the block walks the K/V tiles, staging each
// through shared memory, and stops at the causal bound
// ceil((q0 + 64) / 64) — the TPU kernel's ((qi+1)·bq + bk − 1)//bk —
// or at the last K tile when not causal (K/V may be longer or shorter
// than Q then).  Masked scores are −1e30, so exp(s − m) is exactly 0
// there; rows and keys past the ends of Q and K/V are masked and never
// read.
//
// Bound: operations.  4·d flops per unmasked (query, key) pair; at the
// flagship shape (b 8, h 8, s 2048, d 64, causal) 34.4 GFLOP against
// 67 MB of Q, K, V, out and lse, i.e. ~0.035 ms at the bf16 tensor-core
// rate.  This kernel uses fp32 FMAs from shared memory (flash_common.cuh)
// and cannot reach that; moving the two products to bf16 tensor cores
// (mma, then wgmma with TMA) is the next design.

#include "flash_common.cuh"

namespace {

using namespace strom_flash;

struct FwdArgs {
  Ten q, k, v, out;
  float* lse;  // (b, h, s) contiguous
  int h, s, skv, causal;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* k = head_ptr<T>(a.k, b, h);
  const T* v = head_ptr<T>(a.v, b, h);

  load_tile<T, D>(head_ptr<T>(a.q, b, h), a.q.ss, q0, a.s, a.scale, sQ);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  const int kend = a.causal ? min(a.skv, q0 + kTile) : a.skv;
  const int n_kt = (kend + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done with sK/sV/sP
    load_tile<T, D>(k, a.k.ss, k0, a.skv, 1.f, sK);
    load_tile<T, D>(v, a.v.ss, k0, a.skv, 1.f, sV);
    __syncthreads();
    float s[4][4];
    abt<D>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty() + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx() + 16 * j;
        if (col >= a.skv || (a.causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        sP[(ty() + 16 * i) * kLd + tx() + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    pv<D>(sP, sV, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  store_tile<T, D>(head_ptr<T>(a.out, b, h), a.out.ss, q0, a.s, acc, inv);
  if (tx() == 0) {
    float* lse = a.lse + ((long long)b * a.h + h) * a.s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty() + 16 * i;
      if (r < a.s) lse[r] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
struct Launch {
  static constexpr int kSmem = (3 * kTile * (D + 1) + kTile * kLd) * 4;
  static cudaError_t run(const FwdArgs& a, int b, cudaStream_t stream) {
    cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.s + kTile - 1) / kTile, a.h, b);
    flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

// ptrs: q, k, v, out; strides: (sb, sh, ss) of each, in that order.
extern "C" int strom_flash_fwd(void* q, void* k, void* v, void* out,
                               void* lse, const long long* strides, int b,
                               int h, int s, int skv, int d, int dtype,
                               int causal, float scale, void* stream,
                               int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (b <= 0 || h <= 0 || s <= 0 || skv <= 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{make_ten(q, strides, 0), make_ten(k, strides, 1),
            make_ten(v, strides, 2), make_ten(out, strides, 3),
            static_cast<float*>(lse), h, s, skv, causal, scale};
  return (int)dispatch<Launch>(dtype, d, a, b, (cudaStream_t)stream);
}
