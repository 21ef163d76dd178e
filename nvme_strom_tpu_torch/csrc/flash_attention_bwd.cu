// flash_attention_bwd.cu — flash attention, backward: the dQ kernel and
// the dK/dV kernel.
//
// Replace the TPU kernels nvme_strom_tpu/ops/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (in `_bwd_pallas`).  Both recompute the
// probabilities tile by tile from the forward's log-sum-exp,
// p = exp(scale·q·k − lse) (exactly 0 where masked), and with
// dp = dO·Vᵀ and delta = Σ_d dO·out − dlse (the autograd function
// computes delta):
//
//   ds = p · (dp − delta) · scale
//   dQ = Σ_k ds · K                 (kernel 1: one block per q tile,
//                                    looping over the k tiles)
//   dV = Σ_q pᵀ · dO, dK = Σ_q dsᵀ · Q
//                                   (kernel 2: one block per k tile,
//                                    looping over the q tiles from the
//                                    causal start k0 / 64)
//
// The split into two kernels is the TPU's: no tile is written by two
// blocks, so there are no atomics and the gradients are bitwise the
// same from run to run.  Inputs bf16 or fp32, arithmetic fp32, each
// gradient rounded once to its input's dtype.
//
// Bound: operations.  dQ does three products per unmasked pair (q·k,
// dO·v, ds·k), dK/dV four (q·k, dO·v, pᵀ·dO, dsᵀ·q): 51.5 and 68.7
// GFLOP at the flagship shape (b 8, h 8, s 2048, d 64, causal), ~0.052
// and ~0.069 ms at the bf16 tensor-core rate.  Like the forward, these
// kernels use fp32 FMAs from shared memory (flash_common.cuh).

#include "flash_common.cuh"

namespace {

using namespace strom_flash;

struct BwdArgs {
  Ten q, k, v, dout, dq, dk, dv;
  const float* lse;    // (b, h, s) contiguous
  const float* delta;  // (b, h, s) contiguous
  int h, s, skv, causal;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile * (D + 1);  // dO
  float* sK = sO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);  // ds
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* k = head_ptr<T>(a.k, b, h);
  const T* v = head_ptr<T>(a.v, b, h);
  load_tile<T, D>(head_ptr<T>(a.q, b, h), a.q.ss, q0, a.s, 1.f, sQ);
  load_tile<T, D>(head_ptr<T>(a.dout, b, h), a.dout.ss, q0, a.s, 1.f, sO);

  const long long row0 = ((long long)b * a.h + h) * a.s;
  float lse[4], delta[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty() + 16 * i;
    lse[i] = r < a.s ? a.lse[row0 + r] : 0.f;
    delta[i] = r < a.s ? a.delta[row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  const int kend = a.causal ? min(a.skv, q0 + kTile) : a.skv;
  const int n_kt = (kend + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k, a.k.ss, k0, a.skv, 1.f, sK);
    load_tile<T, D>(v, a.v.ss, k0, a.skv, 1.f, sV);
    __syncthreads();
    float s[4][4], dp[4][4];
    abt<D>(sQ, sK, s);
    abt<D>(sO, sV, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty() + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx() + 16 * j;
        float sc = s[i][j] * a.scale;
        if (col >= a.skv || (a.causal && col > row)) sc = kNegInf;
        const float p = expf(sc - lse[i]);
        sS[(ty() + 16 * i) * kLd + tx() + 16 * j] =
            p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    __syncthreads();
    pv<D>(sS, sK, acc);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, D>(head_ptr<T>(a.dq, b, h), a.dq.ss, q0, a.s, acc, one);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sO = sQ + kTile * (D + 1);  // dO
  float* sP = sO + kTile * (D + 1);  // pᵀ (k rows, q columns)
  float* sS = sP + kTile * kLd;      // dsᵀ
  float* sL = sS + kTile * kLd;      // lse of the q tile
  float* sD = sL + kTile;            // delta of the q tile
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q = head_ptr<T>(a.q, b, h);
  const T* dout = head_ptr<T>(a.dout, b, h);
  load_tile<T, D>(head_ptr<T>(a.k, b, h), a.k.ss, k0, a.skv, 1.f, sK);
  load_tile<T, D>(head_ptr<T>(a.v, b, h), a.v.ss, k0, a.skv, 1.f, sV);

  const long long row0 = ((long long)b * a.h + h) * a.s;
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int q_start = a.causal ? k0 / kTile : 0;
  const int n_qt = (a.s + kTile - 1) / kTile;
  for (int qt = q_start; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(q, a.q.ss, q0, a.s, 1.f, sQ);
    load_tile<T, D>(dout, a.dout.ss, q0, a.s, 1.f, sO);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      sL[r] = q0 + r < a.s ? a.lse[row0 + q0 + r] : 0.f;
      sD[r] = q0 + r < a.s ? a.delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];  // transposed: [k row][q column]
    abt<D>(sK, sQ, s);
    abt<D>(sV, sO, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty() + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx() + 16 * j;
        const int row = q0 + c;
        float sc = s[i][j] * a.scale;
        if (row >= a.s || (a.causal && key > row)) sc = kNegInf;
        const float p = expf(sc - sL[c]);
        sP[(ty() + 16 * i) * kLd + c] = p;
        sS[(ty() + 16 * i) * kLd + c] = p * (dp[i][j] - sD[c]) * a.scale;
      }
    }
    __syncthreads();
    pv<D>(sP, sO, dv);
    pv<D>(sS, sQ, dk);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, D>(head_ptr<T>(a.dk, b, h), a.dk.ss, k0, a.skv, dk, one);
  store_tile<T, D>(head_ptr<T>(a.dv, b, h), a.dv.ss, k0, a.skv, dv, one);
}

template <typename T, int D>
struct LaunchDq {
  static constexpr int kSmem = (4 * kTile * (D + 1) + kTile * kLd) * 4;
  static cudaError_t run(const BwdArgs& a, int b, cudaStream_t stream) {
    cudaError_t e = allow_smem(flash_dq_kernel<T, D>, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.s + kTile - 1) / kTile, a.h, b);
    flash_dq_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct LaunchDkv {
  static constexpr int kSmem =
      (4 * kTile * (D + 1) + 2 * kTile * kLd + 2 * kTile) * 4;
  static cudaError_t run(const BwdArgs& a, int b, cudaStream_t stream) {
    cudaError_t e = allow_smem(flash_dkv_kernel<T, D>, kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.skv + kTile - 1) / kTile, a.h, b);
    flash_dkv_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  }
};

int check_dims(int b, int h, int s, int skv) {
  if (b <= 0 || h <= 0 || s <= 0 || skv <= 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// ptrs: q, k, v, dout, dq; strides: (sb, sh, ss) of each, in that order.
extern "C" int strom_flash_bwd_dq(void* q, void* k, void* v, void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const long long* strides, int b,
                                  int h, int s, int skv, int d, int dtype,
                                  int causal, float scale, void* stream,
                                  int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (int rc = check_dims(b, h, s, skv)) return rc;
  const Ten none{nullptr, 0, 0, 0};
  BwdArgs a{make_ten(q, strides, 0), make_ten(k, strides, 1),
            make_ten(v, strides, 2), make_ten(dout, strides, 3),
            make_ten(dq, strides, 4), none, none,
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            h, s, skv, causal, scale};
  return (int)dispatch<LaunchDq>(dtype, d, a, b, (cudaStream_t)stream);
}

// ptrs: q, k, v, dout, dk, dv; strides: (sb, sh, ss) of each, in order.
extern "C" int strom_flash_bwd_dkv(void* q, void* k, void* v, void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv,
                                   const long long* strides, int b, int h,
                                   int s, int skv, int d, int dtype,
                                   int causal, float scale, void* stream,
                                   int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (int rc = check_dims(b, h, s, skv)) return rc;
  const Ten none{nullptr, 0, 0, 0};
  BwdArgs a{make_ten(q, strides, 0), make_ten(k, strides, 1),
            make_ten(v, strides, 2), make_ten(dout, strides, 3), none,
            make_ten(dk, strides, 4), make_ten(dv, strides, 5),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            h, s, skv, causal, scale};
  return (int)dispatch<LaunchDkv>(dtype, d, a, b, (cudaStream_t)stream);
}
