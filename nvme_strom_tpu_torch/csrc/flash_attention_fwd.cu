// flash_attention_fwd.cu — tiled flash attention, forward.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/flash_attention.py
// `_fwd_kernel` (in `_fwd`): out = softmax(scale·Q Kᵀ) V over (b, h, s,
// d) tensors, causal or full, with the per-row log-sum-exp
// lse = m + log l that the backward kernels recompute probabilities
// from.  The online softmax (running max m, denominator l, accumulator)
// is fp32, as in the TPU kernel, and the output is rounded once to the
// input dtype.  Causal runs stop at the q tile's diagonal, the TPU
// kernel's ((qi+1)·bq + bk − 1)//bk; non-causal K/V may be longer or
// shorter than Q.  Masked scores are −1e30, so exp(s − m) is exactly 0
// there; rows and keys past the ends of Q and K/V are masked.
//
// Bound: operations.  4·d flops per unmasked (query, key) pair; at the
// flagship shape (b 8, h 8, s 2048, d 64, causal) 34.4 GFLOP against
// 67 MB of Q, K, V, out and lse, i.e. ~0.035 ms at the 989 TFLOP/s of
// the bf16 tensor cores.
//
// bf16 inputs take `flash_fwd_tc`, on the tensor cores (hopper.cuh):
//   * one block per (128 q rows, head, batch row): two consumer
//     warpgroups of 64 q rows each and one producer warp; the q tiles
//     with the longest causal walk are launched first;
//   * the producer loads Q once and K/V tiles of 64 keys through a ring
//     of three stages with TMA (128-byte swizzle, zero fill past the
//     end, full/empty mbarriers), so loads overlap the products;
//   * S = Q·Kᵀ is a wgmma from shared memory (bf16 in, fp32 out; scale
//     applied to the fp32 scores, as the plain version's fp32 prescale);
//     the online softmax runs on the accumulator in registers (a row
//     lives on the 4 threads of a quad);
//   * O += P·V takes P from registers as the wgmma's A operand, split
//     P = hi + lo into two bf16 parts and two products into the same
//     fp32 accumulator: rounding P to bf16 once misses the one-ulp check
//     against fp32 (chip_smoke.py `split_trap` counts it), the split
//     carries ~16 bits of P.
//     The split costs 1.5× the products (6·d flops executed per pair,
//     not counted as work in the bound);
//   * within a warpgroup, S of the next K tile is issued before P·V of
//     the current one, so that tile's softmax overlaps P·V on the
//     tensor cores; the other warpgroup fills the gaps as well;
//   * exp runs as the SFU's exp2 with scale·log2(e) folded into one FMA;
//     the running max is over sign(scale)·s, so any scale works (0 gives
//     the uniform softmax);
//   * a warpgroup skips the K/V tiles wholly above its diagonal.
// Registers: ptxas gives 288 threads at one block per SM 168 a thread;
// d = 128 takes 160 (O 64, S of the next tile 32, P's fragments 32) and
// d = 64 135, without spills, so no setmaxnreg.
// fp32 inputs keep `flash_fwd_kernel`: fp32 FMAs from shared memory
// (flash_common.cuh), since the tensor cores take no fp32 products at
// the fp32 tolerance.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- bf16: tensor cores -------------------------------------------------------

namespace hx = strom_hopper;

constexpr int kTcThreads = 288;  // 2 consumer warpgroups + 1 producer warp
// K/V ring: a warpgroup holds tile kt (its V) while it needs tile kt + 1
// (its K), so a third stage keeps one tile's load in flight
constexpr int kStages = 3;
constexpr int kQRows = 128;      // q rows of a block
constexpr int kKRows = 64;       // keys of a K/V tile

template <int D>
struct TcFwdSmem {
  static constexpr int kQ = kQRows * D * 2;
  static constexpr int kKV = kKRows * D * 2;  // one K or V tile
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kBytes = 1024 + kQ + 2 * kStages * kKV + kBars;
};

// Online softmax of one 64 x 64 score tile (raw q·k in the accumulator
// layout of hopper.cuh) for the K tile kt: masks, updates the running
// max m and this thread's part of the row sums l, leaves
// p = exp(scale·(s − m)) in sc and each row's rescale factor in alpha.
// The max runs over sign(scale)·s, so scale·s − |scale|·m <= 0 for any
// scale: exp runs as exp2 with c = scale·log2(e) folded into one FMA, m
// in units of ca = |c| (c = ca = 1e-30 for scale 0, which makes every
// unmasked p exactly 1: the uniform softmax).  Masked entries become
// sign(scale)·s = −inf, so they add nothing to the max and their p is
// exp2(−inf) = 0.
__device__ __forceinline__ void softmax(float (&sc)[32], int kt, int row0,
                                        int t, int qw0, float c, float ca,
                                        const FwdArgs& a, float (&m)[2],
                                        float (&l)[2], float (&alpha)[2]) {
  const int k0 = kt * kKRows;
  const bool neg = c < 0.f;
  if (k0 + kKRows > a.skv || (a.causal && k0 + kKRows - 1 > qw0)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (col >= a.skv || (a.causal && col > row))
        sc[i] = neg ? INFINITY : -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
  if (neg) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], -sc[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = hx::ex2((m[r] - mn) * ca);
    mc[r] = mn * ca;
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = hx::ex2(fmaf(sc[i], c, -mc[r]));
    l[r] += sc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, FwdArgs a) {
  using L = TcFwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sKV = sQ + L::kQ;  // stage i: K at 2i·kKV, V at (2i + 1)·kKV
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sKV + 2 * kStages * L::kKV);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kend = a.causal ? min(a.skv, q0 + kQRows) : a.skv;
  const int n_kt = (kend + kKRows - 1) / kKRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hx::bar_init(q_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      hx::bar_init(&full[i], 1);
      hx::bar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hx::bar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      hx::bar_expect(q_bar, L::kQ);
      hx::tma_tile<D>(sQ, kQRows, &mq, q_bar, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) hx::bar_wait(&empty[st], (round - 1) & 1);
        uint8_t* k = sKV + 2 * st * L::kKV;
        hx::bar_expect(&full[st], 2 * L::kKV);
        hx::tma_tile<D>(k, kKRows, &mk, &full[st], kt * kKRows, h, b);
        hx::tma_tile<D>(k + L::kKV, kKRows, &mv, &full[st], kt * kKRows, h,
                        b);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows qw0 .. qw0 + 63; this thread's rows
  // are row0 and row0 + 8, its columns 8j + 2t and 8j + 2t + 1
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + (warp & 3) * 16 + (lane >> 2);
  const int kend_w = a.causal ? min(a.skv, qw0 + 64) : a.skv;
  const int n_kt_w = qw0 < a.s ? (kend_w + kKRows - 1) / kKRows : 0;
  const uint8_t* qw = sQ + wg * 64 * 128;
  // exp2 units: ca = |c|, floored so that scale 0 gives p = 1
  const float ca = fmaxf(fabsf(a.scale * hx::kLog2e), 1e-30f);
  const float c = a.scale < 0.f ? -ca : ca;

  // S of the K tile in stage st (raw q·k, fp32)
  auto scores = [&](float (&sc)[32], int st) {
    const uint8_t* sk = sKV + 2 * st * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hx::mma_ss_n64(sc, hx::desc_k(qw, kQRows, kk),
                     hx::desc_k(sk, kKRows, kk), kk > 0);
    hx::wg_commit();
  };
  float o[D / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
  uint32_t hi[4][4], lo[4][4];  // P of the tile in flight, split
  hx::bar_wait(q_bar, 0);
  // O += P·V for the V tile in stage st, P from hi and lo
  auto pv = [&](int st) {
    const uint8_t* sv = sKV + (2 * st + 1) * L::kKV;
    hx::wg_hold(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hx::mma_rs(o, hi[kk], hx::desc_mn(sv, kKRows, kk));
      hx::mma_rs(o, lo[kk], hx::desc_mn(sv, kKRows, kk));
    }
    hx::wg_commit();
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) hx::bar_arrive(&empty[st]);
  };
  if (n_kt_w > 0) {
    float sc[32] = {}, alpha[2];
    hx::bar_wait(&full[0], 0);
    hx::wg_fence();
    scores(sc, 0);
    hx::wg_wait<0>();
    hx::wg_hold(sc);
    softmax(sc, 0, row0, t, qw0, c, ca, a, m, l, alpha);
    hx::split(sc, hi, lo);
    // Tile kt: S of tile kt + 1 is issued before P·V of tile kt, so the
    // softmax of kt + 1 runs while the tensor cores do P·V of kt.  No
    // branch inside: ptxas serializes wgmmas issued on divergent paths.
    for (int kt = 0; kt + 1 < n_kt_w; ++kt) {
      const int st = kt % kStages, st1 = (kt + 1) % kStages;
      hx::bar_wait(&full[st1], ((kt + 1) / kStages) & 1);
      hx::wg_fence();
      scores(sc, st1);
      pv(st);
      hx::wg_wait<1>();
      hx::wg_hold(sc);
      softmax(sc, kt + 1, row0, t, qw0, c, ca, a, m, l, alpha);
      hx::wg_wait<0>();
      hx::wg_hold(o);
      hx::wg_hold(hi);
      hx::wg_hold(lo);
      release(st);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      hx::split(sc, hi, lo);
    }
    const int st = (n_kt_w - 1) % kStages;
    hx::wg_fence();
    pv(st);
    hx::wg_wait<0>();
    hx::wg_hold(o);
    hx::wg_hold(hi);
    hx::wg_hold(lo);
    release(st);
  }
  // the tiles above this warpgroup's diagonal: release them unread
  for (int kt = n_kt_w; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hx::bar_wait(&full[st], (kt / kStages) & 1);
    release(st);
  }
  if (n_kt_w == 0) return;

  __nv_bfloat16* out = head_ptr<__nv_bfloat16>(a.out, b, h);
  float* lse = a.lse + ((long long)b * a.h + h) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= a.s) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst = out + (long long)row * a.out.ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          hx::pack(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // m is the max of sign(scale)·s: the max of scale·s is |scale|·m
    if (t == 0) lse[row] = m[r] * fabsf(a.scale) + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_fwd_tc(const FwdArgs& a, int b, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hx::encode_map(&mq, a.q.p, a.q.sb, a.q.sh, a.q.ss, b, a.h, a.s, D,
                      kQRows) ||
      !hx::encode_map(&mk, a.k.p, a.k.sb, a.k.sh, a.k.ss, b, a.h, a.skv, D,
                      kKRows) ||
      !hx::encode_map(&mv, a.v.p, a.v.sb, a.v.sh, a.v.ss, b, a.h, a.skv, D,
                      kKRows))
    return cudaErrorInvalidValue;
  constexpr int smem = TcFwdSmem<D>::kBytes;
  cudaError_t e = allow_smem(flash_fwd_tc<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + kQRows - 1) / kQRows, a.h, b);
  flash_fwd_tc<D><<<grid, kTcThreads, smem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const FwdArgs& a, int b, cudaStream_t stream) {
    if constexpr (tensor_cores<T>(kFwd)) {
      return launch_fwd_tc<D>(a, b, stream);
    } else {
      constexpr int kSmem = (3 * kTile * (D + 1) + kTile * kLd) * 4;
      cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, kSmem);
      if (e != cudaSuccess) return e;
      const dim3 grid((a.s + kTile - 1) / kTile, a.h, b);
      flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
      return cudaGetLastError();
    }
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

// Which kernel `kernel` (0 forward, 1 dQ, 2 dK/dV) runs for `dtype`:
// 1 the tensor-core kernel, 0 the fp32 FMA kernel.
extern "C" int strom_flash_route(int kernel, int dtype) {
  return dtype == strom_attn::kBF16 ? (int)tensor_cores<__nv_bfloat16>(kernel)
                                    : (int)tensor_cores<float>(kernel);
}
