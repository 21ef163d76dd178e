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
//                                    causal start)
//
// The split into two kernels is the TPU's: no tile is written by two
// blocks, so there are no atomics and the gradients are bitwise the
// same from run to run.  Arithmetic fp32, each gradient rounded once to
// its input's dtype.
//
// Bound: operations.  dQ does three products per unmasked pair (q·k,
// dO·v, ds·k), dK/dV four (q·k, dO·v, pᵀ·dO, dsᵀ·q): 6·d and 8·d flops,
// 51.5 and 68.7 GFLOP at the flagship shape (b 8, h 8, s 2048, d 64,
// causal), ~0.052 and ~0.069 ms at the 989 TFLOP/s of the bf16 tensor
// cores.
//
// bf16 inputs run both on the tensor cores (hopper.cuh): wgmma products
// fed by TMA (128-byte swizzle, zero past the end) through rings of
// full/empty mbarriers, one producer warp loading and two consumer
// warpgroups computing; P, Pᵀ, dS and dSᵀ enter the next product from
// registers as its A operand, split x = hi + lo into two bf16 parts with
// two products into the fp32 accumulator (one bf16 rounding misses the
// one-ulp check against fp32: chip_smoke.py `split_trap` counts it for
// out, dV, dK and dQ); the blocks with the longest causal walk launch
// first; a stuck pipeline traps after 2 s in an mbarrier wait.  The
// producer warpgroup gives its registers up (setmaxnreg 40), the
// consumers take 232.
//
// dQ, `flash_dq_tc`:
//   * one block per (128 q rows, head, batch row), 64 q rows a consumer
//     warpgroup; Q and dO are loaded once, K/V tiles of 64 keys stream
//     through a ring of three stages, so two tiles load while the slower
//     warpgroup still reads a third; lse·log2(e) and delta of a thread's
//     two rows stay in registers for the whole loop;
//   * S = Q·Kᵀ and dP = dO·Vᵀ are wgmmas from shared memory in two
//     groups, so P (one FMA and the SFU's exp2, the scale folded in) is
//     computed while dP is on the tensor cores; dS follows in registers;
//   * dQ += dS·K takes dS from registers (split) with K as the MN-major
//     B operand: keys are the product's K, D its N.  8·d flops executed
//     per pair, 6·d counted as work;
//   * a warpgroup runs its K tiles in turn; the other warpgroup's
//     products fill the tensor cores while it computes P and dS.
//     Issuing the next tile's S and dP before this tile's dQ product
//     (as the forward overlaps its tiles) measured no faster at d = 64
//     on an H100 80GB HBM3 (700 W) and ~20% slower at d = 128, where it
//     keeps 160 accumulator and operand registers live and spills, so
//     it is not done;
//   * the same products in the same order take one of two loop shapes,
//     whichever ptxas schedules better at the width: peeled (tile kt's
//     dQ product, then tile kt + 1's dS) ran 6-8% faster at d = 64 on
//     that card, one loop (tile kt's dS, then its product) 7-9% faster
//     at d = 128, where the peeled shape spills 144 bytes and one loop
//     none (peeled against one loop, s 2048 causal, b·h 64 at d = 64
//     and 32 at d = 128, bitwise equal: 0.2179 against 0.2317 ms and
//     0.1940 against 0.1771 ms).  The width fixes the shape at compile
//     time;
//   * the mask is applied only on tiles that cross the diagonal or the
//     end of K; a warpgroup skips the K tiles past its last row.
// dK/dV, `flash_dkv_tc`:
//   * one block per (128 keys, head, batch row), 64 keys a consumer
//     warpgroup; K and V are loaded once; Q and dO tiles of 64 rows with
//     their lse·log2(e) and delta (plain loads into shared memory) come
//     through a ring of two stages;
//   * Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ from shared memory with M = keys, Pᵀ
//     under dPᵀ as in dQ; dV += Pᵀ·dO and dK += dSᵀ·Q from split
//     registers, dSᵀ split while dV's products run: 12·d flops executed
//     per pair, 8·d counted;
//   * a warpgroup skips the q tiles wholly before its first key.
//   Registers: dK and dV stay in registers for the whole loop (D fp32 a
//   thread for the two), ~210 with Pᵀ's and dSᵀ's fragments at d = 128:
//   d = 128 spills ~300 bytes (ptxas -v), d = 64 none.  Issuing the next
//   q tile's Sᵀ and dPᵀ before this tile's products keeps two tiles'
//   operands live: it spilled at both widths and ran slower.
// fp32 inputs keep the fp32 FMA kernels from shared memory
// (flash_common.cuh), since the tensor cores take no fp32 products at the
// fp32 tolerance.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- dK/dV on bf16: tensor cores ----------------------------------------------

namespace hx = strom_hopper;

// 2 consumer warpgroups + 1 producer warpgroup, of which one warp loads
constexpr int kTcThreads = 384;
constexpr int kStages = 2;
// Registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 fit in
// the SM's 65,536.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kKRows = 128;      // keys of a block
constexpr int kQRows = 64;       // q rows of a Q/dO tile

template <int D>
struct TcDkvSmem {
  static constexpr int kKV = kKRows * D * 2;  // K or V
  static constexpr int kQO = kQRows * D * 2;  // one Q or dO tile
  static constexpr int kRows = kStages * 2 * kQRows * 4;  // lse, delta
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static constexpr int kBytes =
      1024 + 2 * kKV + 2 * kStages * kQO + kRows + kBars;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dkv_tc(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv,
             const __grid_constant__ CUtensorMap mo, BwdArgs a) {
  using L = TcDkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + L::kKV;
  uint8_t* sQO = sV + L::kKV;  // stage i: Q at 2i·kQO, dO at (2i + 1)·kQO
  float* sRows = reinterpret_cast<float*>(sQO + 2 * kStages * L::kQO);
  // stage i: lse·log2(e) at sRows + 128 i, delta at sRows + 128 i + 64
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sRows + kStages * 128);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kKRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_start = a.causal ? k0 / kQRows : 0;
  const int n_qt = (a.s + kQRows - 1) / kQRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hx::bar_init(kv_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      hx::bar_init(&full[i], 1);
      hx::bar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hx::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hx::set_regs_dec<kProducerRegs>();
    if (warp != 8) return;
    if (lane == 0) {
      hx::bar_expect(kv_bar, 2 * L::kKV);
      hx::tma_tile<D>(sK, kKRows, &mk, kv_bar, k0, h, b);
      hx::tma_tile<D>(sV, kKRows, &mv, kv_bar, k0, h, b);
    }
    const long long row_base = ((long long)b * a.h + h) * a.s;
    for (int qt = q_start; qt < n_qt; ++qt) {
      const int i = qt - q_start;
      const int st = i % kStages, round = i / kStages;
      if (round > 0) hx::bar_wait(&empty[st], (round - 1) & 1);
      const int q0 = qt * kQRows;
      float* rows = sRows + st * 128;
      for (int r = lane; r < kQRows; r += 32) {
        const bool in = q0 + r < a.s;
        rows[r] = in ? a.lse[row_base + q0 + r] * hx::kLog2e : 0.f;
        rows[64 + r] = in ? a.delta[row_base + q0 + r] : 0.f;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        uint8_t* q = sQO + 2 * st * L::kQO;
        hx::bar_expect(&full[st], 2 * L::kQO);
        hx::tma_tile<D>(q, kQRows, &mq, &full[st], q0, h, b);
        hx::tma_tile<D>(q + L::kQO, kQRows, &mo, &full[st], q0, h, b);
      }
      __syncwarp();
    }
    return;
  }

  // consumer warpgroup wg: keys kw0 .. kw0 + 63; this thread's keys are
  // key0 and key0 + 8, its q columns 8j + 2t and 8j + 2t + 1
  hx::set_regs_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int kw0 = k0 + wg * 64;
  const int key0 = kw0 + (warp & 3) * 16 + (lane >> 2);
  const bool live = kw0 < a.skv;
  const uint8_t* kw = sK + wg * 64 * 128;
  const uint8_t* vw = sV + wg * 64 * 128;
  const float c2 = a.scale * hx::kLog2e;  // exp(scale·s − lse) as one exp2

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  hx::bar_wait(kv_bar, 0);

  for (int qt = q_start; qt < n_qt; ++qt) {
    const int i = qt - q_start;
    const int st = i % kStages;
    hx::bar_wait(&full[st], (i / kStages) & 1);
    const int q0 = qt * kQRows;
    if (live && !(a.causal && q0 + kQRows - 1 < kw0)) {
      const uint8_t* sq = sQO + 2 * st * L::kQO;
      const uint8_t* so = sq + L::kQO;
      const float* lse2 = sRows + st * 128;
      const float* delta = lse2 + 64;
      float sc[32] = {}, dp[32] = {};
      hx::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hx::mma_ss_n64(sc, hx::desc_k(kw, kKRows, kk),
                       hx::desc_k(sq, kQRows, kk), kk > 0);
      hx::wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hx::mma_ss_n64(dp, hx::desc_k(vw, kKRows, kk),
                       hx::desc_k(so, kQRows, kk), kk > 0);
      hx::wg_commit();
      hx::wg_wait<1>();
      hx::wg_hold(sc);

      // pᵀ (keys x q), exactly 0 where masked, on the SFU's exp2
      const bool mask = q0 + kQRows > a.s || (a.causal && kw0 + 63 > q0);
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const int c = 8 * (i2 >> 2) + 2 * t + (i2 & 1);
        float p = hx::ex2(fmaf(sc[i2], c2, -lse2[c]));
        if (mask) {
          const int q = q0 + c;
          const int key = key0 + 8 * ((i2 >> 1) & 1);
          if (q >= a.s || (a.causal && key > q)) p = 0.f;
        }
        sc[i2] = p;
      }
      hx::wg_wait<0>();
      hx::wg_hold(dp);
      // dsᵀ = pᵀ (dpᵀ − delta) scale, into dp's registers; pᵀ and dsᵀ
      // are split one after the other, so at most 64 of their registers
      // are live beside dK and dV
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const int c = 8 * (i2 >> 2) + 2 * t + (i2 & 1);
        dp[i2] = sc[i2] * (dp[i2] - delta[c]) * a.scale;
      }
      uint32_t hi[4][4], lo[4][4];
      hx::split(sc, hi, lo);
      hx::wg_fence();
      hx::wg_hold(dv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hx::mma_rs(dv, hi[kk], hx::desc_mn(so, kQRows, kk));
        hx::mma_rs(dv, lo[kk], hx::desc_mn(so, kQRows, kk));
      }
      uint32_t dhi[4][4], dlo[4][4];
      hx::split(dp, dhi, dlo);
      hx::wg_fence();
      hx::wg_hold(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hx::mma_rs(dk, dhi[kk], hx::desc_mn(sq, kQRows, kk));
        hx::mma_rs(dk, dlo[kk], hx::desc_mn(sq, kQRows, kk));
      }
      hx::wg_commit();
      hx::wg_wait<0>();
      hx::wg_hold(dv);
      hx::wg_hold(dk);
      hx::wg_hold(hi);
      hx::wg_hold(lo);
      hx::wg_hold(dhi);
      hx::wg_hold(dlo);
    }
    __syncwarp();
    if (lane == 0) hx::bar_arrive(&empty[st]);
  }
  if (!live) return;

  __nv_bfloat16* dkp = head_ptr<__nv_bfloat16>(a.dk, b, h);
  __nv_bfloat16* dvp = head_ptr<__nv_bfloat16>(a.dv, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.skv) continue;
    __nv_bfloat16* k_dst = dkp + (long long)key * a.dk.ss + 2 * t;
    __nv_bfloat16* v_dst = dvp + (long long)key * a.dv.ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(k_dst + 8 * j) =
          hx::pack(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(v_dst + 8 * j) =
          hx::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, int b, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!hx::encode_map(&mq, a.q.p, a.q.sb, a.q.sh, a.q.ss, b, a.h, a.s, D,
                      kQRows) ||
      !hx::encode_map(&mo, a.dout.p, a.dout.sb, a.dout.sh, a.dout.ss, b, a.h,
                      a.s, D, kQRows) ||
      !hx::encode_map(&mk, a.k.p, a.k.sb, a.k.sh, a.k.ss, b, a.h, a.skv, D,
                      kKRows) ||
      !hx::encode_map(&mv, a.v.p, a.v.sb, a.v.sh, a.v.ss, b, a.h, a.skv, D,
                      kKRows))
    return cudaErrorInvalidValue;
  constexpr int smem = TcDkvSmem<D>::kBytes;
  cudaError_t e = allow_smem(flash_dkv_tc<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.skv + kKRows - 1) / kKRows, a.h, b);
  flash_dkv_tc<D><<<grid, kTcThreads, smem, stream>>>(mq, mk, mv, mo, a);
  return cudaGetLastError();
}

// -- dQ on bf16: tensor cores -------------------------------------------------

constexpr int kDqRows = 128;    // q rows of a block
constexpr int kDqKeys = 64;     // keys of a K/V tile
constexpr int kDqStages = 3;   // K/V tiles in the ring

template <int D>
struct TcDqSmem {
  static constexpr int kQO = kDqRows * D * 2;  // Q or dO of the block
  static constexpr int kKV = kDqKeys * D * 2;  // one K or V tile
  static constexpr int kBars = (1 + 2 * kDqStages) * 8;
  static constexpr int kBytes = 1024 + 2 * kQO + 2 * kDqStages * kKV + kBars;
};

// kPeeled: the loop's shape (LaunchDq), not its arithmetic.
template <int D, bool kPeeled>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dq_tc(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mo, BwdArgs a) {
  using L = TcDqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + L::kQO;   // dO
  uint8_t* sKV = sO + L::kQO;  // stage i: K at 2i·kKV, V at (2i + 1)·kKV
  uint64_t* qo_bar = reinterpret_cast<uint64_t*>(sKV + 2 * kDqStages * L::kKV);
  uint64_t* full = qo_bar + 1;
  uint64_t* empty = full + kDqStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kend = a.causal ? min(a.skv, q0 + kDqRows) : a.skv;
  const int n_kt = (kend + kDqKeys - 1) / kDqKeys;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hx::bar_init(qo_bar, 1);
    for (int i = 0; i < kDqStages; ++i) {
      hx::bar_init(&full[i], 1);
      hx::bar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hx::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hx::set_regs_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    hx::bar_expect(qo_bar, 2 * L::kQO);
    hx::tma_tile<D>(sQ, kDqRows, &mq, qo_bar, q0, h, b);
    hx::tma_tile<D>(sO, kDqRows, &mo, qo_bar, q0, h, b);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kDqStages, round = kt / kDqStages;
      if (round > 0) hx::bar_wait(&empty[st], (round - 1) & 1);
      uint8_t* k = sKV + 2 * st * L::kKV;
      hx::bar_expect(&full[st], 2 * L::kKV);
      hx::tma_tile<D>(k, kDqKeys, &mk, &full[st], kt * kDqKeys, h, b);
      hx::tma_tile<D>(k + L::kKV, kDqKeys, &mv, &full[st], kt * kDqKeys, h,
                      b);
    }
    return;
  }

  // consumer warpgroup wg: q rows qw0 .. qw0 + 63; this thread's rows
  // are row0 and row0 + 8, its keys 8j + 2t and 8j + 2t + 1 of a tile
  hx::set_regs_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + (warp & 3) * 16 + (lane >> 2);
  const int kend_w = a.causal ? min(a.skv, qw0 + 64) : a.skv;
  const int n_kt_w = qw0 < a.s ? (kend_w + kDqKeys - 1) / kDqKeys : 0;
  const uint8_t* qw = sQ + wg * 64 * 128;
  const uint8_t* ow = sO + wg * 64 * 128;
  const float c2 = a.scale * hx::kLog2e;  // exp(scale·s − lse) as one exp2
  // lse·log2(e) and delta of this thread's two rows, fixed for the loop
  // (rows past the end: 0, and their Q and dO read as zero)
  float lse2[2], delta[2];
  const long long row_base = ((long long)b * a.h + h) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < a.s;
    lse2[r] = in ? a.lse[row_base + row] * hx::kLog2e : 0.f;
    delta[r] = in ? a.delta[row_base + row] : 0.f;
  }

  // S = Q·Kᵀ and dP = dO·Vᵀ of the K/V tile in stage st, two groups
  auto products = [&](float (&sc)[32], float (&dp)[32], int st) {
    const uint8_t* sk = sKV + 2 * st * L::kKV;
    const uint8_t* sv = sk + L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hx::mma_ss_n64(sc, hx::desc_k(qw, kDqRows, kk),
                     hx::desc_k(sk, kDqKeys, kk), kk > 0);
    hx::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hx::mma_ss_n64(dp, hx::desc_k(ow, kDqRows, kk),
                     hx::desc_k(sv, kDqKeys, kk), kk > 0);
    hx::wg_commit();
  };
  // P of K tile kt in place of S, exactly 0 where masked; the mask is
  // tested only on tiles that cross the diagonal or the end of K
  auto probs = [&](float (&sc)[32], int kt) {
    const int k0 = kt * kDqKeys;
    const bool mask =
        k0 + kDqKeys > a.skv || (a.causal && k0 + kDqKeys - 1 > qw0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = hx::ex2(fmaf(sc[i], c2, -lse2[r]));
      if (mask) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col >= a.skv || (a.causal && col > row0 + 8 * r)) p = 0.f;
      }
      sc[i] = p;
    }
  };
  // dS = P (dP − delta) scale, in place of dP
  auto dsoft = [&](const float (&sc)[32], float (&dp)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]) * a.scale;
  };
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];  // dS of the current tile, split
  // dQ += dS·K for the K tile in stage st, dS from hi and lo: keys are
  // the product's K, D its N (K MN-major)
  auto dq_mma = [&](int st) {
    const uint8_t* sk = sKV + 2 * st * L::kKV;
    hx::wg_hold(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hx::mma_rs(dq, hi[kk], hx::desc_mn(sk, kDqKeys, kk));
      hx::mma_rs(dq, lo[kk], hx::desc_mn(sk, kDqKeys, kk));
    }
    hx::wg_commit();
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) hx::bar_arrive(&empty[st]);
  };
  hx::bar_wait(qo_bar, 0);
  float sc[32] = {}, dp[32] = {};
  // S, dP, P and dS of the K tile in stage st, dS split into hi and lo
  auto ds_of = [&](int st, int kt) {
    hx::wg_fence();
    products(sc, dp, st);
    hx::wg_wait<1>();
    hx::wg_hold(sc);
    probs(sc, kt);
    hx::wg_wait<0>();
    hx::wg_hold(dp);
    dsoft(sc, dp);
    hx::split(dp, hi, lo);
  };
  auto dq_of = [&](int st) {
    hx::wg_fence();
    dq_mma(st);
    hx::wg_wait<0>();
    hx::wg_hold(dq);
    hx::wg_hold(hi);
    hx::wg_hold(lo);
    release(st);
  };
  if constexpr (kPeeled) {
    // tile kt's dQ product, then tile kt + 1's dS: the first dS and the
    // last product peeled off, so no wgmma sits on a branch
    if (n_kt_w > 0) {
      hx::bar_wait(&full[0], 0);
      ds_of(0, 0);
      for (int kt = 0; kt + 1 < n_kt_w; ++kt) {
        const int st1 = (kt + 1) % kDqStages;
        hx::bar_wait(&full[st1], ((kt + 1) / kDqStages) & 1);
        dq_of(kt % kDqStages);
        ds_of(st1, kt + 1);
      }
      dq_of((n_kt_w - 1) % kDqStages);
    }
  } else {
    for (int kt = 0; kt < n_kt_w; ++kt) {
      const int st = kt % kDqStages;
      hx::bar_wait(&full[st], (kt / kDqStages) & 1);
      ds_of(st, kt);
      dq_of(st);
    }
  }
  // the tiles past this warpgroup's diagonal: release them unread
  for (int kt = n_kt_w; kt < n_kt; ++kt) {
    const int st = kt % kDqStages;
    hx::bar_wait(&full[st], (kt / kDqStages) & 1);
    release(st);
  }
  if (n_kt_w == 0) return;

  __nv_bfloat16* dqp = head_ptr<__nv_bfloat16>(a.dq, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.s) continue;
    __nv_bfloat16* dst = dqp + (long long)row * a.dq.ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          hx::pack(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

template <int D, bool kPeeled>
cudaError_t launch_dq_tc(const BwdArgs& a, int b, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!hx::encode_map(&mq, a.q.p, a.q.sb, a.q.sh, a.q.ss, b, a.h, a.s, D,
                      kDqRows) ||
      !hx::encode_map(&mo, a.dout.p, a.dout.sb, a.dout.sh, a.dout.ss, b, a.h,
                      a.s, D, kDqRows) ||
      !hx::encode_map(&mk, a.k.p, a.k.sb, a.k.sh, a.k.ss, b, a.h, a.skv, D,
                      kDqKeys) ||
      !hx::encode_map(&mv, a.v.p, a.v.sb, a.v.sh, a.v.ss, b, a.h, a.skv, D,
                      kDqKeys))
    return cudaErrorInvalidValue;
  constexpr int smem = TcDqSmem<D>::kBytes;
  cudaError_t e = allow_smem(flash_dq_tc<D, kPeeled>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s + kDqRows - 1) / kDqRows, a.h, b);
  flash_dq_tc<D, kPeeled><<<grid, kTcThreads, smem, stream>>>(mq, mk, mv, mo,
                                                              a);
  return cudaGetLastError();
}

template <typename T, int D>
struct LaunchDq {
  static cudaError_t run(const BwdArgs& a, int b, cudaStream_t stream) {
    if constexpr (tensor_cores<T>(kDq)) {
      // the loop's shape by width (flash_dq_tc): peeled at d = 64
      constexpr bool kPeeled = D == 64;
      return launch_dq_tc<D, kPeeled>(a, b, stream);
    } else {
      constexpr int kSmem = (4 * kTile * (D + 1) + kTile * kLd) * 4;
      cudaError_t e = allow_smem(flash_dq_kernel<T, D>, kSmem);
      if (e != cudaSuccess) return e;
      const dim3 grid((a.s + kTile - 1) / kTile, a.h, b);
      flash_dq_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
      return cudaGetLastError();
    }
  }
};

template <typename T, int D>
struct LaunchDkv {
  static cudaError_t run(const BwdArgs& a, int b, cudaStream_t stream) {
    if constexpr (tensor_cores<T>(kDkv)) {
      return launch_dkv_tc<D>(a, b, stream);
    } else {
      constexpr int kSmem =
          (4 * kTile * (D + 1) + 2 * kTile * kLd + 2 * kTile) * 4;
      cudaError_t e = allow_smem(flash_dkv_kernel<T, D>, kSmem);
      if (e != cudaSuccess) return e;
      const dim3 grid((a.skv + kTile - 1) / kTile, a.h, b);
      flash_dkv_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
      return cudaGetLastError();
    }
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
