// attn_common.cuh — split-K one-token decode attention for sm_90a,
// shared by the dense-cache kernel (decode_attention.cu) and the
// block-table kernel (paged_attention.cu).  The two differ only in where
// key j's K and V rows live, which a small "rows" functor answers.
//
// Replaces the TPU kernels nvme_strom_tpu/ops/decode_attention.py
// `_decode_kernel` and nvme_strom_tpu/ops/paged_attention.py
// `_paged_kernel`: q (b, nh, 1, d) attends to the keys 0..pos[b] of its
// row at kv-head width (the GQA group of g = nh / nkv query heads is
// handled per kv head), fp32 online softmax, output rounded once to the
// input dtype.
//
// Bound: bytes.  One query row per kv-head group is far below the ~295
// operations a byte the tensor cores need, so the kernel is bound by the
// K and V bytes of the live positions over HBM's 3.35 TB/s, and its aim
// is bytes in flight on every SM.  The FMA dot products and their
// shuffle sums cost ~4 instructions a byte at four query rows, half the
// SMs' issue rate at HBM speed: a group of more than 4 (two or more row
// chunks) is bound by issue, not bytes (PERF.md).
//
// Layout of the work:
//   * split: the grid covers (split · row chunk, batch row · kv head).  A
//     split holds `split_len` keys (the wrapper picks it; a multiple of
//     block_k for the paged kernel, so a split reads whole pool blocks
//     and its table entries once).  Splits past a row's live length
//     pos[b] + 1 exit at once and read nothing.  A row chunk holds up to
//     G = 4 query rows of the group; a group of g takes ceil(g / 4)
//     chunks, rows past g in the last one are masked (g = 7: two chunks,
//     one row masked; g = 16: four).  The chunks of a split are
//     neighbours in the grid, so they run together and all but the first
//     read its K and V rows from L2.  A block of 8 rows would hold 128
//     floats of queries and accumulators a thread in registers, which
//     leaves too few loads in flight; it ran slower than two blocks of 4
//     at g = 7 and 8 (PERF.md);
//   * head dim: D in {64, 128, 256} is built; any d <= 256 that is a
//     multiple of 8 runs on the next D, lanes past d loading nothing and
//     contributing zero.  D/8 lanes share one key, each holding 8
//     elements (one 16-byte bf16 load, two for fp32), neighbouring lanes
//     on neighbouring addresses; the G query rows stay in registers, so
//     K and V are read once at kv-head width and never expanded.  Every
//     other d (not a multiple of 8, whose rows are not 16-byte aligned,
//     or above 256) takes the any-width path below, `split_attend_any`;
//   * inside a split, one pass: each lane group (the D/8 lanes of a key)
//     walks every GROUPS-th key, U keys a trip with their K and V loads
//     all in flight before any is used (U = unroll(): 8 for one or two
//     query rows in bf16, 4 for four, half that in fp32), and
//     keeps an fp32 online softmax (running max m, sum l, acc) with one
//     rescale a trip; the block then merges its lane groups' states in
//     shared memory;
//   * combine: a row with one live split writes acc / l straight to the
//     output.  Otherwise each split writes (m, l, acc[G][D]) in fp32 to a
//     workspace the wrapper allocates, and `combine_splits`, a second
//     kernel, forms out = Σ e^(m_i − M)·acc_i / Σ e^(m_i − M)·l_i over
//     the row's live splits in split order.  No floating-point atomics
//     anywhere: two calls are bitwise equal.
//
// Keys past pos are never read, so garbage (NaN) in an unfilled cache
// tail or a padding block cannot reach the output; a key the rows
// functor skips (a table entry outside the pool) counts as absent; a
// row with pos < 0 gives 0.  Scores are q·k with q scaled in fp32, as in
// the TPU kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace strom_attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// most keys one split may hold (bounds the paged kernel's table entries
// in shared memory)
constexpr int kMaxSplit = 512;
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers
constexpr int kBF16 = 0;
constexpr int kF32 = 1;

// 8 elements of a K or V row, loaded raw so that several loads of a lane
// are in flight before any is used
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// 8 elements at p as floats (the flash kernels' fp32 tiles)
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[8]) {
  Vec8<__nv_bfloat16> x;
  x.r = *reinterpret_cast<const uint4*>(p);
  x.get(o);
}

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  Vec8<float> x;
  x.a = *reinterpret_cast<const float4*>(p);
  x.b = *reinterpret_cast<const float4*>(p + 4);
  x.get(o);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// What the split kernel and the combine kernel share about one launch.
// ws: the workspace, acc (cells, n_splits, G, D) then (m, l) (cells,
// n_splits, 2, G), cells = rows · chunks; null when n_splits == 1.
struct SplitArgs {
  const void* q;      // (rows, g, d): rows = b · nkv
  void* out;          // (rows, g, d)
  float* ws;
  const int32_t* pos; // (b,)
  int nkv, g, d, capacity, split_len, n_splits;
  float scale;
};

// keys 0..last of row b are live; their splits are 0..n_live-1
__device__ __forceinline__ int live_splits(const SplitArgs& a, int b,
                                           int& last) {
  last = min(a.pos[b], a.capacity - 1);
  return last < 0 ? 0 : last / a.split_len + 1;
}

// Keys a lane group has in flight at once (each a K and a V row): as
// many as fit beside the query rows and the accumulators in registers.
template <typename T, int G>
__host__ __device__ constexpr int unroll() {
  return (G <= 2 ? 8 : 4) * 2 / (int)sizeof(T);
}

// One block: split blockIdx.x / chunks, query rows chunk
// blockIdx.x % chunks, of row blockIdx.y (b · nkv + kv head).
// rows.prepare(k0, k1) runs once before the split's keys are read (the
// paged kernel loads its table entries there); rows(key, k, v) sets
// key's K and V row pointers and returns false if the key must be
// skipped.
template <typename T, int D, int G, typename Rows>
__device__ __forceinline__ void split_attend(const SplitArgs& a,
                                             Rows& rows) {
  constexpr int LPK = D / 8;             // lanes per key
  constexpr int KPW = 32 / LPK;          // key groups per warp
  constexpr int GROUPS = kWarps * KPW;   // key groups per block
  constexpr int U = unroll<T, G>();
  constexpr int kStep = GROUPS * U;      // keys per block per trip
  __shared__ float sm_acc[GROUPS][G][D];
  __shared__ float sm_m[GROUPS][G], sm_l[GROUPS][G];

  // row chunks are the fastest index: a split's chunks run together
  // and read its K and V rows from HBM once, the other chunks from L2
  const int chunks = (a.g + G - 1) / G;
  const int split = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int bh = blockIdx.y;
  int last;
  const int n_live = live_splits(a, bh / a.nkv, last);
  const int g0 = chunk * G;
  const int here = min(G, a.g - g0);  // query rows of this chunk
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.g + g0) * a.d;
  if (n_live == 0) {  // pos < 0: the masked softmax's output is 0
    if (split == 0)
      for (int i = threadIdx.x; i < here * a.d; i += kThreads)
        store(out + i, 0.f);
    return;
  }
  if (split >= n_live) return;
  const int k0 = split * a.split_len;
  const int n = min(a.split_len, last + 1 - k0);
  rows.prepare(k0, k0 + n);

  const int lane = threadIdx.x & 31;
  const int group = (threadIdx.x >> 5) * KPW + lane / LPK;
  const int part = lane % LPK;
  const bool on = part * 8 < a.d;  // lanes past d load nothing

  float q[G][8];
  {
    const T* qp = static_cast<const T*>(a.q) +
                  ((size_t)bh * a.g + g0) * a.d + part * 8;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Vec8<T> x;
      if (on && g < here) x.load(qp + (size_t)g * a.d); else x.zero();
      x.get(q[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[g][e] *= a.scale;
    }
  }
  // this key group's online softmax state
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // block-uniform trip count: every lane takes part in the shuffles
  for (int base = 0; base < n; base += kStep) {
    Vec8<T> kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * GROUPS + group;
      const T* kp = nullptr;
      const T* vp = nullptr;
      ok[u] = j < n && rows(k0 + j, kp, vp);
      if (ok[u] && on) {
        kr[u].load(kp + part * 8);
        vr[u].load(vp + part * 8);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      kr[u].get(kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(q[g][e], kf[e], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = ok[u] ? d : -INFINITY;
      }
    }
    // one rescale a trip; the whole lane group holds the same scores
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, s[u][g]);
      if (mn == -INFINITY) continue;  // no key of this group yet
      const float alpha = expf(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = expf(s[u][g] - mn);
        l[g] += s[u][g];
      }
      m[g] = mn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float vf[8];
      vr[u].get(vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
  }

  // merge the key groups' states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (part == 0) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[group][g][part * 8 + e] = acc[g][e];
  }
  __syncthreads();
  const size_t cell = ((size_t)bh * chunks + chunk) * a.n_splits + split;
  const size_t cells = (size_t)gridDim.y * chunks * a.n_splits;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int col = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < GROUPS; ++r) mx = fmaxf(mx, sm_m[r][g]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {  // else every key of the split was skipped
#pragma unroll
      for (int r = 0; r < GROUPS; ++r) {
        const float w = expf(sm_m[r][g] - mx);
        den = fmaf(w, sm_l[r][g], den);
        num = fmaf(w, sm_acc[r][g][col], num);
      }
    }
    if (n_live == 1) {
      if (g < here && col < a.d)
        store(out + g * a.d + col, den > 0.f ? num / den : 0.f);
    } else {
      a.ws[cell * G * D + i] = num;
      if (col == 0) {
        float* ml = a.ws + cells * G * D + cell * 2 * G;
        ml[g] = mx == -INFINITY ? kNegInf : mx;
        ml[G + g] = den;
      }
    }
  }
}

// -- the any-width path ---------------------------------------------------
//
// Every head_dim the built widths do not take: d not a multiple of 8
// (rows not 16-byte aligned) or d above 256.  The split and its grid are
// those of `split_attend`; inside a split, three passes over runtime d:
//   1. scores: each warp takes every kWarps-th key of the split and walks
//      the head in pieces of 256 columns (32 lanes of 8), the G query
//      rows' piece in registers, U keys' loads in flight; lane 0 adds the
//      piece's dot product into the key's score in shared memory;
//   2. softmax: warp g turns row g's scores into weights e^(s − m) and
//      sums them (m, l);
//   3. P·V: as 1, each warp its keys over the head's pieces, U V rows
//      in flight; the 4 warps' sums meet in shared memory in warp order.
// K and V are read once; registers do not grow with d.  Loads are 16
// bytes where d is a multiple of 8, else one column (`Cols8`); columns
// past d are zero.  Correct for every d >= 1; not tuned (PERF.md has its
// times).

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Columns c..c+7 of a row of d elements at p, as floats; past d zero.
// ALIGNED (d a multiple of 8: a lane's columns are one 16-byte-aligned
// run) loads as `Vec8` does, otherwise column by column: loads of 4
// columns where d is a multiple of 4 ran slower at d 100 (PERF.md).
template <typename T, bool ALIGNED>
struct Cols8;

template <typename T>
struct Cols8<T, true> {
  Vec8<T> x;
  __device__ __forceinline__ void load(const T* p, int c, int d) {
    if (c < d) x.load(p + c); else x.zero();
  }
  __device__ __forceinline__ void zero() { x.zero(); }
  __device__ __forceinline__ void get(float (&o)[8]) const { x.get(o); }
};

template <typename T>
struct Cols8<T, false> {
  float f[8];
  __device__ __forceinline__ void load(const T* p, int c, int d) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = c + e < d ? to_float(__ldg(p + c + e)) : 0.f;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.f;
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = f[e];
  }
};

// true where the built widths take head_dim d (split_attend), false
// where the any-width path does
__host__ __device__ constexpr bool built_width(int d) {
  return d % 8 == 0 && d <= 256;
}

// One block of the any-width path, as `split_attend`; the workspace's
// acc rows are W floats apart (the wrapper's width, >= d).
template <typename T, int G, bool ALIGNED, typename Rows>
__device__ __forceinline__ void split_attend_any(const SplitArgs& a,
                                                 Rows& rows, int W) {
  static_assert(G <= kWarps, "one warp a query row in the softmax");
  constexpr int kPiece = 32 * 8;  // columns a warp covers a pass
  constexpr int U = 4;            // rows of a thread in flight
  __shared__ float sm_p[kMaxSplit][G];  // scores, then weights
  __shared__ const T* sm_k[kMaxSplit];  // key rows, null where skipped
  __shared__ const T* sm_v[kMaxSplit];
  __shared__ float sm_o[kWarps][G][kPiece];  // the warps' P·V sums
  __shared__ float sm_m[G], sm_l[G];

  const int chunks = (a.g + G - 1) / G;
  const int split = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int bh = blockIdx.y;
  int last;
  const int n_live = live_splits(a, bh / a.nkv, last);
  const int g0 = chunk * G;
  const int here = min(G, a.g - g0);
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.g + g0) * a.d;
  if (n_live == 0) {
    if (split == 0)
      for (int i = threadIdx.x; i < here * a.d; i += kThreads)
        store(out + i, 0.f);
    return;
  }
  if (split >= n_live) return;
  const int k0 = split * a.split_len;
  const int n = min(a.split_len, last + 1 - k0);
  rows.prepare(k0, k0 + n);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const T* kp = nullptr;
    const T* vp = nullptr;
    const bool ok = rows(k0 + j, kp, vp);
    sm_k[j] = ok ? kp : nullptr;
    sm_v[j] = ok ? vp : nullptr;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qp =
      static_cast<const T*>(a.q) + ((size_t)bh * a.g + g0) * a.d;
  // 1. scores
  for (int c0 = 0; c0 < a.d; c0 += kPiece) {
    const int c = c0 + lane * 8;
    float q[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Cols8<T, ALIGNED> x;
      if (g < here) x.load(qp + (size_t)g * a.d, c, a.d); else x.zero();
      x.get(q[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[g][e] *= a.scale;
    }
    for (int j0 = warp; j0 < n; j0 += kWarps * U) {
      Cols8<T, ALIGNED> kr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kWarps;
        const T* kp = j < n ? sm_k[j] : nullptr;
        if (kp) kr[u].load(kp, c, a.d); else kr[u].zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kWarps;
        float kf[8];
        kr[u].get(kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(q[g][e], kf[e], dot);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (lane == 0 && j < n)
            sm_p[j][g] = c0 == 0 ? dot : sm_p[j][g] + dot;
        }
      }
    }
  }
  __syncthreads();
  // 2. softmax: weights, their max and sum
  if (warp < G) {
    const int g = warp;
    float mx = -INFINITY;
    if (g < here)
      for (int j = lane; j < n; j += 32)
        if (sm_k[j]) mx = fmaxf(mx, sm_p[j][g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float w =
          mx != -INFINITY && sm_k[j] ? expf(sm_p[j][g] - mx) : 0.f;
      sm_p[j][g] = w;
      l += w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sm_m[g] = mx == -INFINITY ? kNegInf : mx;
      sm_l[g] = l;
    }
  }
  __syncthreads();
  // 3. P·V: each warp sums its keys' weighted V rows over the piece's
  // columns, as in 1; the warps' sums then meet in shared memory, in
  // warp order
  const size_t cell = ((size_t)bh * chunks + chunk) * a.n_splits + split;
  const size_t cells = (size_t)gridDim.y * chunks * a.n_splits;
  for (int c0 = 0; c0 < a.d; c0 += kPiece) {
    const int c = c0 + lane * 8;
    float acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    for (int j0 = warp; j0 < n; j0 += kWarps * U) {
      Cols8<T, ALIGNED> vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kWarps;
        const T* vp = j < n ? sm_v[j] : nullptr;
        if (vp) vr[u].load(vp, c, a.d); else vr[u].zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * kWarps;
        if (j >= n) break;
        float vf[8];
        vr[u].get(vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = sm_p[j][g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_o[warp][g][lane * 8 + e] = acc[g][e];
    __syncthreads();
    for (int i = threadIdx.x; i < G * kPiece; i += kThreads) {
      const int g = i / kPiece;
      const int col = c0 + i % kPiece;
      if (col >= a.d) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm_o[w][g][i % kPiece];
      if (n_live > 1)
        a.ws[cell * G * W + g * W + col] = sum;
      else if (g < here)
        store(out + g * a.d + col, sm_l[g] > 0.f ? sum / sm_l[g] : 0.f);
    }
    __syncthreads();  // the next piece reuses sm_o
  }
  if (n_live > 1 && threadIdx.x < G) {
    float* ml = a.ws + cells * G * W + cell * 2 * G;
    ml[threadIdx.x] = sm_m[threadIdx.x];
    ml[G + threadIdx.x] = sm_l[threadIdx.x];
  }
}

// The combine pass: one block per (row, chunk, query row g) whose row
// has more than one live split; out = Σ e^(m_i − M)·acc_i /
// Σ e^(m_i − M)·l_i over the live splits in split order, rounded once.
// Warp 0 finds M and the denominator; every thread then sums its
// columns over the splits, 8 splits' loads in flight at once.  The
// workspace's acc rows are W floats apart.  Each kernel source wraps it
// in a kernel of its own.
template <typename T, int G>
__device__ __forceinline__ void combine_splits(const SplitArgs& a, int W) {
  __shared__ float sm_m, sm_den;
  const int bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int g = blockIdx.z;
  const int g0 = chunk * G;
  int last;
  const int n_live = live_splits(a, bh / a.nkv, last);
  // one split: written by the split kernel; rows past g: masked
  if (n_live <= 1 || g0 + g >= a.g) return;
  const size_t cell0 = ((size_t)bh * gridDim.y + chunk) * a.n_splits;
  const size_t cells = (size_t)gridDim.x * gridDim.y * a.n_splits;
  const float* acc = a.ws + cell0 * G * W + g * W;  // split i at i·G·W
  const float* ml = a.ws + cells * G * W + cell0 * 2 * G + g;  // i·2G
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = kNegInf;
    for (int i = lane; i < n_live; i += 32) mx = fmaxf(mx, ml[i * 2 * G]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float den = 0.f;
    for (int i = lane; i < n_live; i += 32)
      den = fmaf(expf(ml[i * 2 * G] - mx), ml[i * 2 * G + G], den);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane == 0) {
      sm_m = mx;
      sm_den = den;
    }
  }
  __syncthreads();
  const float mx = sm_m;
  const float den = sm_den;
  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.g + g0 + g) * a.d;
  for (int col = threadIdx.x; col < a.d; col += kThreads) {
    float num = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_live; ++i)
      num = fmaf(expf(ml[i * 2 * G] - mx), acc[(size_t)i * G * W + col],
                 num);
    // every live key skipped: 0, as for a row with none
    store(out + col, den > 0.f ? num / den : 0.f);
  }
}

// The split kernel's grid, (n_splits · chunks, rows), and the
// combine's, (rows, chunks, G); the combine runs only where
// n_splits > 1.
inline dim3 split_grid(const SplitArgs& a, int rows, int G) {
  return dim3(a.n_splits * ((a.g + G - 1) / G), rows);
}

inline dim3 combine_grid(const SplitArgs& a, int rows, int G) {
  return dim3(rows, (a.g + G - 1) / G, G);
}


// Instantiate `Body<T, D, G>::run(args...)` for the dtype, built head
// width D and rows per chunk G the caller asks for; returns
// cudaErrorInvalidValue for anything else.
template <template <typename, int, int> class Body, typename... Args>
cudaError_t dispatch(int dtype, int width, int rows, Args... args) {
#define STROM_ATTN_CASE(T, DD, GG)                 \
  if (width == DD && rows == GG) {                 \
    Body<T, DD, GG>::run(args...);                 \
    return cudaGetLastError();                     \
  }
#define STROM_ATTN_ROWS(T, DD) \
  STROM_ATTN_CASE(T, DD, 1)    \
  STROM_ATTN_CASE(T, DD, 2)    \
  STROM_ATTN_CASE(T, DD, 4)
#define STROM_ATTN_WIDTHS(T) \
  STROM_ATTN_ROWS(T, 64)     \
  STROM_ATTN_ROWS(T, 128)    \
  STROM_ATTN_ROWS(T, 256)
  if (dtype == kBF16) {
    STROM_ATTN_WIDTHS(__nv_bfloat16)
  } else if (dtype == kF32) {
    STROM_ATTN_WIDTHS(float)
  }
#undef STROM_ATTN_WIDTHS
#undef STROM_ATTN_ROWS
#undef STROM_ATTN_CASE
  return cudaErrorInvalidValue;
}

// Instantiate `Body<T, G, ALIGNED>::run(args...)`, the any-width path,
// for the dtype, rows per chunk G and head_dim d (ALIGNED: d a multiple
// of 8) the caller asks for.
template <template <typename, int, bool> class Body, typename... Args>
cudaError_t dispatch_any(int dtype, int d, int rows, Args... args) {
  const bool aligned = d % 8 == 0;
#define STROM_ANY_CASE(T, GG)                     \
  if (rows == GG) {                               \
    if (aligned) Body<T, GG, true>::run(args...); \
    else Body<T, GG, false>::run(args...);        \
    return cudaGetLastError();                    \
  }
#define STROM_ANY_ROWS(T) \
  STROM_ANY_CASE(T, 1)    \
  STROM_ANY_CASE(T, 2)    \
  STROM_ANY_CASE(T, 4)
  if (dtype == kBF16) {
    STROM_ANY_ROWS(__nv_bfloat16)
  } else if (dtype == kF32) {
    STROM_ANY_ROWS(float)
  }
#undef STROM_ANY_ROWS
#undef STROM_ANY_CASE
  return cudaErrorInvalidValue;
}

}  // namespace strom_attn
