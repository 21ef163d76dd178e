// quant_matmul.cu — the weight-only int8 / int4 matmul for sm_90a: a
// fused decode product (quant_gemv) and a one-pass dequantization
// (dequant).
//
// Replaces the program that XLA builds on the TPU from
// nvme_strom_tpu/models/transformer.py `wmat` (line 220) and the matmul
// that consumes it.  There is no Pallas kernel: XLA fuses the dequant
// into the matmul's operand read, so the TPU reads the quantized bytes
// only.  In torch the dequantized weight is a tensor of its own, written
// in the compute dtype and read back by the matmul: at least 5 bytes an
// element for int8 and more than 10 for int4 against bf16's 2.
//
// Leaves (models/quant.py): int8 `q8` int8 (E, K, N) with `scale` f32
// (E, 1, N); int4 `q4` uint8 (E, K/2, N), the byte of column n at packed
// row i holding row 2i in its low nibble and row 2i+1 in its high
// nibble, each as q + 8, with `scale4` f32 (E, G, 1, N) and the group
// size g = K / G (even, so a byte's two rows share a group).  E is 1 for
// a 2-D weight.  Each element is dequantized exactly as `wmat`'s torch
// ops round it:
//
//     w = rnd(float(q) * float(rnd(scale)))
//
// where rnd rounds to the compute dtype to nearest even (bf16 / fp16; the
// identity for fp32).  float(q) * float(rnd(scale)) is exact in fp32
// (8 by 8 or 11 bits), so the one rounding matches torch's.
//
// quant_gemv: out[e, m, n] = sum_k x[e, m, k] * w[e, k, n] for the few
// rows M of a decode step, never writing w anywhere.
//   Bound: bytes.  The weight is read once (1 byte an element for int8,
//   half a byte for int4); x, the scales and out are small.  Each weight
//   element costs M FMAs and ~4 dequant instructions on the CUDA cores,
//   and on the H100 that issue binds first: at 8 rows the kernel runs at
//   11-19% of the byte bound, and its time grows with M from 4 rows on
//   (PERF.md §6).  Tensor cores are the next design (ROADMAP).
//   Layout: the grid is (column blocks, K splits, E x row tiles).  A
//   block of 4 warps takes 32 x VEC output columns; each lane holds VEC
//   neighbouring columns and loads them as one VEC-byte vector a weight
//   row (a warp reads 256 contiguous bytes a row), so the weight streams
//   coalesced.  The block walks its split's rows in tiles; a tile's rows
//   of x (the row tile's MT rows) are staged in shared memory as f32, and
//   each warp takes a contiguous run of 8 quantized rows of the tile (8
//   packed row pairs for int4), all 8 vector loads in flight before any
//   is used.  The MT x VEC f32 partial sums live in registers; the
//   block's warps are summed in shared memory in warp order.  The split
//   count is the wrapper's (ops/quant_matmul.py `kernel_launch`): enough
//   blocks for every SM to stream.  With one split the block rounds and
//   writes the output; with more each split writes its f32 partials to a
//   workspace and a second launch sums them in split order and rounds.
//   No floating-point atomics: two calls are bitwise equal.  An int4
//   split starts on an even row; each row takes the scale of its own
//   group (row / g), so a split or a tile may straddle a group.
//   Rows of x past M and columns past N are masked; a weight row whose
//   columns are not VEC-aligned in memory is loaded a byte at a time.
//
// dequant: writes `wmat`'s weight (E, K, N) in the compute dtype in one
// pass, reading the quantized bytes once, bitwise equal to the torch
// ops.  Bound: bytes (the quantized bytes and scales read, the weight
// written).  A thread takes VEC columns of one row (a packed row pair for
// int4): one vector load of the quantized bytes, vector stores of the
// dequantized row(s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element types by their code in ops/quant_matmul.py KERNEL_DTYPES
constexpr int kBF16 = 0;
constexpr int kF32 = 1;
constexpr int kF16 = 2;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// quantized rows (int8) or packed row pairs (int4) a warp takes of a tile
constexpr int kUnitsPerWarp = 8;
constexpr int kTileUnits = kWarps * kUnitsPerWarp;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Num<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(__ldg(p));
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half_rn(v);
  }
};

struct GemvArgs {
  const void* x;         // (E, M, K) in T
  const uint8_t* q;      // (E, K, N) int8 or (E, K/2, N) packed int4
  const float* scale;    // (E, 1, N) or (E, G, 1, N)
  void* out;             // (E, M, N) in T
  float* ws;             // (n_splits, E, M, N) f32 when n_splits > 1
  int E, M, K, N;
  int group;             // int4: rows a scale group holds; int8: K
  int split_rows;        // rows a split holds (even for int4)
  int n_splits;
  int row_tiles;         // ceil(M / MT)
  int vec_ok;            // rows start VEC-aligned: vector loads
};

// VEC quantized bytes of one row from column c0 (lim columns left in
// the row): one vector load where the row is VEC-aligned and whole, else
// a byte at a time with the columns past the row zero.
template <int VEC>
__device__ __forceinline__ void load_row(const uint8_t* p, bool vec, int lim,
                                         uint32_t (&r)[VEC / 4]) {
  if (vec) {
    if constexpr (VEC == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      r[0] = v.x;
      r[1] = v.y;
    } else {
      r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
    return;
  }
#pragma unroll
  for (int w = 0; w < VEC / 4; ++w) r[w] = 0u;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < lim) r[j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* r, int j) {
  return (r[j / 4] >> (8 * (j % 4))) & 0xFFu;
}

// the scales of columns c0.. of one scale row, rounded to T (0 past N)
template <typename T, int VEC>
__device__ __forceinline__ void load_scales(const float* row, int c0, int n,
                                            float (&sc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    sc[j] = c0 + j < n ? Num<T>::rnd(__ldg(row + c0 + j)) : 0.f;
}

template <typename T, int MT, int VEC, bool INT4>
__global__ void __launch_bounds__(kThreads)
quant_gemv_split(GemvArgs a) {
  constexpr int R = INT4 ? 2 : 1;             // weight rows a unit holds
  constexpr int kTileRows = kTileUnits * R;
  constexpr int kCols = 32 * VEC;
  __shared__ float xs[MT][kTileRows];
  __shared__ float red[kWarps][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.z / a.row_tiles;
  const int m0 = (blockIdx.z % a.row_tiles) * MT;
  const int c0 = blockIdx.x * kCols + lane * VEC;
  const int k_begin = blockIdx.y * a.split_rows;
  const int k_end = min(a.K, k_begin + a.split_rows);
  const T* x = static_cast<const T*>(a.x) + ((size_t)e * a.M + m0) * a.K;
  const uint8_t* q = a.q + (size_t)e * (a.K / R) * a.N;
  const int n_groups = a.K / a.group;
  const float* scale = a.scale + (size_t)e * n_groups * a.N;
  const bool live = c0 < a.N;

  float sc[VEC];
  int group_end = 0;                          // int4: first row past sc's
  if (!INT4 && live) load_scales<T, VEC>(scale, c0, a.N, sc);
  float acc[MT][VEC];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[mm][j] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kTileRows) {
    const int rows = min(kTileRows, k_end - t0);
    __syncthreads();                          // the last tile's xs read
    for (int i = threadIdx.x; i < MT * kTileRows; i += kThreads) {
      const int mm = i / kTileRows, kk = i % kTileRows;
      xs[mm][kk] = m0 + mm < a.M && kk < rows
                       ? Num<T>::load(x + (size_t)mm * a.K + t0 + kk)
                       : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int u0 = warp * kUnitsPerWarp;
    const int n_units = rows / R;
    uint32_t raw[kUnitsPerWarp][VEC / 4];
#pragma unroll
    for (int v = 0; v < kUnitsPerWarp; ++v) {
      if (u0 + v < n_units)
        load_row<VEC>(q + (size_t)(t0 / R + u0 + v) * a.N + c0, a.vec_ok,
                      a.N - c0, raw[v]);
    }
#pragma unroll
    for (int v = 0; v < kUnitsPerWarp; ++v) {
      const int u = u0 + v;
      if (u >= n_units) continue;
      const int kk = u * R;
      if (INT4 && t0 + kk >= group_end) {
        const int g = (t0 + kk) / a.group;
        group_end = (g + 1) * a.group;
        load_scales<T, VEC>(scale + (size_t)g * a.N, c0, a.N, sc);
      }
      float w0[VEC], w1[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const uint32_t b = byte_of(raw[v], j);
        if (INT4) {
          w0[j] = Num<T>::rnd((float)((int)(b & 0xFu) - 8) * sc[j]);
          w1[j] = Num<T>::rnd((float)((int)(b >> 4) - 8) * sc[j]);
        } else {
          w0[j] = Num<T>::rnd((float)(int8_t)b * sc[j]);
        }
      }
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) {
        const float x0 = xs[mm][kk];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[mm][j] = fmaf(x0, w0[j], acc[mm][j]);
        if (INT4) {
          const float x1 = xs[mm][kk + 1];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[mm][j] = fmaf(x1, w1[j], acc[mm][j]);
        }
      }
    }
  }

  // the block's warps summed in warp order, one row of x at a time;
  // column lane * VEC + j of a warp sits at red[warp][j * 32 + lane]
  const size_t plane = (size_t)a.E * a.M * a.N;
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    if (m0 + mm < a.M) {                      // uniform across the block
      __syncthreads();
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp][j * 32 + lane] = acc[mm][j];
      __syncthreads();
      for (int c = threadIdx.x; c < kCols; c += kThreads) {
        const int n = blockIdx.x * kCols + c;
        if (n >= a.N) continue;
        const int l = c / VEC, j = c % VEC;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][j * 32 + l];
        const size_t o = ((size_t)e * a.M + m0 + mm) * a.N + n;
        if (a.n_splits == 1)
          static_cast<T*>(a.out)[o] = Num<T>::store(s);
        else
          a.ws[blockIdx.y * plane + o] = s;
      }
    }
  }
}

// out = the splits' partials summed in split order, rounded once
template <typename T>
__global__ void __launch_bounds__(256)
quant_gemv_combine(const float* __restrict__ ws, T* __restrict__ out,
                   size_t plane, int n_splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += ws[sp * plane + i];
    out[i] = Num<T>::store(s);
  }
}

int grid_of(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 65536 * 8 ? blocks : 65536 * 8);
}

template <typename T, int MT, int VEC>
cudaError_t run_gemv(const GemvArgs& a, bool int4, cudaStream_t s) {
  const dim3 grid((a.N + 32 * VEC - 1) / (32 * VEC), a.n_splits,
                  a.E * a.row_tiles);
  if (int4)
    quant_gemv_split<T, MT, VEC, true><<<grid, kThreads, 0, s>>>(a);
  else
    quant_gemv_split<T, MT, VEC, false><<<grid, kThreads, 0, s>>>(a);
  if (a.n_splits > 1) {
    const size_t plane = (size_t)a.E * a.M * a.N;
    quant_gemv_combine<T><<<grid_of(plane, 256), 256, 0, s>>>(
        a.ws, static_cast<T*>(a.out), plane, a.n_splits);
  }
  return cudaGetLastError();
}

// rows of x a block holds (MT) and columns a lane holds (VEC): the
// smallest power of two >= M up to 8, then tiles of 16 rows at 4 columns
// a lane, so a thread keeps at most 64 partial sums.  The wrapper mirrors
// this (ops/quant_matmul.py `row_tile`).
template <typename T>
cudaError_t dispatch_gemv(const GemvArgs& a, int mt, bool int4,
                          cudaStream_t s) {
  switch (mt) {
    case 1: return run_gemv<T, 1, 8>(a, int4, s);
    case 2: return run_gemv<T, 2, 8>(a, int4, s);
    case 4: return run_gemv<T, 4, 8>(a, int4, s);
    case 8: return run_gemv<T, 8, 8>(a, int4, s);
    default: return run_gemv<T, 16, 4>(a, int4, s);
  }
}

constexpr int kDequantVec = 8;

// kDequantVec values rounded to T at dst: 16-byte stores where the row
// is aligned, else one element at a time up to the row's end (lim)
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const float* v, bool vec,
                                          int lim) {
  if (vec) {
    __align__(16) T t[kDequantVec];
#pragma unroll
    for (int j = 0; j < kDequantVec; ++j) t[j] = Num<T>::store(v[j]);
    const uint4* src = reinterpret_cast<const uint4*>(t);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int w = 0; w < (int)(kDequantVec * sizeof(T) / 16); ++w) d[w] = src[w];
    return;
  }
#pragma unroll
  for (int j = 0; j < kDequantVec; ++j)
    if (j < lim) dst[j] = Num<T>::store(v[j]);
}

template <typename T, bool INT4>
__global__ void __launch_bounds__(256)
dequant_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scale,
               T* __restrict__ out, int E, int K, int N, int group,
               int vec_ok) {
  constexpr int R = INT4 ? 2 : 1;
  constexpr int V = kDequantVec;
  const int cols = (N + V - 1) / V;
  const int units = K / R;
  const int n_groups = K / group;
  const size_t work = (size_t)E * units * cols;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < work;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % cols) * V;
    const size_t eu = i / cols;
    const int u = (int)(eu % units);
    const int e = (int)(eu / units);
    const int k = u * R;
    const float* srow =
        scale + ((size_t)e * n_groups + (INT4 ? k / group : 0)) * N;
    float sc[V];
    load_scales<T, V>(srow, c0, N, sc);
    uint32_t raw[V / 4];
    load_row<V>(q + ((size_t)e * units + u) * N + c0, vec_ok, N - c0, raw);
    float w0[V], w1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t b = byte_of(raw, j);
      if (INT4) {
        w0[j] = (float)((int)(b & 0xFu) - 8) * sc[j];
        w1[j] = (float)((int)(b >> 4) - 8) * sc[j];
      } else {
        w0[j] = (float)(int8_t)b * sc[j];
      }
    }
    T* dst = out + ((size_t)e * K + k) * N + c0;
    store_row<T>(dst, w0, vec_ok, N - c0);
    if (INT4) store_row<T>(dst + N, w1, vec_ok, N - c0);
  }
}

template <typename T>
cudaError_t run_dequant(const void* q, const void* scale, void* out, int E,
                        int K, int N, int group, bool int4, int vec_ok,
                        int sms, cudaStream_t s) {
  const size_t work = (size_t)E * (K / (int4 ? 2 : 1)) *
                      ((N + kDequantVec - 1) / kDequantVec);
  const int cap = sms * 8;
  int blocks = grid_of(work, 256);
  if (blocks > cap) blocks = cap;
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sb = static_cast<const float*>(scale);
  if (int4)
    dequant_kernel<T, true><<<blocks, 256, 0, s>>>(
        qb, sb, static_cast<T*>(out), E, K, N, group, vec_ok);
  else
    dequant_kernel<T, false><<<blocks, 256, 0, s>>>(
        qb, sb, static_cast<T*>(out), E, K, N, group, vec_ok);
  return cudaGetLastError();
}

bool valid_leaf(int E, int K, int N, int group, int bits) {
  if (E <= 0 || K <= 0 || N <= 0 || group <= 0 || K % group) return false;
  if (bits == 4) return K % 2 == 0 && group % 2 == 0;
  return bits == 8;
}

}  // namespace

// x (E, M, K), q / scale the leaf (bits 8: q8, scale; bits 4: q4,
// scale4 with `group` rows a scale; bits 8 takes group = K), out
// (E, M, N); split_rows: rows a split holds, even for int4 (the
// wrapper's `kernel_launch`); ws: the f32 (n_splits, E, M, N) workspace
// where ceil(K / split_rows) > 1, else null.
extern "C" int strom_quant_gemv(const void* x, const void* q,
                                const void* scale, void* out, void* ws,
                                int E, int M, int K, int N, int group,
                                int bits, int split_rows, int dtype,
                                void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_leaf(E, K, N, group, bits) || M <= 0 || split_rows <= 0 ||
      (bits == 4 && split_rows % 2))
    return (int)cudaErrorInvalidValue;
  const int n_splits = (K + split_rows - 1) / split_rows;
  const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const int vec = mt == 16 ? 4 : 8;
  const int row_tiles = (M + mt - 1) / mt;
  if (n_splits > 65535 || (long long)E * row_tiles > 65535 ||
      (n_splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec_ok = N % vec == 0 && (uintptr_t)q % vec == 0;
  const GemvArgs a{x, static_cast<const uint8_t*>(q),
                   static_cast<const float*>(scale), out,
                   static_cast<float*>(ws), E, M, K, N, group, split_rows,
                   n_splits, row_tiles, vec_ok};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int4 = bits == 4;
  if (dtype == kBF16) return (int)dispatch_gemv<__nv_bfloat16>(a, mt, int4, s);
  if (dtype == kF16) return (int)dispatch_gemv<__half>(a, mt, int4, s);
  if (dtype == kF32) return (int)dispatch_gemv<float>(a, mt, int4, s);
  return (int)cudaErrorInvalidValue;
}

// q / scale the leaf as for strom_quant_gemv; out (E, K, N) in dtype;
// sms: the card's SM count (the grid is at most 8 blocks an SM).
extern "C" int strom_dequant(const void* q, const void* scale, void* out,
                             int E, int K, int N, int group, int bits,
                             int dtype, int sms, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_leaf(E, K, N, group, bits) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec_ok = N % kDequantVec == 0 && (uintptr_t)q % 8 == 0 &&
                     (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int4 = bits == 4;
  if (dtype == kBF16)
    return (int)run_dequant<__nv_bfloat16>(q, scale, out, E, K, N, group,
                                           int4, vec_ok, sms, s);
  if (dtype == kF16)
    return (int)run_dequant<__half>(q, scale, out, E, K, N, group, int4,
                                    vec_ok, sms, s);
  if (dtype == kF32)
    return (int)run_dequant<float>(q, scale, out, E, K, N, group, int4,
                                   vec_ok, sms, s);
  return (int)cudaErrorInvalidValue;
}
