// quant_matmul.cu — the weight-only int8 / int4 matmul for sm_90a: a
// fused product for the few rows of a decode or verify step (quant_gemv)
// and a one-pass dequantization (dequant).
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
// a 2-D weight.  The kernels read this layout as it is: no repacked copy.
// Each element is dequantized exactly as `wmat`'s torch ops round it:
//
//     w = rnd(float(q) * float(rnd(scale)))
//
// where rnd rounds to the compute dtype to nearest even (bf16 / fp16; the
// identity for fp32).  float(q) * float(rnd(scale)) is exact in fp32
// (8 by 8 or 11 bits), so the one rounding matches torch's.
//
// quant_gemv, bf16 / fp16 x (quant_gemv_tc): out[e, m, n] =
// sum_k x[e, m, k] * w[e, k, n], w never written anywhere.
//   Bound: bytes at decode rows — the weight is read once (1 byte an
//   element for int8, half a byte for int4), x, the scales and out are
//   small.  At 64 rows w_gate's 7.5 GFLOP take 7.6 us of bf16 tensor-core
//   peak against its 17.5 us of int8 bytes; past ~128 rows (int8) and
//   ~64 (int4) the tensor cores bind.  The CUDA-core FMA kernel below
//   pays M FMAs and ~4 dequant instructions an element and runs at
//   11-19% of the byte bound, its time growing with M.  This one runs
//   at 54-55% of the bound at 8 rows in int8 and 33-34% in int4 (H100,
//   PERF.md §6): a launch pays a fixed ~8-10 us (the grid's start, the
//   first stage's latency, the splits' in-order sum), and the copies
//   alone or the dequant and products alone (~50-65 instructions a warp
//   a k16 step) each take about the int8 byte time.
//   Design: the products run on the tensor cores as
//   mma.sync.m16n8k16 with A and B swapped — A = W^T (a row of A is an
//   output column n, 16 columns a tile), B = x^T (the rows of x in n8
//   tiles), C = out^T — so x's few rows are the narrow operand and the
//   CUDA cores keep only the dequant, once a weight element for all the
//   rows of the block's x.
//   Weight stream: a block of 4 warps holds 128 columns (32 a warp, two
//   m16 tiles) and walks its K split in stages of 64 byte rows x 128
//   columns (8 KiB: 64 int8 rows or 128 int4 rows) through a ring of 4
//   stages filled by cp.async 16-byte copies (8 or 4 bytes, or loads,
//   where the rows are not 16-byte aligned in memory: d_out 1000 / 1003,
//   an offset leaf), 3 stages in flight while one is consumed; the
//   block's rows of x for the stage go through the same ring.  16-byte
//   chunks of a stage row are XOR-swizzled so the fragment reads below
//   hit 32 different banks.
//   Fragments from 4-byte reads: inside an MMA tile the order of K and
//   of N is free, as long as x's fragment follows K's and the output is
//   written back in N's.  Lane (g, t) of a warp reads, each k16 step,
//   the 4 bytes of columns 4g..4g+3 of byte rows 4t..4t+3 (int8) or 2t,
//   2t+1 (int4: K rows 4t..4t+3), and column 4g + 2h + r is row g + 8r
//   of m16 tile h; the K slots (2t, 2t+1, 2t+8, 2t+9) are rows
//   4t..4t+3, so x's B fragment is one 8-byte read of 4 consecutive x
//   elements.  An int4 byte is exactly one A register ((k, k+1) of a
//   column); int8 pairs come from two rows' words by byte permutes.
//   Dequant in registers with exact magic numbers, then one __hmul2 by
//   the column's scale rounded to the compute type (int4: the scale of
//   the pair's own group, row / g, for any even g; a group a multiple of
//   16 switches once per group, the next group's scales loaded ahead):
//     int4 -> bf16  (0x4300 | nibble) - 136
//     int4 -> fp16  (0x6400 | nibble) - 1032
//     int8 -> fp16  (0x6400 | (b ^ 0x80)) - 1152
//     int8 -> bf16  via fp32: (2^23 + (b ^ 0x80)) - (2^23 + 128), upper half
//   all exact, so the weight is bitwise dequant's.
//   Grid: (row tiles x column tiles, K splits, E); the row tile (8, 16,
//   32 or 64 rows of x; 64-row tiles past 64 rows) varies fastest so the
//   tiles that share a weight tile run together and meet it in L2.  The
//   split count is the wrapper's (ops/quant_matmul.py `kernel_launch`):
//   enough blocks for every SM to stream.  With one split the block
//   rounds and writes the output; with more each writes its f32 partials
//   to the workspace, and a second launch (quant_gemv_combine) sums them
//   in split order and rounds once.  No floating-point atomics: two
//   calls are bitwise equal.
//
// quant_gemv, float32 x (quant_gemv_split): the CUDA-core kernel, kept
// for float32 because a tensor-core fp32 product would be TF32 (10-bit
// mantissa) and miss the fp32 tolerance of 1e-5.  A block of 4 warps
// takes 32 x VEC columns, each lane VEC neighbouring columns loaded as
// one vector a row; x rows staged in shared memory as f32; the MT x VEC
// partial sums in registers, the warps summed in shared memory in warp
// order; K splits combined by a second launch in split order.
//
// dequant: writes `wmat`'s weight (E, K, N) in the compute dtype in one
// pass, reading the quantized bytes once, bitwise equal to the torch
// ops.  Bound: bytes (the quantized bytes and scales read, the weight
// written).  A thread takes VEC columns of one row (a packed row pair for
// int4): one vector load of the quantized bytes, vector stores of the
// dequantized row(s).
//
// The fp16 cases are a translation unit of their own
// (quant_matmul_f16.cu includes this file with STROM_QUANT_F16_TU), so
// nvcc builds them in parallel with the bf16 and fp32 ones.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// element types by their code in ops/quant_matmul.py KERNEL_DTYPES
constexpr int kBF16 = 0;
constexpr int kF32 = 1;
constexpr int kF16 = 2;

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

bool valid_leaf(int E, int K, int N, int group, int bits) {
  if (E <= 0 || K <= 0 || N <= 0 || group <= 0 || K % group) return false;
  if (bits == 4) return K % 2 == 0 && group % 2 == 0;
  return bits == 8;
}

// out = the splits' partials (n_splits planes of f32 in ws) summed in
// split order from the first, rounded once; kAhead splits' loads in
// flight at a time.  Both GEMVs' K splits end here.
template <typename T>
__global__ void __launch_bounds__(256)
quant_gemv_combine(const float* __restrict__ ws, T* __restrict__ out,
                   size_t plane, int n_splits) {
  constexpr int kAhead = 8;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        v[k] = s0 + k < n_splits ? ws[(size_t)(s0 + k) * plane + i] : 0.f;
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        if (s0 + k < n_splits) sum = s0 + k == 0 ? v[k] : sum + v[k];
    }
    out[i] = Num<T>::store(sum);
  }
}

int grid_of(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 65536 * 8 ? blocks : 65536 * 8);
}

// -- the tensor-core GEMV (bf16 / fp16 x) ------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcCols = 32 * kTcWarps;        // output columns a block
constexpr int kByteRows = 64;                 // weight byte rows a stage
constexpr int kStageW = kByteRows * kTcCols;  // weight bytes a stage
constexpr int kStages = 4;                    // the ring: kStages - 1 in
                                              // flight
constexpr int kMinBlocks = 3;                 // blocks a SM the registers
                                              // leave room for
constexpr int kChunks = kTcCols / 16;         // 16-byte chunks a row

struct TcArgs {
  const void* x;          // (E, M, K) in T
  const uint8_t* q;       // (E, K, N) int8 or (E, K/2, N) packed int4
  const float* scale;     // (E, 1, N) or (E, G, 1, N)
  void* out;              // (E, M, N) in T
  float* ws;              // (n_splits, E, M, N) f32 when n_splits > 1
  int E, M, K, N;
  int group;              // int4: rows a scale group holds; int8: K
  int split_rows;         // rows a split holds (a multiple of 16)
  int n_splits;
  int row_tiles;          // ceil(M / MT)
  int col_tiles;          // ceil(N / kTcCols)
  int q_width;            // bytes a weight copy moves: 16, 8, 4 or 1
  int x_vec;              // x rows whole 16-byte chunks: cp.async
  int s_vec;              // scale rows 16-byte aligned: vector loads
  int o_vec;              // out / ws take 4-column vector stores
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes, the first `bytes` of them read from src and
// the rest zero (bytes 0: nothing read, all zero)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a weight row into shared memory: `valid` bytes
// (0..16, whole copies of `width`) from src, zeros past them.  Width 1
// (rows not 4-byte aligned in memory) loads the bytes and stores them.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           const uint8_t* base, int valid,
                                           int width) {
  if (width == 16) {
    cp_async16(dst, valid > 0 ? src : base, valid > 0 ? 16 : 0);
  } else if (width == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = valid >= 8 * h + 8;
      cp_async8(dst + 8 * h, ok ? src + 8 * h : base, ok ? 8 : 0);
    }
  } else if (width == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const bool ok = valid >= 4 * h + 4;
      cp_async4(dst + 4 * h, ok ? src + 4 * h : base, ok ? 4 : 0);
    }
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) v[b >> 2] |= (uint32_t)__ldg(src + b) << (8 * (b & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// __byte_perm(a, b, SEL) with SEL an immediate: b (a constant shared by
// many permutes) is then kept in a register, not each selector
template <uint32_t SEL>
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "n"(SEL));
  return d;
}

// a constant the compiler cannot fold into an instruction's immediate
template <uint32_t V>
__device__ __forceinline__ uint32_t reg_const() {
  uint32_t d;
  asm("mov.b32 %0, %1;\n" : "=r"(d) : "n"(V));
  return d;
}

// The compute type's tensor-core product and exact conversions; every
// 32-bit value is a pair of T, the lower half first.
template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static constexpr uint32_t kI4Magic = 0x43004300u;  // 128 + nibble
  static constexpr uint32_t kI4Bias = 0x43084308u;   // 136
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t v) {
    return *reinterpret_cast<__nv_bfloat162*>(&v);
  }
  // {rnd(s), rnd(s)}
  static __device__ __forceinline__ uint32_t scale2(float s) {
    return bits(__float2bfloat162_rn(s));
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    return bits(__hmul2(pair(a), pair(b)));
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    return bits(__hsub2(pair(a), pair(b)));
  }
  static __device__ __forceinline__ uint32_t round2(float lo, float hi) {
    return bits(__floats2bfloat162_rn(lo, hi));
  }
  // r[i] = {q of byte i of w0, q of byte i of w1}, w0 / w1 int8 words
  // already XORed with 0x80808080 (each byte q + 128): 2^23 + u in fp32
  // less 2^23 + 128 is q, exact, and its upper half is q in bf16.
  static __device__ __forceinline__ void i8_pairs(uint32_t w0, uint32_t w1,
                                                  uint32_t (&r)[4]) {
    const uint32_t magic = reg_const<0x4B000000u>();
    float f0[4], f1[4];
    f0[0] = __uint_as_float(prmt<0x7440u>(w0, magic));
    f0[1] = __uint_as_float(prmt<0x7441u>(w0, magic));
    f0[2] = __uint_as_float(prmt<0x7442u>(w0, magic));
    f0[3] = __uint_as_float(prmt<0x7443u>(w0, magic));
    f1[0] = __uint_as_float(prmt<0x7440u>(w1, magic));
    f1[1] = __uint_as_float(prmt<0x7441u>(w1, magic));
    f1[2] = __uint_as_float(prmt<0x7442u>(w1, magic));
    f1[3] = __uint_as_float(prmt<0x7443u>(w1, magic));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = prmt<0x7632u>(__float_as_uint(f0[i] - 8388736.f),
                           __float_as_uint(f1[i] - 8388736.f));
  }
};

template <>
struct Tc<__half> {
  static constexpr uint32_t kI4Magic = 0x64006400u;  // 1024 + nibble
  static constexpr uint32_t kI4Bias = 0x64086408u;   // 1032
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t bits(__half2 v) {
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half2 pair(uint32_t v) {
    return *reinterpret_cast<__half2*>(&v);
  }
  static __device__ __forceinline__ uint32_t scale2(float s) {
    return bits(__float2half2_rn(s));
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    return bits(__hmul2(pair(a), pair(b)));
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    return bits(__hsub2(pair(a), pair(b)));
  }
  static __device__ __forceinline__ uint32_t round2(float lo, float hi) {
    return bits(__floats2half2_rn(lo, hi));
  }
  // as Tc<bf16>::i8_pairs: bytes interleaved, then 0x64 above each byte
  // is 1024 + u in fp16, less 1152 is q, exact
  static __device__ __forceinline__ void i8_pairs(uint32_t w0, uint32_t w1,
                                                  uint32_t (&r)[4]) {
    const uint32_t lo = prmt<0x5140u>(w0, w1);  // b0 of w0, w1, b1 of ..
    const uint32_t hi = prmt<0x7362u>(w0, w1);
    const uint32_t magic = reg_const<0x64646464u>();
    const uint32_t bias = 0x64806480u;          // 1152
    r[0] = sub(prmt<0x4140u>(lo, magic), bias);
    r[1] = sub(prmt<0x4342u>(lo, magic), bias);
    r[2] = sub(prmt<0x4140u>(hi, magic), bias);
    r[3] = sub(prmt<0x4342u>(hi, magic), bias);
  }
};

// r[i] = {q of the low nibble of byte i, q of its high nibble}: the
// (k, k+1) pair of column i, exact
template <typename T>
__device__ __forceinline__ void i4_pairs(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t wh = w >> 4;
  uint32_t v[4];
  v[0] = prmt<0x4400u>(w, wh);        // [b_i, b_i, (w >> 4)_i, ..]
  v[1] = prmt<0x5511u>(w, wh);
  v[2] = prmt<0x6622u>(w, wh);
  v[3] = prmt<0x7733u>(w, wh);
  const uint32_t magic = reg_const<Tc<T>::kI4Magic>();   // one LOP3 each
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = Tc<T>::sub((v[i] & 0x000F000Fu) | magic, Tc<T>::kI4Bias);
}

// scales of columns c0..c0+3 of one scale row as {rnd(s), rnd(s)} pairs
// (0 past n)
template <typename T>
__device__ __forceinline__ void scale_pairs(const float* row, int c0, int n,
                                            bool vec, uint32_t (&s)[4]) {
  float f[4];
  if (vec && c0 + 3 < n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = c0 + i < n ? __ldg(row + c0 + i) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = Tc<T>::scale2(f[i]);
}

// NT: n8 tiles of x rows a block holds (MT = 8 NT rows).  GFAST: int4
// groups a multiple of 16 rows (one group a k16 step).
template <typename T, bool INT4, int NT, bool GFAST>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks)
quant_gemv_tc(TcArgs a) {
  constexpr int BK = INT4 ? 2 * kByteRows : kByteRows;  // K rows a stage
  constexpr int MT = 8 * NT;
  constexpr int XS = BK + 16;          // x row stride: 8-byte reads of 4
                                       // rows x 4 lanes hit 32 banks
  constexpr int SH = INT4 ? 1 : 2;     // byte row >> SH picks the swizzle
  constexpr int STEP_ROWS = INT4 ? 8 : 16;   // byte rows a k16 step
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wsm = smem;
  uint16_t* xsm = reinterpret_cast<uint16_t*>(smem + kStages * kStageW);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = blockIdx.x % a.row_tiles;
  const int ct = blockIdx.x / a.row_tiles;
  const int e = blockIdx.z;
  const int m0 = rt * MT, n0 = ct * kTcCols;
  const int k_begin = blockIdx.y * a.split_rows;
  const int k_end = min(a.K, k_begin + a.split_rows);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  const int KR = INT4 ? a.K / 2 : a.K;
  const int kr_end = INT4 ? k_end / 2 : k_end;
  const uint8_t* q = a.q + (size_t)e * KR * a.N;
  const uint16_t* x =
      static_cast<const uint16_t*>(a.x) + (size_t)e * a.M * a.K;
  const int n_groups = a.K / a.group;
  const float* scale = a.scale + (size_t)e * (INT4 ? n_groups : 1) * a.N;
  const int col = n0 + 32 * warp + 4 * g;     // this lane's 4 columns

  // one stage (K rows [k0, k0 + BK) of the split) into ring slot `slot`
  auto load_stage = [&](int st, int slot) {
    const int k0 = k_begin + st * BK;
    const int kr0 = INT4 ? k0 / 2 : k0;
    uint8_t* wd = wsm + slot * kStageW;
    const int c = tid % kChunks;
    const int cn = n0 + 16 * c;
    const int cvalid = min(16, max(0, a.N - cn));
#pragma unroll
    for (int j = 0; j < kByteRows / 16; ++j) {   // 16 rows a pass
      const int r = tid / kChunks + 16 * j;
      const int valid = kr0 + r < kr_end ? cvalid : 0;
      copy_chunk(wd + r * kTcCols + ((c ^ (((r >> SH) & 3) << 1)) << 4),
                 q + (size_t)(kr0 + r) * a.N + cn, a.q, valid, a.q_width);
    }
    uint16_t* xd = xsm + slot * (MT * XS);
    if (a.x_vec) {
      for (int i = tid; i < MT * (BK / 8); i += kTcThreads) {
        const int mm = i / (BK / 8), kc = (i % (BK / 8)) * 8;
        const bool ok = m0 + mm < a.M && k0 + kc < k_end;
        cp_async16(xd + mm * XS + kc,
                   ok ? x + (size_t)(m0 + mm) * a.K + k0 + kc : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < MT * BK; i += kTcThreads) {
        const int mm = i / BK, kk = i % BK;
        xd[mm * XS + kk] = m0 + mm < a.M && k0 + kk < k_end
                               ? x[(size_t)(m0 + mm) * a.K + k0 + kk]
                               : (uint16_t)0;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[h][j][v] = 0.f;

  // this lane's fragment reads: the 4-byte word of columns 4g..4g+3 in
  // its rows (swizzled chunk 2 (warp ^ t) + g / 4), and x's rows g + 8j
  // at K 4t..4t+3
  const int w_off = STEP_ROWS / 4 * t * kTcCols +
                    ((2 * (warp ^ t) + (g >> 2)) << 4) + ((g & 3) << 2);
  const int x_off = g * XS + 4 * t;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }

  // the scales, loaded behind the first stages' copies: int8 one a
  // column; int4 those of the current group (and, GFAST,
  // the next group's ahead), or for a group not a multiple of 16
  // those of each of the lane's two K row pairs
  uint32_t sp[4], sq[4];          // scales of the P and Q pairs
  float ahead[4];
  int grp = 0, next_k = 0, grp_q = -1;
  if (!INT4) {
    scale_pairs<T>(scale, col, a.N, a.s_vec, sp);
  } else if (GFAST) {
    grp = k_begin / a.group;
    next_k = (grp + 1) * a.group;
    scale_pairs<T>(scale + (size_t)grp * a.N, col, a.N, a.s_vec, sp);
    const float* nrow = scale + (size_t)min(grp + 1, n_groups - 1) * a.N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ahead[i] = col + i < a.N ? __ldg(nrow + col + i) : 0.f;
  } else {
    grp = -1;
  }

#pragma unroll 1
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < n_stages)
      load_stage(st + kStages - 1, (st + kStages - 1) % kStages);
    cp_async_commit();
    const int slot = st % kStages;
    const int k0 = k_begin + st * BK;
    const int rows = min(BK, k_end - k0);
    const uint8_t* wb = wsm + slot * kStageW + w_off;
    const uint16_t* xb = xsm + slot * (MT * XS) + x_off;
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      if (16 * s >= rows) break;
      const int k = k0 + 16 * s;
      uint32_t P[4], Q[4];
      if (INT4) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            wb + (STEP_ROWS * s) * kTcCols);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            wb + (STEP_ROWS * s + 1) * kTcCols);
        i4_pairs<T>(w0, P);
        i4_pairs<T>(w1, Q);
        if (GFAST) {
          if (k >= next_k) {            // uniform: every lane, same k
            ++grp;
            next_k += a.group;
#pragma unroll
            for (int i = 0; i < 4; ++i) sp[i] = Tc<T>::scale2(ahead[i]);
            const float* nrow =
                scale + (size_t)min(grp + 1, n_groups - 1) * a.N;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              ahead[i] = col + i < a.N ? __ldg(nrow + col + i) : 0.f;
          }
        } else {
          const int gp = min((k + 4 * t) / a.group, n_groups - 1);
          const int gq = min((k + 4 * t + 2) / a.group, n_groups - 1);
          if (gp != grp) {
            grp = gp;
            scale_pairs<T>(scale + (size_t)gp * a.N, col, a.N, a.s_vec, sp);
          }
          if (gq != grp_q) {
            grp_q = gq;
            scale_pairs<T>(scale + (size_t)gq * a.N, col, a.N, a.s_vec, sq);
          }
        }
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const uint32_t*>(
                     wb + (STEP_ROWS * s + j) * kTcCols) ^
                 0x80808080u;
        Tc<T>::i8_pairs(w[0], w[1], P);
        Tc<T>::i8_pairs(w[2], w[3], Q);
      }
      const uint32_t(&sQ)[4] = (INT4 && !GFAST) ? sq : sp;
      // m16 tile h: rows g / g + 8 are columns 4g + 2h / 4g + 2h + 1
      uint32_t A[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        A[h][0] = Tc<T>::mul(P[2 * h], sp[2 * h]);
        A[h][1] = Tc<T>::mul(P[2 * h + 1], sp[2 * h + 1]);
        A[h][2] = Tc<T>::mul(Q[2 * h], sQ[2 * h]);
        A[h][3] = Tc<T>::mul(Q[2 * h + 1], sQ[2 * h + 1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(xb + 8 * j * XS + 16 * s);
        Tc<T>::mma(acc[0][j], A[0], b.x, b.y);
        Tc<T>::mma(acc[1][j], A[1], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();

  // lane (g, t) holds columns col..col+3 of rows m0 + 8j + 2t (+1):
  // column col + 2h + r is C row g + 8r of tile h, element 2r (+1)
  const bool whole = a.n_splits == 1;
  const size_t plane = (size_t)a.E * a.M * a.N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 8 * j + 2 * t + r;
      if (m >= a.M) continue;
      const float v[4] = {acc[0][j][r], acc[0][j][2 + r], acc[1][j][r],
                          acc[1][j][2 + r]};
      const size_t o = ((size_t)e * a.M + m) * a.N + col;
      if (whole) {
        T* out = static_cast<T*>(a.out);
        if (a.o_vec && col + 3 < a.N) {
          *reinterpret_cast<uint2*>(out + o) = make_uint2(
              Tc<T>::round2(v[0], v[1]), Tc<T>::round2(v[2], v[3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < a.N) out[o + i] = Num<T>::store(v[i]);
        }
      } else {
        float* ws = a.ws + blockIdx.y * plane;
        if (a.o_vec && col + 3 < a.N) {
          *reinterpret_cast<float4*>(ws + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < a.N) ws[o + i] = v[i];
        }
      }
    }
  }
}

// the ring's shared memory: kStages stages of weight bytes and the
// tile's rows of x over the stage's K (16 elements of padding a row)
template <bool INT4, int NT>
constexpr int tc_smem() {
  return kStages * (kStageW + 8 * NT * ((INT4 ? 2 : 1) * kByteRows + 16) * 2);
}

// above 48 KiB of dynamic shared memory a kernel must ask, once a card
// (every launch on a card past the mask's 64)
template <typename T, bool INT4, int NT, bool GFAST>
cudaError_t prepare_tc(int device) {
  static std::atomic<unsigned long long> asked{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (tc_smem<INT4, NT>() > 48 * 1024 &&
      !(asked.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_gemv_tc<T, INT4, NT, GFAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tc_smem<INT4, NT>());
    if (e != cudaSuccess) return e;
    asked.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <typename T, bool INT4, int NT, bool GFAST>
cudaError_t launch_tc(const TcArgs& a, int device, cudaStream_t s) {
  const cudaError_t e = prepare_tc<T, INT4, NT, GFAST>(device);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.row_tiles * a.col_tiles, a.n_splits, a.E);
  quant_gemv_tc<T, INT4, NT, GFAST>
      <<<grid, kTcThreads, tc_smem<INT4, NT>(), s>>>(a);
  return cudaGetLastError();
}

// Blocks of the GEMV at NT n8 tiles that share a SM on `device`, as the
// runtime counts them: kMinBlocks (what __launch_bounds__ holds every
// instantiation's registers to), or fewer where the ring's shared memory
// runs out.  One bf16 instantiation stands for the others of its ring:
// the same shared memory, the same bounds.
template <bool INT4, int NT>
cudaError_t resident_tc(int device, int* blocks) {
  cudaError_t e = prepare_tc<__nv_bfloat16, INT4, NT, INT4>(device);
  if (e != cudaSuccess) return e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, quant_gemv_tc<__nv_bfloat16, INT4, NT, INT4>, kTcThreads,
      tc_smem<INT4, NT>());
  if (e != cudaSuccess) return e;
  *blocks = n < kMinBlocks ? n : kMinBlocks;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, int NT>
cudaError_t launch_tc_bits(const TcArgs& a, bool int4, int device,
                           cudaStream_t s) {
  if (!int4) return launch_tc<T, false, NT, false>(a, device, s);
  if (a.group % 16 == 0) return launch_tc<T, true, NT, true>(a, device, s);
  return launch_tc<T, true, NT, false>(a, device, s);
}

// n8 tiles of x rows a block holds: 1, 2, 4 or 8 (rows up to 8, 16, 32,
// then tiles of 64).  The wrapper mirrors this (ops/quant_matmul.py
// `row_tile`).
int tc_tiles(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8; }

template <typename T>
cudaError_t run_tc(const void* x, const void* q, const void* scale,
                   void* out, void* ws, int E, int M, int K, int N,
                   int group, bool int4, int split_rows, int device,
                   cudaStream_t s) {
  const int nt = tc_tiles(M);
  const int row_tiles = (M + 8 * nt - 1) / (8 * nt);
  const int col_tiles = (N + kTcCols - 1) / kTcCols;
  const int n_splits = (K + split_rows - 1) / split_rows;
  if (split_rows % 16 || n_splits > 65535 || E > 65535 ||
      (long long)row_tiles * col_tiles > 0x7FFFFFFFll ||
      (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const uintptr_t qa = (uintptr_t)q;
  const int q_width = N % 16 == 0 && qa % 16 == 0 ? 16
                      : N % 8 == 0 && qa % 8 == 0 ? 8
                      : N % 4 == 0 && qa % 4 == 0 ? 4
                                                  : 1;
  const int o_vec = N % 4 == 0 && (uintptr_t)out % 8 == 0 &&
                    (uintptr_t)ws % 16 == 0;
  const TcArgs a{x, static_cast<const uint8_t*>(q),
                 static_cast<const float*>(scale), out,
                 static_cast<float*>(ws), E, M, K, N, int4 ? group : K,
                 split_rows, n_splits,
                 row_tiles, col_tiles, q_width,
                 K % 8 == 0 && (uintptr_t)x % 16 == 0,
                 N % 4 == 0 && (uintptr_t)scale % 16 == 0, o_vec};
  cudaError_t e;
  switch (nt) {
    case 1: e = launch_tc_bits<T, 1>(a, int4, device, s); break;
    case 2: e = launch_tc_bits<T, 2>(a, int4, device, s); break;
    case 4: e = launch_tc_bits<T, 4>(a, int4, device, s); break;
    default: e = launch_tc_bits<T, 8>(a, int4, device, s); break;
  }
  if (e != cudaSuccess || n_splits == 1) return e;
  const size_t plane = (size_t)E * M * N;
  quant_gemv_combine<T><<<grid_of(plane, 256), 256, 0, s>>>(
      a.ws, static_cast<T*>(out), plane, n_splits);
  return cudaGetLastError();
}

// -- the CUDA-core GEMV (float32 x) ------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// quantized rows (int8) or packed row pairs (int4) a warp takes of a tile
constexpr int kUnitsPerWarp = 8;
constexpr int kTileUnits = kWarps * kUnitsPerWarp;

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
// this (ops/quant_matmul.py `fma_row_tile`).
template <typename T>
cudaError_t run_fma(const void* x, const void* q, const void* scale,
                    void* out, void* ws, int E, int M, int K, int N,
                    int group, bool int4, int split_rows, cudaStream_t s) {
  const int n_splits = (K + split_rows - 1) / split_rows;
  const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const int vec = mt == 16 ? 4 : 8;
  const int row_tiles = (M + mt - 1) / mt;
  if (n_splits > 65535 || (long long)E * row_tiles > 65535 ||
      (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int vec_ok = N % vec == 0 && (uintptr_t)q % vec == 0;
  const GemvArgs a{x, static_cast<const uint8_t*>(q),
                   static_cast<const float*>(scale), out,
                   static_cast<float*>(ws), E, M, K, N, group, split_rows,
                   n_splits, row_tiles, vec_ok};
  switch (mt) {
    case 1: return run_gemv<T, 1, 8>(a, int4, s);
    case 2: return run_gemv<T, 2, 8>(a, int4, s);
    case 4: return run_gemv<T, 4, 8>(a, int4, s);
    case 8: return run_gemv<T, 8, 8>(a, int4, s);
    default: return run_gemv<T, 16, 4>(a, int4, s);
  }
}

// -- dequant ------------------------------------------------------------------

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

}  // namespace

// The fp16 unit (quant_matmul_f16.cu) includes this file with
// STROM_QUANT_F16_TU defined: its entry points are strom_quant_gemv_f16
// and strom_dequant_f16, to which this unit's entry points hand fp16
// calls.
#ifdef STROM_QUANT_F16_TU
#define STROM_QUANT_GEMV_ENTRY strom_quant_gemv_f16
#define STROM_DEQUANT_ENTRY strom_dequant_f16
#else
#define STROM_QUANT_GEMV_ENTRY strom_quant_gemv
#define STROM_DEQUANT_ENTRY strom_dequant
extern "C" int strom_quant_gemv_f16(const void* x, const void* q,
                                    const void* scale, void* out, void* ws,
                                    int E, int M, int K, int N, int group,
                                    int bits, int split_rows, int dtype,
                                    void* stream, int device);
extern "C" int strom_dequant_f16(const void* q, const void* scale, void* out,
                                 int E, int K, int N, int group, int bits,
                                 int dtype, int sms, void* stream,
                                 int device);
#endif

// x (E, M, K), q / scale the leaf (bits 8: q8, scale; bits 4: q4,
// scale4 with `group` rows a scale; bits 8 takes group = K), out
// (E, M, N); split_rows: rows a split holds (the wrapper's
// `kernel_launch` for bf16 / fp16, a multiple of 16; `fma_launch` for
// fp32, even for int4); ws: the f32 (n_splits, E, M, N) workspace where
// ceil(K / split_rows) > 1, else null.
extern "C" int STROM_QUANT_GEMV_ENTRY(const void* x, const void* q,
                                      const void* scale, void* out, void* ws,
                                      int E, int M, int K, int N, int group,
                                      int bits, int split_rows, int dtype,
                                      void* stream, int device) {
#ifndef STROM_QUANT_F16_TU
  if (dtype == kF16)
    return strom_quant_gemv_f16(x, q, scale, out, ws, E, M, K, N, group,
                                bits, split_rows, dtype, stream, device);
#endif
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_leaf(E, K, N, group, bits) || M <= 0 || split_rows <= 0 ||
      (bits == 4 && split_rows % 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int4 = bits == 4;
#ifdef STROM_QUANT_F16_TU
  if (dtype == kF16)
    return (int)run_tc<__half>(x, q, scale, out, ws, E, M, K, N, group,
                               int4, split_rows, device, s);
#else
  if (dtype == kBF16)
    return (int)run_tc<__nv_bfloat16>(x, q, scale, out, ws, E, M, K, N,
                                      group, int4, split_rows, device, s);
  if (dtype == kF32)
    return (int)run_fma<float>(x, q, scale, out, ws, E, M, K, N, group,
                               int4, split_rows, s);
#endif
  return (int)cudaErrorInvalidValue;
}

#ifndef STROM_QUANT_F16_TU
// blocks (written) of the bf16 / fp16 GEMV over M rows of x and a weight
// of `bits` that share one SM of `device`: the split plan of the wrapper
// (ops/quant_matmul.py `kernel_launch`) fills one wave of them.
extern "C" int strom_quant_gemv_blocks(int M, int bits, int device,
                                       int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0 || (bits != 4 && bits != 8) || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool int4 = bits == 4;
  switch (tc_tiles(M)) {
    case 1:
      return (int)(int4 ? resident_tc<true, 1>(device, blocks)
                        : resident_tc<false, 1>(device, blocks));
    case 2:
      return (int)(int4 ? resident_tc<true, 2>(device, blocks)
                        : resident_tc<false, 2>(device, blocks));
    case 4:
      return (int)(int4 ? resident_tc<true, 4>(device, blocks)
                        : resident_tc<false, 4>(device, blocks));
    default:
      return (int)(int4 ? resident_tc<true, 8>(device, blocks)
                        : resident_tc<false, 8>(device, blocks));
  }
}
#endif

// q / scale the leaf as for strom_quant_gemv; out (E, K, N) in dtype;
// sms: the card's SM count (the grid is at most 8 blocks an SM).
extern "C" int STROM_DEQUANT_ENTRY(const void* q, const void* scale,
                                   void* out, int E, int K, int N, int group,
                                   int bits, int dtype, int sms, void* stream,
                                   int device) {
#ifndef STROM_QUANT_F16_TU
  if (dtype == kF16)
    return strom_dequant_f16(q, scale, out, E, K, N, group, bits, dtype, sms,
                             stream, device);
#endif
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_leaf(E, K, N, group, bits) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec_ok = N % kDequantVec == 0 && (uintptr_t)q % 8 == 0 &&
                     (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int4 = bits == 4;
#ifdef STROM_QUANT_F16_TU
  if (dtype == kF16)
    return (int)run_dequant<__half>(q, scale, out, E, K, N, group, int4,
                                    vec_ok, sms, s);
#else
  if (dtype == kBF16)
    return (int)run_dequant<__nv_bfloat16>(q, scale, out, E, K, N, group,
                                           int4, vec_ok, sms, s);
  if (dtype == kF32)
    return (int)run_dequant<float>(q, scale, out, E, K, N, group, int4,
                                   vec_ok, sms, s);
#endif
  return (int)cudaErrorInvalidValue;
}
