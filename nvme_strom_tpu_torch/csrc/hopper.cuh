// hopper.cuh — the sm_90a building blocks of the tensor-core flash
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): mbarriers,
// TMA tile loads, wgmma descriptors and products, and the host-side
// tensor maps.  Raw PTX, no CUTLASS.
//
// Layout convention.  Every bf16 tile in shared memory is what a TMA
// load with 128-byte swizzle leaves there: a (rows, D) tile is D/64
// column chunks, each `rows` rows of 64 values (128 bytes, one swizzle
// row), the chunk 1024-byte aligned.  A wgmma operand descriptor reads
// such a chunk either
//   * K-major (the row's 64 values are the product's K): 8-row groups
//     1024 bytes apart (SBO); the K step of 16 values moves the start
//     address by 32 bytes inside the swizzle row, the next 64 values
//     are the next chunk;
//   * MN-major (the row index is the product's K, the 64 values its N):
//     8-row groups along K 1024 bytes apart (SBO), the next 64 values
//     of N one chunk further (LBO); the K step of 16 rows moves the
//     start address by 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace strom_hopper {

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that lasts this long means the pipeline is broken: the block
// traps (the launch then fails with an error) instead of hanging.
constexpr unsigned long long kHangNs = 2000000000ull;

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!bar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kHangNs) __trap();
  }
}

// -- TMA ----------------------------------------------------------------------

// One box of a 4-D tensor map (d, seq, head, batch) into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// A (rows, D) tile at `row` of one head: D/64 boxes of 64 columns.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, int rows,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int batch) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(dst + c * rows * 128, map, bar, c * 64, row, head, batch);
}

// -- wgmma --------------------------------------------------------------------

// Shared-memory operand descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand: K step `kk` (16 values) of a (rows, D) tile.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int kk) {
  return desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: K step `kk` (16 rows) of a (rows, D) tile whose 64
// value chunks are N.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int rows,
                                            int kk) {
  return desc(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulator registers must stay in place between a wgmma and its
// wait: this tells the compiler they are read and written there.
template <int R>
__device__ __forceinline__ void wg_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void wg_hold(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define STROM_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define STROM_ACC32 \
  STROM_ACC8(0), STROM_ACC8(8), STROM_ACC8(16), STROM_ACC8(24)
#define STROM_ACC64 \
  STROM_ACC32, STROM_ACC8(32), STROM_ACC8(40), STROM_ACC8(48), STROM_ACC8(56)

// d (64 x 64, fp32) = or += A · Bᵀ, A and B K-major from shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : STROM_ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) += A · B, A (64 x 16 bf16) in registers, B MN-major
// from shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : STROM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : STROM_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef STROM_ACC64
#undef STROM_ACC32
#undef STROM_ACC8

// -- registers ----------------------------------------------------------------

// Move registers between the warpgroups of a block (all 128 threads of
// the warpgroup execute it): a producer gives up, consumers take.
template <int N>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (flush-to-zero: results below 2^-126 read as 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- fragments ----------------------------------------------------------------
//
// A 64 x N fp32 accumulator: warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (g = lane / 4); d[4j + e] is column
// 8j + 2(lane % 4) + (e & 1) of row 16w + g + 8(e >> 1).  The A operand
// of a register wgmma (64 x 16, bf16) has the same rows and, for the
// K step kk, the columns 16kk .. 16kk + 15 of that accumulator in the
// same places, so a row of probabilities becomes the next product's A
// without leaving the registers.

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split x = hi + lo, both bf16: hi = bf16(x), lo = bf16(x − hi).  Two
// products into one fp32 accumulator then carry ~16 bits of x, where
// one bf16 operand carries 8 — which the kernels' one-ulp checks against
// fp32 need for the probabilities and dS.
template <int R>
__device__ __forceinline__ void split(const float (&x)[R],
                                      uint32_t (&hi)[R / 8][4],
                                      uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack(a - __low2float(h), b - __high2float(h));
    }
}

// -- host: tensor maps --------------------------------------------------------

// A (b, h, seq, D) bf16 view with element strides (sb, sh, ss), unit
// stride along D, as a 4-D map read in boxes of 64 columns x box_rows
// rows of one head, 128-byte swizzle; rows past `seq` read as zero.
inline bool encode_map(CUtensorMap* map, const void* base, long long sb,
                       long long sh, long long ss, int b, int h, int seq,
                       int d, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace strom_hopper
