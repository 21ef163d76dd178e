// h2d_copy.cu — host→device byte copy driven by the SMs, and the
// page-locking helpers the bridge needs around it.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/bridge.py `_pallas_h2d`
// (`_dma_kernel`): one asynchronous copy of a pinned host array into
// device memory.  Here the GPU itself reads the page-locked host buffer
// over PCIe through its mapped device pointer and writes device memory,
// on the bridge's side stream, so the NVMe read of chunk K+1 overlaps
// the host→device hop of chunk K exactly as on the TPU.
//
// Bound: the host link.  Every byte crosses PCIe once (Gen5 x16: about
// 64 GB/s each way); the device-memory write is ~50x cheaper.
//
// What bounds the kernel below the link.  The GPU's own reads of mapped
// host memory reach 27-34 GB/s at 4 MiB a launch on some H100 80GB HBM3
// hosts (700 W) and ~47 GB/s on another, where the copy engine (`copy_`)
// reaches 40-51 GB/s on the same links; within one host, no design of
// the kernel moves that.  Seventeen designs were timed at 4 MiB and
// 64 MiB a launch: 1, 2, 4 or 8 loads a thread in flight, 1 to 8 blocks
// an SM, L2 prefetch sizes of 128 and 256 bytes, the non-coherent load
// path, warp-contiguous 2 KiB runs and bulk copies issued by the TMA
// unit (8-32 KiB pieces through a ring in shared memory).  All landed
// within ~1 GB/s of each other, inside their round-to-round spread.  The
// plateau is the same for the SMs' load units and for the TMA unit, so
// the limit is past the SM: in how the host and the GPU serve the GPU's
// own reads of host memory, which the copy engine does not share and a
// kernel cannot change.
//
// Design shipped (`kDesigns[0]`): the SMs read 16-byte words of the
// mapped host buffer in a grid-stride loop, two independent loads a
// thread in flight and the grid sized so each thread makes two (a 4 MiB
// chunk: 512 blocks of 256 threads), at most 8 blocks an SM.  No design
// led by more than its spread; this one had the best medians at 4 MiB.
// chip_smoke.py's probe (`strom_h2d_copy_probe`) times it beside two
// others, so the finding is checked again on every host:
//   * four loads a thread unrolled, the grid sized for one a thread, at
//     most 8 blocks an SM (the kernel's first shape);
//   * bulk copies: one thread of a block streams 8 KiB pieces through a
//     ring of 4 in shared memory with `cp.async.bulk` (global→shared,
//     completing on an mbarrier, then shared→global in a bulk group), at
//     most 4 blocks an SM, so the TMA unit, not the SMs' load units,
//     issues the link's read requests.  It accepts a host-mapped source
//     and copies it byte for byte.
// A body whose source and destination differ in alignment mod 16 takes
// the SM-load path whatever the design: each warp reads aligned 16-byte
// words, passes each to its left neighbour with one shuffle, and
// funnel-shifts the two into the misaligned output word, so the host
// bytes still cross the link once in 16-byte requests.  The head bytes
// before the destination's first 16-byte boundary and the tail after the
// last full word go bytewise.
//
// An aligned 16-byte word that holds at least one byte of the source
// lies on the same page as that byte, so it is mapped whenever the
// byte is: reading the whole word never touches memory outside the
// registered or pinned pages.  The bulk path reads exactly the body.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hx = strom_hopper;

constexpr int kThreads = 256;      // SM-load blocks
constexpr int kBulkThreads = 32;   // bulk blocks: one issues, all do edges
constexpr int kPiece = 8 << 10;    // bulk: bytes of one copy
constexpr int kStages = 4;         // bulk: pieces in flight a block

struct Design {
  bool bulk;          // bulk copies, else SM loads
  int unroll;         // SM loads: 2 or 4 loads a thread in flight
  int per_thread;     // SM loads: grid sized for this many loads a thread
  int blocks_per_sm;  // cap of the grid
};

// the shipped design first, then the probe's two others (see above)
constexpr Design kDesigns[] = {
    {false, 2, 2, 8}, {false, 4, 1, 8}, {true, 0, 1, 4}};
constexpr int kNumDesigns = sizeof(kDesigns) / sizeof(kDesigns[0]);

// Bytes [0, head) and [tail, n), one a thread.
__device__ __forceinline__ void copy_edges(const uint8_t* src, uint8_t* dst,
                                           uint64_t n, uint64_t head,
                                           uint64_t tail) {
  const uint64_t tid = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  const uint64_t nthreads = (uint64_t)gridDim.x * blockDim.x;
  if (tid < head) dst[tid] = src[tid];
  for (uint64_t i = tail + tid; i < n; i += nthreads) dst[i] = src[i];
}

// Source and destination of the body both 16-byte aligned: U loads a
// thread in flight per trip, the u-th of them one grid's width apart.
template <int U>
__global__ void __launch_bounds__(kThreads)
h2d_words(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
          uint64_t n, uint64_t head, uint64_t nvec) {
  copy_edges(src, dst, n, head, head + nvec * 16);
  const uint64_t tid = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  const uint64_t nthreads = (uint64_t)gridDim.x * blockDim.x;
  const uint4* in = reinterpret_cast<const uint4*>(src + head);
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  // a trip covers U·nthreads words from w0; load u of this thread:
  auto at = [&](uint64_t w0, int u) { return w0 + tid + u * nthreads; };
  const uint64_t per_trip = U * nthreads;
  uint64_t w0 = 0;
  for (; w0 + per_trip <= nvec; w0 += per_trip) {
    uint4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = in[at(w0, u)];
#pragma unroll
    for (int u = 0; u < U; ++u) out[at(w0, u)] = w[u];
  }
  // the last, partial trip: the loads that fall before nvec, still all
  // in flight together
  uint4 w[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (at(w0, u) < nvec) w[u] = in[at(w0, u)];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (at(w0, u) < nvec) out[at(w0, u)] = w[u];
}

template <int MIS>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&w)[8], int j) {
  constexpr int q = MIS / 4;
  constexpr int r = (MIS % 4) * 8;
  if (r == 0) return w[q + j];
  return __funnelshift_r(w[q + j], w[q + j + 1], r);
}

// MIS = (source address of the body) mod 16, 1..15, a compile-time
// constant so the funnel shift indexes registers, never local memory.
template <int MIS>
__global__ void __launch_bounds__(kThreads)
h2d_shifted(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            uint64_t n, uint64_t head, uint64_t nvec) {
  copy_edges(src, dst, n, head, head + nvec * 16);
  const uint64_t tid = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  const uint64_t nthreads = (uint64_t)gridDim.x * blockDim.x;
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  const uint4* in = reinterpret_cast<const uint4*>(src + head - MIS);
  const unsigned lane = threadIdx.x & 31;
  const uint64_t warp = tid >> 5;
  const uint64_t nwarps = nthreads >> 5;
  // warp-uniform trip count: every lane takes part in the shuffles
  for (uint64_t base = warp * 32; base < nvec; base += nwarps * 32) {
    const uint64_t i = base + lane;
    uint4 cur = make_uint4(0, 0, 0, 0);
    if (i <= nvec) cur = in[i];  // in[nvec] still holds body bytes
    uint4 nxt;
    nxt.x = __shfl_down_sync(0xffffffffu, cur.x, 1);
    nxt.y = __shfl_down_sync(0xffffffffu, cur.y, 1);
    nxt.z = __shfl_down_sync(0xffffffffu, cur.z, 1);
    nxt.w = __shfl_down_sync(0xffffffffu, cur.w, 1);
    if (lane == 31 && i < nvec) nxt = in[i + 1];
    if (i < nvec) {
      const uint32_t w[8] = {cur.x, cur.y, cur.z, cur.w,
                             nxt.x, nxt.y, nxt.z, nxt.w};
      uint4 o;
      o.x = shifted<MIS>(w, 0);
      o.y = shifted<MIS>(w, 1);
      o.z = shifted<MIS>(w, 2);
      o.w = shifted<MIS>(w, 3);
      out[i] = o;
    }
  }
}

// Aligned body by bulk copies: block x takes pieces x, x + grid, ...;
// thread 0 keeps up to kStages of them in flight through shared memory.
__global__ void __launch_bounds__(kBulkThreads)
h2d_bulk(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
         uint64_t n, uint64_t head, uint64_t nvec) {
  __shared__ __align__(128) uint8_t ring[kStages * kPiece];
  __shared__ uint64_t bar[kStages];
  copy_edges(src, dst, n, head, head + nvec * 16);
  if (threadIdx.x != 0) return;
  const uint64_t body = nvec * 16;
  const uint64_t npieces = (body + kPiece - 1) / kPiece;
  if (npieces <= blockIdx.x) return;
  const uint64_t mine = (npieces - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int s = 0; s < kStages; ++s) hx::bar_init(&bar[s], 1);
  hx::bar_init_fence();
  const uint8_t* in = src + head;
  uint8_t* out = dst + head;
  auto offset = [&](uint64_t j) {
    return (blockIdx.x + j * gridDim.x) * (uint64_t)kPiece;
  };
  auto bytes = [&](uint64_t j) {
    const uint64_t left = body - offset(j);
    return (uint32_t)(left < kPiece ? left : kPiece);
  };
  auto issue = [&](uint64_t j) {
    uint8_t* slot = ring + (j % kStages) * kPiece;
    uint64_t* b = &bar[j % kStages];
    hx::bar_expect(b, bytes(j));
    hx::bulk_load(slot, in + offset(j), bytes(j), b);
  };
  for (uint64_t j = 0; j < mine && j < (uint64_t)kStages; ++j) issue(j);
  for (uint64_t j = 0; j < mine; ++j) {
    const int st = (int)(j % kStages);
    hx::bar_wait(&bar[st], (uint32_t)((j / kStages) & 1));
    hx::fence_async_shared();
    hx::bulk_store(out + offset(j), ring + st * kPiece, bytes(j));
    hx::bulk_commit();
    if (j + kStages < mine) {
      hx::bulk_wait_read<0>();  // the store has read the slot
      issue(j + kStages);
    }
  }
  hx::bulk_wait<0>();
}

using Kernel = void (*)(const uint8_t*, uint8_t*, uint64_t, uint64_t,
                        uint64_t);
constexpr Kernel kShifted[16] = {
    nullptr,         h2d_shifted<1>,  h2d_shifted<2>,  h2d_shifted<3>,
    h2d_shifted<4>,  h2d_shifted<5>,  h2d_shifted<6>,  h2d_shifted<7>,
    h2d_shifted<8>,  h2d_shifted<9>,  h2d_shifted<10>, h2d_shifted<11>,
    h2d_shifted<12>, h2d_shifted<13>, h2d_shifted<14>, h2d_shifted<15>};

int launch(const uint8_t* s, uint8_t* d, uint64_t n, const Design& g,
           cudaStream_t stream, int device) {
  uint64_t head = (16 - ((uintptr_t)d & 15)) & 15;
  if (head > n) head = n;
  const uint64_t nvec = (n - head) / 16;
  const int mis = (int)(((uintptr_t)s + head) & 15);
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const uint64_t cap = (uint64_t)sms * g.blocks_per_sm;
  if (g.bulk && mis == 0) {
    const uint64_t pieces = (nvec * 16 + kPiece - 1) / kPiece;
    const int grid = (int)(pieces < 1 ? 1 : pieces < cap ? pieces : cap);
    h2d_bulk<<<grid, kBulkThreads, 0, stream>>>(s, d, n, head, nvec);
    return (int)cudaGetLastError();
  }
  // a bulk design's misaligned body: grid sized as for one load a thread
  const uint64_t per = (uint64_t)kThreads * (g.bulk ? 1 : g.per_thread);
  uint64_t want = (nvec + per - 1) / per;
  if (want < 1) want = 1;
  const int grid = (int)(want < cap ? want : cap);
  Kernel k = g.unroll == 4 ? &h2d_words<4> : &h2d_words<2>;
  if (mis != 0) k = kShifted[mis];
  k<<<grid, kThreads, 0, stream>>>(s, d, n, head, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Copy n bytes from a device-visible host address (the mapped pointer
// of page-locked memory) to device memory, on `stream`.
int strom_h2d_copy(const void* src, void* dst, uint64_t n, void* stream,
                   int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  return launch(static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
                n, kDesigns[0], (cudaStream_t)stream, device);
}

// The same copy with design `design` of kDesigns (0 the shipped one),
// for measurement.
int strom_h2d_copy_probe(const void* src, void* dst, uint64_t n, int design,
                         void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (design < 0 || design >= kNumDesigns) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return launch(static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
                n, kDesigns[design], (cudaStream_t)stream, device);
}

// Page-lock [base, base+bytes) for CUDA and map it into the device's
// address space; *dev_ptr receives the device-visible address of base.
int strom_host_register(void* base, uint64_t bytes, int device,
                        void** dev_ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostRegister(base, bytes,
                       cudaHostRegisterPortable | cudaHostRegisterMapped);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  e = cudaHostGetDevicePointer(dev_ptr, base, 0);
  if (e != cudaSuccess) {
    cudaGetLastError();
    cudaHostUnregister(base);
    return (int)e;
  }
  return 0;
}

int strom_host_unregister(void* base, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostUnregister(base);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Device-visible address of memory CUDA already page-locked (a
// `pin_memory=True` tensor, or a registered range).
int strom_host_device_pointer(void* host, int device, void** dev_ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(dev_ptr, host, 0);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

const char* strom_cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
