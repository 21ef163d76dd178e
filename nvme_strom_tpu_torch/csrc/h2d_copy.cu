// h2d_copy.cu — host→device byte copy driven by the SMs, and the
// page-locking helpers the bridge needs around it.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/bridge.py `_pallas_h2d`
// (`_dma_kernel`): one asynchronous copy of a pinned host array into
// device memory.  Here the SMs themselves read the page-locked host
// buffer over PCIe through its mapped device pointer and write device
// memory, on the bridge's side stream, so the NVMe read of chunk K+1
// overlaps the host→device hop of chunk K exactly as on the TPU.
//
// Bound: the host link.  Every byte crosses PCIe once (Gen5 x16: about
// 64 GB/s each way); the device-memory write is ~50x cheaper.  Reads
// over PCIe have microseconds of latency, so the design keeps many
// 16-byte loads in flight: a grid-stride loop over up to 8 blocks per
// SM, 4 independent 16-byte loads per thread per trip when source and
// destination share their alignment.  When they do not, each warp reads
// aligned 16-byte words, passes each to its left neighbour with one
// shuffle, and funnel-shifts the two into the misaligned output word, so
// the host bytes still cross the link once in 16-byte requests.  The
// head bytes before the destination's first 16-byte boundary and the
// tail after the last full word go bytewise.
//
// An aligned 16-byte word that holds at least one byte of the source
// lies on the same page as that byte, so it is mapped whenever the
// byte is: reading the whole word never touches memory outside the
// registered or pinned pages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int MIS>
__device__ __forceinline__ uint32_t shifted(const uint32_t (&w)[8], int j) {
  constexpr int q = MIS / 4;
  constexpr int r = (MIS % 4) * 8;
  if (r == 0) return w[q + j];
  return __funnelshift_r(w[q + j], w[q + j + 1], r);
}

// MIS = (source address of the body) mod 16, a compile-time constant
// so the funnel shift indexes registers, never local memory.
template <int MIS>
__global__ void __launch_bounds__(kThreads)
h2d_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                uint64_t n, uint64_t head, uint64_t nvec) {
  const uint64_t tid = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  const uint64_t nthreads = (uint64_t)gridDim.x * blockDim.x;
  if (tid < head) dst[tid] = src[tid];
  for (uint64_t i = head + nvec * 16 + tid; i < n; i += nthreads)
    dst[i] = src[i];
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  const uint8_t* body = src + head;
  if (MIS == 0) {
    const uint4* in = reinterpret_cast<const uint4*>(body);
    uint64_t i = tid;
    for (; i + 3 * nthreads < nvec; i += 4 * nthreads) {
      uint4 a = in[i], b = in[i + nthreads], c = in[i + 2 * nthreads],
            d = in[i + 3 * nthreads];
      out[i] = a;
      out[i + nthreads] = b;
      out[i + 2 * nthreads] = c;
      out[i + 3 * nthreads] = d;
    }
    for (; i < nvec; i += nthreads) out[i] = in[i];
    return;
  }
  const uint4* in = reinterpret_cast<const uint4*>(body - MIS);
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

template <int MIS>
void launch(const uint8_t* src, uint8_t* dst, uint64_t n, uint64_t head,
            uint64_t nvec, int grid, cudaStream_t stream) {
  h2d_copy_kernel<MIS><<<grid, kThreads, 0, stream>>>(src, dst, n, head,
                                                      nvec);
}

using Launcher = void (*)(const uint8_t*, uint8_t*, uint64_t, uint64_t,
                          uint64_t, int, cudaStream_t);
constexpr Launcher kLaunch[16] = {
    launch<0>, launch<1>, launch<2>,  launch<3>,  launch<4>,  launch<5>,
    launch<6>, launch<7>, launch<8>,  launch<9>,  launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

}  // namespace

extern "C" {

// Copy n bytes from a device-visible host address (the mapped pointer
// of page-locked memory) to device memory, on `stream`.
int strom_h2d_copy(const void* src, void* dst, uint64_t n, void* stream,
                   int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  uint64_t head = (16 - ((uintptr_t)d & 15)) & 15;
  if (head > n) head = n;
  const uint64_t nvec = (n - head) / 16;
  const int mis = (int)(((uintptr_t)s + head) & 15);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  uint64_t want = (nvec + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  const uint64_t cap = (uint64_t)sms * kBlocksPerSm;
  const int grid = (int)(want < cap ? want : cap);
  kLaunch[mis](s, d, n, head, nvec, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
