// ici_ring.cu — ring all-gather of per-rank share rows, the exchange of
// the read-once scatter restore.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/ici.py:159 (`kernel` in
// `IciExchange._pallas_gather_fn`): every rank's output is an (n, slot)
// byte array whose slot r rank r has already filled with its own share
// row; in n-1 lockstep steps each rank pushes slot (rank - step) mod n
// of its output into the same slot of its right neighbour's output, so
// every row lands once in its final place with no staging buffer.
//
// Design.  Block b of every rank owns the same stripe of every slot: it
// pushes stripe b of slot `src` into the right neighbour's slot `src`
// with 16-byte loads and stores (slots are padded to 4096 bytes, so every
// stripe is 16-byte aligned), waits for its block, then one thread fences
// (__threadfence_system) and release-increments the right neighbour's
// flag for (right, b).  Before its next step a block acquire-waits until
// its own flag (rank, b) shows that the left neighbour's push of that
// stripe has landed.  No block waits on another block of its own rank,
// so there is no grid-wide barrier and no atomic on data.  A last wait
// after the final push makes the kernel's completion mean that every
// slot of every rank it launched is complete.
//
// Spin-waiting blocks must all be resident or the ring deadlocks: all
// ranks on one card run in one grid (gridDim.y = ranks on the card)
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be co-resident; on several cards, one such launch per card,
// all issued before any synchronisation, with peer access enabled.
// Flags live in a persistent buffer per group and only ever grow: a call
// waits for `base + step`, base = calls * (n - 1).  Nothing resets them
// between calls, so a left neighbour on another card may signal before
// this card's launch has started.  Every spin is bounded by a wall-clock
// budget (%globaltimer); when it runs out the block sets the error word,
// which the wrapper reads after synchronising, and every spinning block
// of that card gives up once it sees the word set.
//
// Bound on one card: each push reads and writes HBM, so
// 2 * n * (n - 1) * slot_bytes / 3.35 TB/s (n = 4, ~136 MB rows:
// ~0.98 ms).  On several cards: (n - 1) * slot_bytes / 450 GB/s per
// NVLink direction.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until *flag >= target (wrap-safe); 0 on success, 1 if this card's
// error word is set or the budget runs out (then the word is set here).
__device__ int wait_flag(unsigned* flag, unsigned target,
                         unsigned long long budget_ns, int* err) {
  cuda::atomic_ref<unsigned, cuda::thread_scope_system> f(*flag);
  cuda::atomic_ref<int, cuda::thread_scope_device> e(*err);
  const unsigned long long t0 = global_ns();
  while ((int)(f.load(cuda::memory_order_acquire) - target) < 0) {
    if (e.load(cuda::memory_order_relaxed) != 0) return 1;
    if (global_ns() - t0 > budget_ns) {
      e.store(1, cuda::memory_order_relaxed);
      return 1;
    }
    __nanosleep(100);
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
ici_ring_kernel(const uint64_t* __restrict__ slots,
                const uint64_t* __restrict__ flags,
                const int* __restrict__ ranks, int n, uint64_t slot_bytes,
                unsigned base, unsigned long long budget_ns, int* err) {
  __shared__ int abort_ring;
  const int rank = ranks[blockIdx.y];
  const int right = (rank + 1) % n;
  const uint64_t nvec = slot_bytes / 16;
  const uint64_t per = (nvec + gridDim.x - 1) / gridDim.x;
  const uint64_t first = (uint64_t)blockIdx.x * per;
  const uint64_t lo = first < nvec ? first : nvec;
  const uint64_t hi = lo + per < nvec ? lo + per : nvec;
  const uint8_t* mine = reinterpret_cast<const uint8_t*>(slots[rank]);
  uint8_t* theirs = reinterpret_cast<uint8_t*>(slots[right]);
  unsigned* my_flag = reinterpret_cast<unsigned*>(flags[rank]) + blockIdx.x;
  unsigned* right_flag =
      reinterpret_cast<unsigned*>(flags[right]) + blockIdx.x;
  for (int step = 0; step < n; ++step) {
    if (step > 0) {
      // the left neighbour's push of step - 1 has landed in this stripe
      if (threadIdx.x == 0)
        abort_ring = wait_flag(my_flag, base + step, budget_ns, err);
      __syncthreads();
      if (abort_ring) return;
    }
    if (step == n - 1) break;
    const uint64_t src = (uint64_t)((rank - step + n) % n);
    const uint4* in = reinterpret_cast<const uint4*>(mine + src * slot_bytes);
    uint4* out = reinterpret_cast<uint4*>(theirs + src * slot_bytes);
    uint64_t i = lo + threadIdx.x;
    for (; i + 3 * kThreads < hi; i += 4 * kThreads) {
      // L2 loads: another block wrote these bytes during this kernel
      const uint4 a = __ldcg(in + i), b = __ldcg(in + i + kThreads),
                  c = __ldcg(in + i + 2 * kThreads),
                  d = __ldcg(in + i + 3 * kThreads);
      __stcg(out + i, a);
      __stcg(out + i + kThreads, b);
      __stcg(out + i + 2 * kThreads, c);
      __stcg(out + i + 3 * kThreads, d);
    }
    for (; i < hi; i += kThreads) __stcg(out + i, __ldcg(in + i));
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      cuda::atomic_ref<unsigned, cuda::thread_scope_system>(*right_flag)
          .fetch_add(1u, cuda::memory_order_release);
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the ring kernel that fit on `device` at once (all SMs).
int strom_ici_ring_capacity(int device, int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ici_ring_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * per_sm;
  return 0;
}

// Let `device` read and write `peer`'s memory (and its flags).
int strom_enable_peer_access(int device, int peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int can = 0;
  e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}

// One cooperative launch of the ring for the `n_here` ranks listed in
// `ranks` (device array) on `device`: `slots` and `flags` are device
// arrays of the n ranks' output base addresses and flag addresses
// (`blocks` unsigned flags each); `err` is this card's error word.
int strom_ici_ring(const void* slots, const void* flags, const void* ranks,
                   int n_here, int n, uint64_t slot_bytes, int blocks,
                   unsigned base, unsigned long long budget_ns, void* err,
                   void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (slot_bytes % 16 != 0 || n_here < 1 || n < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const uint64_t* s = static_cast<const uint64_t*>(slots);
  const uint64_t* f = static_cast<const uint64_t*>(flags);
  const int* r = static_cast<const int*>(ranks);
  int* w = static_cast<int*>(err);
  void* args[] = {&s, &f, &r, &n, &slot_bytes, &base, &budget_ns, &w};
  e = cudaLaunchCooperativeKernel((const void*)ici_ring_kernel,
                                  dim3(blocks, n_here), dim3(kThreads), args,
                                  0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
