// ici_ring.cu — ring all-gather of per-rank share rows, the exchange of
// the read-once scatter restore.
//
// Replaces the TPU kernel nvme_strom_tpu/ops/ici.py:159 (`kernel` in
// `IciExchange._pallas_gather_fn`): every rank's output is an (n, slot)
// byte array whose slot r rank r has already filled with its own share
// row; in n-1 ring steps each rank pushes slot (rank - step) mod n of its
// output into the same slot of its right neighbour's output, so every row
// lands once in its final place with no staging buffer.
//
// Bound: bytes.  On one card the function reads each rank's own row
// once and writes the n - 1 other rows of every rank's output once:
// n·n·slot_bytes over HBM's 3.35 TB/s (n = 4, ~137 MB rows: ~0.66 ms).
// A ring that reads every pushed row back from HBM moves
// 2·n·(n - 1)·slot_bytes (~0.98 ms); this one reads the rows of steps
// >= 1 from L2 (below).  On several cards: (n - 1)·slot_bytes over
// 450 GB/s per NVLink direction.
//
// Design.  A slot is cut into chunks of kChunk bytes (48 KB: of 32,
// 48, 64 and 96 KB, the fastest on an H100, PERF.md); block b of every
// rank owns chunks b, b + B, b + 2B, ... of every slot (B blocks a rank,
// C = ceil(chunks / B) chunks a block), so neighbouring blocks stream
// neighbouring addresses, as a plain copy does.  A block takes each of
// its chunks through every step before the next chunk: chunk j of step
// k is its move i = j·(n-1) + k.
// After each move, landed or empty (a chunk past the slot's end), block
// b releases its right neighbour's flag (right, b) once.  Before move i
// at a step k >= 1, block b acquire-waits until its own flag reaches
// base + i: its left neighbour's block b has made move i - 1, landing
// chunk j of step k - 1, which move i forwards.  So a chunk goes round
// the ring a few microseconds behind itself, and each step's read finds
// the bytes the step before wrote still in L2; no block waits for a
// whole step, its rank or the grid.  A last wait for base + (n-1)·C makes
// the kernel's completion mean that every slot of every rank it launched
// is complete.  Fences and flags are at device scope where the
// neighbour is on the same card, at system scope only across cards.
//
// Copies: one thread of a 32-thread block moves a chunk by TMA bulk
// copies through shared memory, kPieces loads each completing on its own
// mbarrier, a bulk store of each piece as it lands, then a wait for the
// stores, a proxy fence and the flag's release (the reader's acquire is
// followed by a proxy fence before its bulk loads).  L2 hints: every
// load evict-first (no byte is read twice), every store evict-last but
// the last step's (the right neighbour reads it next).  16-byte SM loads
// and stores, 8 a thread in flight, in the same order were slower on one
// card and across two (PERF.md has both, and the sizes of chunk tried).
//
// Across processes (one rank a process and a card, ops/ici.py
// ProcessExchange) each process launches its own rank's blocks on its
// card with every peer's slots and flags mapped through CUDA IPC
// handles (strom_ipc_*), and every flag is at system scope.  Two ranks
// on one card would be time-sliced, each spinning on the other, so the
// wrapper refuses that layout.
//
// Spin-waiting blocks must all be resident or the ring deadlocks: all
// ranks on one card run in one grid (gridDim.y = ranks on the card)
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be co-resident; on several cards, one such launch per card,
// all issued before any synchronisation, with peer access enabled.
// Flags live in a persistent buffer per group and only ever grow: the
// wrapper keeps `base`, the flags' value before this call (each call
// adds (n-1)·C).  Nothing resets them between calls, so a left neighbour
// on another card may signal before this card's launch has started.
// Every spin is bounded by a wall-clock budget (%globaltimer); when it
// runs out the block sets the card's error word, and every spinning
// block of that card gives up once it sees the word set; the word is
// mirrored into page-locked host memory, which the wrapper reads after
// its one synchronisation.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 32;   // one warp; lane 0 issues every copy
constexpr int kPieces = 4;     // bulk copies a chunk is cut into
constexpr int kMaxRanks = 64;  // ranks of a group (kernel parameters)
constexpr unsigned kChunk = 48 << 10;  // bytes of a chunk of a slot
static_assert(kChunk % (16 * kPieces) == 0, "pieces of whole 16 B");

struct RingArgs {
  uint64_t slots[kMaxRanks];  // each rank's (n, slot_bytes) output
  uint64_t flags[kMaxRanks];  // each rank's flags, one a block
  int ranks[kMaxRanks];       // the rank of grid row y
  uint64_t slot_bytes;
  uint64_t remote_right;      // bit r: rank r's right neighbour is on
                              // another card
  unsigned base;              // the flags' value before this call
  unsigned long long budget_ns;
  int* err;                   // this card's error word
  int* err_host;              // its mirror in mapped host memory
  int n;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned acquire(unsigned* flag, bool sys) {
  if (sys)
    return cuda::atomic_ref<unsigned, cuda::thread_scope_system>(*flag)
        .load(cuda::memory_order_acquire);
  return cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*flag).load(
      cuda::memory_order_acquire);
}

__device__ __forceinline__ void release_add(unsigned* flag, bool sys) {
  if (sys)
    cuda::atomic_ref<unsigned, cuda::thread_scope_system>(*flag).fetch_add(
        1u, cuda::memory_order_release);
  else
    cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*flag).fetch_add(
        1u, cuda::memory_order_release);
}

// Wait until *flag >= target (wrap-safe); 0 on success, 1 if this card's
// error word is set or the budget runs out (then the word is set here).
__device__ int wait_flag(unsigned* flag, unsigned target, bool sys,
                         const RingArgs& a) {
  if ((int)(acquire(flag, sys) - target) >= 0) return 0;
  cuda::atomic_ref<int, cuda::thread_scope_device> e(*a.err);
  const unsigned long long t0 = global_ns();
  while ((int)(acquire(flag, sys) - target) < 0) {
    if (e.load(cuda::memory_order_relaxed) != 0) return 1;
    if (global_ns() - t0 > a.budget_ns) {
      e.store(1, cuda::memory_order_relaxed);
      *reinterpret_cast<volatile int*>(a.err_host) = 1;
      return 1;
    }
    __nanosleep(32);
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
ici_ring_kernel(const __grid_constant__ RingArgs a) {
  namespace hx = strom_hopper;
  extern __shared__ __align__(128) uint8_t stage[];  // one chunk
  __shared__ __align__(8) uint64_t bars[kPieces];
  if (threadIdx.x != 0) return;
  const int n = a.n;
  const int steps = n - 1;
  const int rank = a.ranks[blockIdx.y];
  const int right = (rank + 1) % n;
  const bool sys_out = (a.remote_right >> rank) & 1;
  const bool sys_in = (a.remote_right >> ((rank + n - 1) % n)) & 1;
  const uint64_t chunks = (a.slot_bytes + kChunk - 1) / kChunk;
  const unsigned C = (unsigned)((chunks + gridDim.x - 1) / gridDim.x);
  constexpr unsigned piece = kChunk / kPieces;
  const uint8_t* mine = reinterpret_cast<const uint8_t*>(a.slots[rank]);
  uint8_t* theirs = reinterpret_cast<uint8_t*>(a.slots[right]);
  unsigned* my_flag = reinterpret_cast<unsigned*>(a.flags[rank]) + blockIdx.x;
  unsigned* right_flag =
      reinterpret_cast<unsigned*>(a.flags[right]) + blockIdx.x;
  for (int p = 0; p < kPieces; ++p) hx::bar_init(&bars[p], 1);
  hx::bar_init_fence();
  unsigned phase = 0;  // bit p: parity of piece p's next completion
  for (unsigned i = 0; i < steps * C; ++i) {
    const unsigned j = i / steps;  // move i: chunk j of step k
    const int k = i % steps;
    const uint64_t c = blockIdx.x + (uint64_t)j * gridDim.x;
    if (c < chunks) {
      if (k > 0) {
        // the left neighbour's move i - 1 has landed chunk j of step k - 1
        if (wait_flag(my_flag, a.base + i, sys_in, a)) return;
        hx::fence_async_global();
      }
      const uint64_t off =
          (uint64_t)((rank - k + n) % n) * a.slot_bytes + c * kChunk;
      const uint64_t left = a.slot_bytes - c * kChunk;
      const unsigned bytes = left < kChunk ? (unsigned)left : kChunk;
      const uint64_t keep =
          k == steps - 1 ? hx::l2_evict_first() : hx::l2_evict_last();
      for (int p = 0; p < kPieces && p * piece < bytes; ++p) {
        const unsigned nb = min(piece, bytes - p * piece);
        hx::bar_expect(&bars[p], nb);
        hx::bulk_load_hint(stage + p * piece, mine + off + p * piece, nb,
                           &bars[p], hx::l2_evict_first());
      }
      for (int p = 0; p < kPieces && p * piece < bytes; ++p) {
        hx::bar_wait(&bars[p], (phase >> p) & 1);
        phase ^= 1u << p;
        hx::bulk_store_hint(theirs + off + p * piece, stage + p * piece,
                            min(piece, bytes - p * piece), keep);
      }
      hx::bulk_commit();
      hx::bulk_wait<0>();  // the stores have landed
      hx::fence_async_global();
    }
    release_add(right_flag, sys_out);
  }
  // the left neighbour's last chunks have landed in this block's chunks
  wait_flag(my_flag, a.base + steps * C, sys_in, a);
}

}  // namespace

extern "C" {

// Blocks of the ring kernel that fit on `device` at once (all SMs), and
// the bytes of a chunk.  Lets the kernel take a chunk of dynamic shared
// memory on `device`: call it once before the first launch there.
int strom_ici_ring_capacity(int device, int* blocks, unsigned* chunk) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ici_ring_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kChunk);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ici_ring_kernel,
                                                    kThreads, kChunk);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * per_sm;
  *chunk = kChunk;
  return 0;
}

// Wait for the work queued on `stream` of `device`.
int strom_stream_synchronize(void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
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
// `ranks` (host array) on `device`: `slots` and `flags` are host arrays
// of the n ranks' output base addresses and flag addresses (`blocks`
// unsigned flags each), passed to the kernel by value; bit r of
// `remote_right` says that rank r's right neighbour is on another card;
// `err` is this card's error word, `err_host` its mirror (a device
// address of mapped page-locked memory).  strom_ici_ring_capacity has
// been called for `device`.
int strom_ici_ring(const uint64_t* slots, const uint64_t* flags,
                   const int* ranks, int n_here, int n,
                   uint64_t remote_right, uint64_t slot_bytes, int blocks,
                   unsigned base,
                   unsigned long long budget_ns, void* err, void* err_host,
                   void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (slot_bytes % 16 != 0 || n_here < 1 || n_here > n || n > kMaxRanks ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  RingArgs a;
  for (int r = 0; r < n; ++r) {
    a.slots[r] = slots[r];
    a.flags[r] = flags[r];
  }
  for (int y = 0; y < n_here; ++y) a.ranks[y] = ranks[y];
  a.slot_bytes = slot_bytes;
  a.remote_right = remote_right;
  a.base = base;
  a.budget_ns = budget_ns;
  a.err = static_cast<int*>(err);
  a.err_host = static_cast<int*>(err_host);
  a.n = n;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)ici_ring_kernel,
                                  dim3(blocks, n_here), dim3(kThreads), args,
                                  kChunk, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// CUDA IPC for the ring across processes, one rank a process and a card.
// A rank's slots and flags are an allocation of their own (cudaMalloc,
// zeroed), so the handle a peer opens maps exactly them and nothing of
// PyTorch's caching allocator.  `handle` is the 64-byte
// cudaIpcMemHandle_t, written by strom_ipc_alloc and read by
// strom_ipc_open (a process cannot open its own handle).
int strom_ipc_alloc(int device, uint64_t bytes, void** ptr, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)e;
}

int strom_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int strom_ipc_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}

int strom_ipc_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFree(ptr);
}

}  // extern "C"
