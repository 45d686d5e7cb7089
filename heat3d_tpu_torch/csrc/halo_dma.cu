// DMA halo exchange for Hopper (sm_90a): each shard's kernel pushes its two
// face slabs of one mesh axis straight into its neighbours' ghost slabs
// (peer stores when the neighbour is on another GPU), then signals them;
// a one-block kernel on each shard waits for the two signals it is owed.
//
// Replaces heat3d_tpu/ops/halo_pallas.py:
//   * ::_exchange_axis_dma_width1 (_face_exchange_kernel, the width-1
//     zero-staging path) and
//   * ::_exchange_axis_dma_slab (_slab_exchange_kernel, width 1..4 slabs
//     staged axis-leading)
// -> halo_push_kernel<W> + halo_wait_kernel. A thread reads a strided face
// directly, so no staging is needed (the TPU stages for its tiling).
//
// Bound: device-memory bytes. A push reads each face slab once and writes
// it once into the receiver; no arithmetic. Design: a grid-stride copy over
// the slab, one grid row per side (low face, high face); the destination is
// the receiver's padded block through its base pointer (a peer pointer
// across GPUs), or, at a non-periodic domain face, the shard's own ghost
// slab filled with the bc bits (nothing crosses the domain face; the JAX
// kernel pushes the wrap and overwrites it, with the same bytes).
//
// Protocol (the TPU kernel's send semaphores -> a flag word per receiver,
// axis and side):
//   * every block stores its part, __threadfence_system(), then arrives on
//     the shard's counter; the last block to arrive resets the counter,
//     fences again and publishes the exchange's epoch into each receiver's
//     flag word with a system-scope release store;
//   * halo_wait_kernel acquire-loads the shard's two flag words of the axis
//     at system scope until both reach the epoch. The spin is bounded (about
//     2 s of globaltimer): past it the kernel writes the error word (mapped
//     host memory, readable after the fault) and traps, so a protocol bug
//     fails instead of hanging.
// The host enqueues every shard's push, then every shard's wait, axis by
// axis, and orders a push into a block after the receiver's previous
// compute with an event (ops/halo_dma.py, parallel/plan.py).
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// One side of a push: the destination block and slab origin, the source
// slab origin, and the receiver's flag word (null: nothing to signal).
struct HaloSide {
  void* dst;
  unsigned long long* flag;
  int src_off[3];
  int dst_off[3];
  int fill;  // 1: write the bc bits into dst instead of copying
};

struct HaloPush {
  const void* src;  // the pushing shard's padded block
  int P[3];         // padded extents (every block of the mesh has them)
  int E[3];         // slab extents
  HaloSide side[2];
  unsigned int* counter;  // the pushing shard's arrival counter
  unsigned long long epoch;
  unsigned int bc_bits;  // bc in the storage type, as raw bits
  int elem_bytes;        // 4 (float) or 2 (bf16)
};

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_PER_SIDE = 528;

unsigned int* g_err_host = nullptr;
unsigned int* g_err_dev = nullptr;

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <class W>
__global__ void __launch_bounds__(THREADS) halo_push_kernel(HaloPush p) {
  const HaloSide s = p.side[blockIdx.y];
  const int e1 = p.E[1];
  const int e2 = p.E[2];
  const int64_t n = (int64_t)p.E[0] * e1 * e2;
  const int64_t P1 = p.P[1];
  const int64_t P2 = p.P[2];
  W* dst = static_cast<W*>(s.dst);
  const W* src = static_cast<const W*>(p.src);
  const W bc = static_cast<W>(p.bc_bits);
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const int c = (int)(i % e2);
    const int64_t t = i / e2;
    const int b = (int)(t % e1);
    const int a = (int)(t / e1);
    const int64_t d =
        ((int64_t)(s.dst_off[0] + a) * P1 + s.dst_off[1] + b) * P2 +
        s.dst_off[2] + c;
    if (s.fill) {
      dst[d] = bc;
    } else {
      dst[d] = src[((int64_t)(s.src_off[0] + a) * P1 + s.src_off[1] + b) *
                       P2 +
                   s.src_off[2] + c];
    }
  }
  // arrival: this block's stores are visible system-wide before it counts
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    if (atomicAdd(p.counter, 1u) == total - 1) {
      atomicExch(p.counter, 0u);  // the next launch on this stream starts at 0
      __threadfence_system();
      for (int k = 0; k < 2; ++k) {
        if (p.side[k].flag != nullptr) {
          store_release_sys(p.side[k].flag, p.epoch);
        }
      }
    }
  }
}

__global__ void halo_wait_kernel(const unsigned long long* f0,
                                 const unsigned long long* f1,
                                 unsigned long long epoch,
                                 long long timeout_ns, unsigned int code,
                                 unsigned int* err) {
  if (threadIdx.x != 0) return;
  const unsigned long long t0 = globaltimer_ns();
  const unsigned long long* flags[2] = {f0, f1};
  for (int k = 0; k < 2; ++k) {
    if (flags[k] == nullptr) continue;
    while (load_acquire_sys(flags[k]) < epoch) {
      if ((long long)(globaltimer_ns() - t0) > timeout_ns) {
        *reinterpret_cast<volatile unsigned int*>(err) = code;
        __threadfence_system();
        __trap();
      }
      __nanosleep(128);
    }
  }
}

}  // namespace

extern "C" {

// The error word the wait kernel writes on a timeout: mapped, portable host
// memory, allocated once. Returns a cudaError_t (0 on success).
int heat3d_halo_init() {
  if (g_err_host != nullptr) return 0;
  unsigned int* host = nullptr;
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&host),
                                  sizeof(unsigned int),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  *host = 0u;
  unsigned int* dev = nullptr;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev), host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return static_cast<int>(err);
  }
  g_err_host = host;
  g_err_dev = dev;
  return 0;
}

// 0, or the code of the first wait that timed out (1 + shard rank * 4 +
// axis).
unsigned int heat3d_halo_error() {
  return g_err_host == nullptr
             ? 0u
             : *reinterpret_cast<volatile unsigned int*>(g_err_host);
}

// Let device `from` store into device `to`'s memory. 0 on success (or when
// already enabled), 1001 when the pair cannot access each other, else a
// cudaError_t. Restores the current device.
int heat3d_halo_enable_peer(int from, int to) {
  if (from == to) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, from, to);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return 1001;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(from);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(to, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the non-sticky error
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// The push of one shard along one axis. Returns a cudaError_t (0 on
// success); 1000 for bad arguments.
int heat3d_halo_push(const HaloPush* p, void* stream) {
  if (p == nullptr || p->src == nullptr || p->counter == nullptr ||
      (p->elem_bytes != 2 && p->elem_bytes != 4)) {
    return 1000;
  }
  for (int a = 0; a < 3; ++a) {
    if (p->E[a] < 1 || p->P[a] < 1) return 1000;
  }
  if (p->side[0].dst == nullptr || p->side[1].dst == nullptr) return 1000;
  const int64_t n = (int64_t)p->E[0] * p->E[1] * p->E[2];
  const int64_t want = (n + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(want < MAX_BLOCKS_PER_SIDE ? want
                                                        : MAX_BLOCKS_PER_SIDE),
                  2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->elem_bytes == 4) {
    halo_push_kernel<uint32_t><<<grid, THREADS, 0, s>>>(*p);
  } else {
    halo_push_kernel<uint16_t><<<grid, THREADS, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wait of one shard along one axis: until each non-null flag word
// reaches epoch, at most timeout_ns. Returns a cudaError_t; 1000 when the
// error word is not allocated (heat3d_halo_init).
int heat3d_halo_wait(const unsigned long long* f0,
                     const unsigned long long* f1, unsigned long long epoch,
                     long long timeout_ns, unsigned int code, void* stream) {
  if (g_err_dev == nullptr) return 1000;
  halo_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      f0, f1, epoch, timeout_ns, code, g_err_dev);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
