// DMA halo exchange for Hopper (sm_90a): one axis of the padded-block
// exchange. Each shard's two face slabs go straight into its neighbours'
// ghost slabs (peer stores when the neighbour is on another GPU), and the
// bc bits into the shard's own ghost slab at a non-periodic domain face.
//
// Replaces heat3d_tpu/ops/halo_pallas.py:
//   * ::_exchange_axis_dma_width1 (_face_exchange_kernel, the width-1
//     zero-staging path) and
//   * ::_exchange_axis_dma_slab (_slab_exchange_kernel, width 1..4 slabs
//     staged axis-leading)
// -> halo_push_kernel + halo_wait_kernel. A thread reads the padded block
// directly, so no staging is needed (the TPU stages for its tiling).
//
// Bound: device-memory bytes. A push reads each face slab once and writes
// it once into the receiver; no arithmetic. At 512^3 shards the bytes of
// one axis take 7.5-31 us on an H100, so what costs is the host's issue of
// the launches and, on z, the sectors (below).
//
// Design. Everything but the epoch and the bc bits is fixed for the life of
// a plan, so the wrapper (ops/halo_dma.py) builds, per device and axis, a
// table of items in device memory once: one item per side of each shard
// the device holds (source, destination block and slab origins, the
// receiver's flag word, or a bc fill), and one wait entry per flag word
// those shards are owed. A call of one axis is then, per device:
//   * the fork: the launch stream (the device's first shard stream) waits
//     for the device's other shard streams, with one event of this library;
//   * one push launch over every item, with each row's origin computed
//     once per row (one 32-bit division, no 64-bit % or / per element).
//     x and y slabs have rows along contiguous z: a block copies a range of
//     one item's rows, a warp a row, as 16-, 8- or 4-byte vectors where the
//     source and destination rows share their alignment (a padded row's
//     interior starts at element w, so that is per row), else element by
//     element; the blocks of every item's j-th range are adjacent in launch
//     order. A z slab's rows are w elements long, each P2 elements from the
//     next, so at width 1 every 4-byte element is a 32-byte sector of its
//     own and z cannot reach its byte bound (chip_smoke.py prints the
//     sector floor beside it). What the z slabs can save is sectors: a z
//     face and the ghost beside it share one, and so do one row's high face
//     and ghost and the next row's low ghost and face. So thread r copies
//     row r of every item (16 at a time, every load before the first
//     store, each row one 16-, 8- or 4-byte access where its alignment
//     allows): a row's items, and its warp neighbours', touch those sectors
//     at once, and each is read and written back about once instead of
//     once an item. The z push keeps only SHORT_ROWS rows in flight, in
//     blocks of SHORT_THREADS that loop over the slab: the rows in flight
//     then lie close together in every block, and a sector is still in L2
//     when its row's stores come. A launch that took every row at once ran
//     z 1.3-1.6x slower (PERF.md section 6);
//   * at most one wait launch: a thread per flag word owed;
//   * the join: the device's other shard streams wait for the launch
//     stream, with the library's second event.
// The events and two launches are one ctypes call per device and axis,
// where the first design made a push and a wait launch per shard, each a
// ctypes call with its own device context.
//
// Protocol (the TPU kernel's send semaphores -> a flag word per receiver,
// axis and side):
//   * every block stores its part, __threadfence_system(), then arrives on
//     the launch's counter; the last block to arrive resets the counter,
//     fences again and publishes the exchange's epoch into each receiver's
//     flag word of the launch with a system-scope release store;
//   * halo_wait_kernel acquire-loads each owed flag word at system scope
//     until it reaches the epoch. The spin is bounded (about 2 s of
//     globaltimer): past it the kernel writes the error word (mapped host
//     memory, readable after the fault) and traps, so a protocol bug fails
//     instead of hanging.
// A push into a block on another device waits (an event, on the host) for
// the receiver to have entered the exchange; on one device the fork orders
// it after the receivers' earlier work.
//
// Measured (chip_smoke.py dma_times, "NVIDIA H100 80GB HBM3, 700.00 W"),
// one axis of the (2,2,2) mesh of 512^3 fp32 shards, the mean of 20 calls
// in a row: x and y 0.04-0.05 ms at width 1 and 0.09 at width 4 (the
// host's issue; bytes bound 0.0075 / 0.030), z 0.24 and 0.31-0.32 (sector
// floor 0.061 / 0.062), against 0.20-0.45 ms for the plain slab copies;
// single calls and PR 6's figures: PERF.md section 6 rows 7-8.
//
// Launches go on the table's launch stream, allocate nothing, and return
// cudaGetLastError().

#include <algorithm>
#include <type_traits>

#include "copy_rows.cuh"
#include "sync_flags.cuh"

// One side of one shard's push (device memory).
struct HaloItem {
  const void* src;            // the pushing shard's padded block
  void* dst;                  // the receiver's block (peer pointer), or the
                              // shard's own at a domain face
  unsigned long long* flag;   // the receiver's flag word (null: nobody)
  int src_off[3];             // slab origins in padded coordinates
  int dst_off[3];
  int fill;                   // 1: write the bc bits into dst, no copy
};

// One flag word a device's shards are owed (device memory).
struct HaloWait {
  const unsigned long long* flag;
  unsigned int code;  // written to the error word on a timeout
  int unused;
};

// One (device, axis) of one plan's exchange: fixed for the plan's life.
struct HaloLaunch {
  const HaloItem* items;   // device memory
  const HaloWait* waits;   // device memory
  unsigned int* counter;   // the launch's arrival counter (device memory)
  int nitems;
  int nwaits;
  int P[3];                // padded extents (every block of the mesh)
  int E[3];                // slab extents
  int elem_bytes;          // 4 (float) or 2 (bf16)
  int device;
  void* stream;            // the launch stream
  void* const* others;     // the device's other shard streams (host array)
  int nothers;
  void* fork;              // this library's events (heat3d_halo_events)
  void* join;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// rows of at most SHORT_BYTES (z slabs): a thread a row, across up to GROUP
// items at once, SHORT_ROWS rows in flight in blocks of SHORT_THREADS (the
// best of 2048 rows to all at once and of 32-256 threads on an H100);
// longer rows: a block a range of one item's rows, a warp a row (WARP_ROW
// elements or more; 8 rows a warp) or a thread a row (8 rows a thread)
constexpr int SHORT_BYTES = 16;
constexpr int GROUP = 16;
constexpr int SHORT_THREADS = 64;
constexpr int SHORT_ROWS = 8192;
constexpr int WARP_ROW = 32;
constexpr int ROWS_WARP = WARPS * 8;
constexpr int ROWS_THREAD = THREADS * 8;

// The push's per-call arguments beside the table.
struct PushArgs {
  const HaloItem* items;
  unsigned int* counter;
  unsigned long long epoch;
  int nitems;
  int rows;        // rows of a slab: E0 * E1
  int e1;          // rows of one slab plane
  int len;         // elements of a row: E2
  long long P1P2;  // plane stride
  int P1;
  int P2;          // row stride
  unsigned int bc_bits;
};

// Element offset of slab origin `off` in a padded block.
__device__ __forceinline__ int64_t slab_at(const PushArgs& a, const int* off) {
  return ((int64_t)off[0] * a.P1 + off[1]) * a.P2 + off[2];
}

// Short rows (z slabs): thread r copies slab rows r, r + the grid's threads,
// ... of every item, GROUP items at a time, every load of a row before its
// first store, each row one V access where both its ends are V-aligned and
// it fills V (else element by element). A z face and the ghost beside it share a sector, and so do one
// row's high face and ghost and the next row's low ghost and face: the
// items of a row touch a few sectors, at once, from one thread and its warp
// neighbours, so each sector is read and written back about once.
template <class B, class V>
__device__ __forceinline__ void push_short_rows(const PushArgs& a,
                                                unsigned int word) {
  constexpr int M = sizeof(V) / sizeof(B);
  __shared__ const B* s_src[GROUP];
  __shared__ B* s_dst[GROUP];
  __shared__ int s_fill[GROUP];
  const bool whole = a.len == M;
  for (int g0 = 0; g0 < a.nitems; g0 += GROUP) {
    const int n = min(GROUP, a.nitems - g0);
    if ((int)threadIdx.x < n) {
      const HaloItem& it = a.items[g0 + threadIdx.x];
      s_src[threadIdx.x] = static_cast<const B*>(it.src) + slab_at(a, it.src_off);
      s_dst[threadIdx.x] = static_cast<B*>(it.dst) + slab_at(a, it.dst_off);
      s_fill[threadIdx.x] = it.fill;
    }
    __syncthreads();
    for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < a.rows;
         r += gridDim.x * blockDim.x) {
      const int pa = r / a.e1;  // slab plane and row within it
      const int64_t o = pa * a.P1P2 + (int64_t)(r - pa * a.e1) * a.P2;
      V t[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        t[k] = bits_as<V>(word);
        if (k >= n || s_fill[k]) continue;
        const B* p = s_src[k] + o;
        const uintptr_t x = reinterpret_cast<uintptr_t>(p) |
                            reinterpret_cast<uintptr_t>(s_dst[k] + o);
        if (whole && (x & (sizeof(V) - 1)) == 0) {
          t[k] = *reinterpret_cast<const V*>(p);
        } else {
          B* e = reinterpret_cast<B*>(&t[k]);
#pragma unroll
          for (int i = 0; i < M; ++i) {
            if (i < a.len) e[i] = p[i];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        if (k >= n) continue;
        B* p = s_dst[k] + o;
        const uintptr_t x =
            reinterpret_cast<uintptr_t>(p) |
            (s_fill[k] ? 0 : reinterpret_cast<uintptr_t>(s_src[k] + o));
        if (whole && (x & (sizeof(V) - 1)) == 0) {
          *reinterpret_cast<V*>(p) = t[k];
        } else {
          const B* e = reinterpret_cast<const B*>(&t[k]);
#pragma unroll
          for (int i = 0; i < M; ++i) {
            if (i < a.len) p[i] = e[i];
          }
        }
      }
    }
    __syncthreads();  // the group's table is read
  }
}

// Longer rows: block b copies a range of one item's rows.
template <class B>
__device__ __forceinline__ void push_rows(const PushArgs& a,
                                          unsigned int word) {
  // range-major: the blocks of every item's j-th range run together
  const int blk = blockIdx.x / a.nitems;
  const int item = blockIdx.x - blk * a.nitems;
  const HaloItem it = a.items[item];
  const bool fill = it.fill != 0;
  const B bc = static_cast<B>(a.bc_bits);
  const B* src = static_cast<const B*>(it.src) + slab_at(a, it.src_off);
  B* dst = static_cast<B*>(it.dst) + slab_at(a, it.dst_off);
  const bool by_warp = a.len >= WARP_ROW;  // uniform across the launch
  const int r0 = blk * (by_warp ? ROWS_WARP : ROWS_THREAD);
  const int r1 = min(a.rows, r0 + (by_warp ? ROWS_WARP : ROWS_THREAD));
  const int lane = by_warp ? (int)(threadIdx.x & 31) : 0;
  const int step = by_warp ? WARPS : THREADS;
  for (int r = r0 + (by_warp ? (int)(threadIdx.x >> 5) : (int)threadIdx.x);
       r < r1; r += step) {
    const int pa = r / a.e1;  // slab plane and row within it
    const int64_t o = pa * a.P1P2 + (int64_t)(r - pa * a.e1) * a.P2;
    copy_row<B>(dst + o, src + o, a.len, lane, by_warp ? 32 : 1, fill, bc,
                word);
  }
}

// The push of one launch: short rows moved as V (an instance each, so each
// has the registers its path needs), or, for V = ByRows, longer rows.
struct ByRows {};

template <class B, class V>
__global__ void __launch_bounds__(THREADS) halo_push_kernel(PushArgs a) {
  const unsigned int word =
      sizeof(B) == 2 ? (a.bc_bits & 0xFFFFu) * 0x10001u : a.bc_bits;
  if constexpr (std::is_same<V, ByRows>::value) {
    push_rows<B>(a, word);
  } else {
    push_short_rows<B, V>(a, word);
  }
  // arrival: this block's stores are visible system-wide before it counts
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(a.counter, 1u) == gridDim.x - 1) {
    atomicExch(a.counter, 0u);  // the next launch starts at 0
    __threadfence_system();
    for (int i = 0; i < a.nitems; ++i) {
      unsigned long long* f = a.items[i].flag;
      if (f != nullptr) store_release_sys(f, a.epoch);
    }
  }
}

__global__ void halo_wait_kernel(const HaloWait* w, int n,
                                 unsigned long long epoch,
                                 long long timeout_ns, unsigned int* err) {
  const int i = threadIdx.x;
  if (i >= n) return;
  const HaloWait e = w[i];
  spin_until(e.flag, epoch, globaltimer_ns(), timeout_ns, e.code, err);
}

// Blocks of the push launch: a thread a row across the items (short rows;
// SHORT_ROWS rows at a time, looping), else each item's rows in ranges.
long long push_blocks(const HaloLaunch& l) {
  const long long rows = (long long)l.E[0] * l.E[1];
  if ((long long)l.E[2] * l.elem_bytes <= SHORT_BYTES) {
    return (std::min(rows, (long long)SHORT_ROWS) + SHORT_THREADS - 1) /
           SHORT_THREADS;
  }
  const int per = l.E[2] >= WARP_ROW ? ROWS_WARP : ROWS_THREAD;
  return l.nitems * ((rows + per - 1) / per);
}

template <class B>
void launch_push(const HaloLaunch& l, const PushArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)push_blocks(l));
  const int bytes = l.E[2] * (int)sizeof(B);
  if (bytes <= 4) {
    halo_push_kernel<B, uint32_t><<<grid, SHORT_THREADS, 0, s>>>(a);
  } else if (bytes <= 8) {
    halo_push_kernel<B, uint2><<<grid, SHORT_THREADS, 0, s>>>(a);
  } else if (bytes <= SHORT_BYTES) {
    halo_push_kernel<B, uint4><<<grid, SHORT_THREADS, 0, s>>>(a);
  } else {
    halo_push_kernel<B, ByRows><<<grid, THREADS, 0, s>>>(a);
  }
}

int enqueue(const HaloLaunch& l, unsigned long long epoch,
            unsigned int bc_bits, long long timeout_ns) {
  cudaStream_t s = static_cast<cudaStream_t>(l.stream);
  cudaEvent_t fork = static_cast<cudaEvent_t>(l.fork);
  cudaEvent_t join = static_cast<cudaEvent_t>(l.join);
  cudaError_t err;
  for (int i = 0; i < l.nothers; ++i) {
    err = cudaEventRecord(fork, static_cast<cudaStream_t>(l.others[i]));
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s, fork, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  PushArgs a;
  a.items = l.items;
  a.counter = l.counter;
  a.epoch = epoch;
  a.nitems = l.nitems;
  a.rows = l.E[0] * l.E[1];
  a.e1 = l.E[1];
  a.len = l.E[2];
  a.P1 = l.P[1];
  a.P2 = l.P[2];
  a.P1P2 = (long long)l.P[1] * l.P[2];
  a.bc_bits = bc_bits;
  if (l.elem_bytes == 4) {
    launch_push<uint32_t>(l, a, s);
  } else {
    launch_push<uint16_t>(l, a, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l.nwaits > 0) {
    const int threads = (l.nwaits + 31) / 32 * 32;
    halo_wait_kernel<<<1, threads, 0, s>>>(l.waits, l.nwaits, epoch,
                                           timeout_ns, g_err_dev);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaEventRecord(join, s);
  for (int i = 0; err == cudaSuccess && i < l.nothers; ++i) {
    err = cudaStreamWaitEvent(static_cast<cudaStream_t>(l.others[i]), join, 0);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The error word the wait kernel writes on a timeout: mapped, portable host
// memory, allocated once. Returns a cudaError_t (0 on success).
int heat3d_halo_init() { return alloc_error_word(); }

// 0, or the code of the first wait that timed out (1 + shard rank * 4 +
// axis).
unsigned int heat3d_halo_error() { return read_error_word(); }

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

// The fork and join events of one table on `device` (no timing). Returns a
// cudaError_t. Restores the current device.
int heat3d_halo_events(int device, void** fork, void** join) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  cudaEvent_t f = nullptr, j = nullptr;
  if (err == cudaSuccess) {
    err = cudaEventCreateWithFlags(&f, cudaEventDisableTiming);
  }
  if (err == cudaSuccess) {
    err = cudaEventCreateWithFlags(&j, cudaEventDisableTiming);
  }
  *fork = f;
  *join = j;
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

void heat3d_halo_event_free(void* e) {
  if (e != nullptr) cudaEventDestroy(static_cast<cudaEvent_t>(e));
}

// Layout checks for the wrapper's ctypes structures.
int heat3d_halo_item_bytes() { return (int)sizeof(HaloItem); }
int heat3d_halo_wait_bytes() { return (int)sizeof(HaloWait); }
int heat3d_halo_launch_bytes() { return (int)sizeof(HaloLaunch); }

// One axis of the exchange on one device: the fork, the push launch over
// every item, the wait launch over every owed flag word, the join. Returns
// a cudaError_t (0 on success); 1000 for bad arguments (or the error word
// not allocated, heat3d_halo_init). Restores the current device.
int heat3d_halo_exchange(const HaloLaunch* l, unsigned long long epoch,
                         unsigned int bc_bits, long long timeout_ns) {
  if (g_err_dev == nullptr || l == nullptr || l->items == nullptr ||
      l->counter == nullptr || l->nitems < 1 || l->nwaits < 0 ||
      l->nwaits > 1024 || (l->nwaits > 0 && l->waits == nullptr) ||
      (l->elem_bytes != 2 && l->elem_bytes != 4) || l->stream == nullptr ||
      l->fork == nullptr || l->join == nullptr ||
      (l->nothers > 0 && l->others == nullptr)) {
    return 1000;
  }
  for (int a = 0; a < 3; ++a) {
    if (l->E[a] < 1 || l->P[a] < l->E[a]) return 1000;
  }
  if ((long long)l->E[0] * l->E[1] >= (1ll << 31) ||
      push_blocks(*l) >= (1ll << 31)) {
    return 1000;
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != l->device) {
    err = cudaSetDevice(l->device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int res = enqueue(*l, epoch, bc_bits, timeout_ns);
  if (prev != l->device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (res == 0 && back != cudaSuccess) return static_cast<int>(back);
  }
  return res;
}

}  // extern "C"
