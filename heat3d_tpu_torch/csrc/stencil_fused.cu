// Fused halo-exchange + stencil kernels for Hopper (sm_90a): one update
// (halo 1) or two fused updates (halo 2) of every x-slab shard a device
// holds, with the x-face pushes to the ring neighbours made inside the same
// kernel and in flight while the interior planes are swept.
//
// Replaces heat3d_tpu/ops/stencil_dma_fused.py:
//   * ::apply_step_fused_dma (_fused_kernel, protocol _rdma_halo) and
//   * ::apply_superstep_fused_dma (_fused2_kernel),
// and heat3d_tpu/ops/stencil_fused_rdma.py:
//   * ::apply_step_fused_rdma / ::apply_superstep_fused_rdma (the same
//     sweeps with the sends split per ExchangePlan sub-block, _planned_rdma)
// -> fused_chain_kernel<T, H, S, M> (H = 1 or 2 updates, the chain S fixed
// at compile time, the arithmetic policy M of stencil_common.cuh: F32Math
// or Bf16Math) and fused_kernel<T, H> (any other chain: the generic
// instance, the first design, its compute dtype Program::bf16), each
// driven by a table of send ranges (one
// y-range per face for the DMA rows, the plan's ranges for the RDMA rows),
// with one flag word per (receiver, side, range).
//
// Bound: device-memory bytes, as the direct kernels: the field read once and
// written once, plus each face slab read once and written once into the
// neighbour's landing buffer.
//
// Design. One cooperative launch per device covers every shard the device
// holds (all shards of a mesh on one card are one launch), with a grid of
// resident blocks (occupancy x SMs), so no block can wait on work that has
// no SM. Each block walks three lists of tiles in order, striding by the
// grid:
//   1. push tiles: chunks of the sends. A send copies the sender's x-face
//      slab (planes nx-H..nx-1 to the high neighbour, 0..H-1 to the low one)
//      over one y-range into the receiver's landing buffer (through a peer
//      pointer when the receiver is on another GPU). Every block fences at
//      system scope and arrives on the send's counter; the last one resets
//      it, fences again and release-stores the epoch into the receiver's
//      flag word for that range (the TPU kernel's send/recv semaphores).
//   2. interior tiles: (shard, x-chunk, y tile, z tile) of the output planes
//      H..nx-H-1, which read only the shard's own planes. They run while
//      the faces fly.
//   3. skin tiles: (shard, side, y tile, z tile) of output planes 0..H-1 and
//      nx-H..nx-1. Thread 0 acquire-spins on the shard's flags of that side
//      (bounded: ~2 s of globaltimer, then the error word and a trap, as in
//      halo_dma.cu), then the block sweeps its output planes.
// Every block finishes its pushes before it waits, and every block is
// resident, so on one card the waits always end. Across GPUs, a device's
// launch waits (an event) until each receiver's device has entered the
// same exchange, so a push never lands in a buffer a previous step still
// reads, nor in flags not yet zeroed (ops/stencil_dma_fused.py).
//
// fused_chain_kernel<T, H, S, M> (the 7pt and 27pt chains of the wrapper's
// table, ops/stencil_stream.py CHAINS) sweeps a tile with
// direct_kernel<T, H, S, M>'s block state (stencil_direct.cuh): 32 x 8 threads
// own a 64 x 40 (H = 1) or 64 x 32 (H = 2) frame, x-neighbours in
// registers, the chain unrolled, input planes loaded ahead by cp.async, the
// y/z ghosts built by the loader as a domain boundary (wrap or bc), at H = 2
// the level-1 plane in one shared slot, rounded to T and pinned to bc
// outside the domain. Interior tiles read the shard's own planes only, so
// they take the field's plane source (FieldPlanes, nothing landed: the
// sweep of direct_kernel itself). Skin tiles take ShardPlanes<T, H>: input
// plane gx is the shard's own plane (0 <= gx < nx), plane gx + H or gx - nx
// of the (H, ny, nz) landing buffer a neighbour pushes into, or bc at a
// Dirichlet x domain face, where the level-1 plane is pinned to bc too
// (is_bc). A skin tile reads its H landed planes after its acquire, with
// synchronous ld.global.cg loads: another block or GPU wrote them during
// the launch, so they must not come through L1. A send's slab is H runs of
// (y1 - y0) * nz elements, one a plane, pushed as 16-byte vectors where the
// source and destination share their alignment (copy_rows.cuh).
//
// fused_kernel<T, H> is the first design: the tap program interpreted
// per cell from shared memory (stencil_common.cuh) over a 3-slot float ring
// of ghost-framed (16, 64) tiles loaded synchronously, element by element.
// The halo-2 kernel keeps a second ring of intermediate planes, rounded
// through the storage type, pinned to bc in the y/z ring (Dirichlet) and at
// the x domain faces, exactly as two plain steps see them.
//
// Arithmetic contract: the emission program of stencil_common.cuh, in the
// order of the unrolled chain or of the interpreter, so each kernel equals
// its plain version (ops.stencil_dma_fused.reference_fused_*) bitwise.
//
// Measured (chip_smoke.py fused_times, "NVIDIA H100 80GB HBM3, 700.00 W"),
// 1024^3 fp32 7pt in one launch over all shards, over (8,1,1) / (4,1,1):
// fused_chain_kernel at H = 1 5.69 / 5.55 ms (78 registers, no spills;
// bytes bound 2.60 / 2.58), at H = 2 6.86 / 6.30 (80 registers, 12 bytes
// of spills; bound 2.63 / 2.59), both at 3 blocks/SM; the generic
// fused_kernel<T,1> 12.82 / 12.61 and fused_kernel<T,2> 25.33 / 24.91 in
// the same call; PERF.md section 6 rows 9-12. In bf16 compute
// (compute_bf16_times, fp32 storage, 7pt, the fp32-compute instance of the
// same call in brackets): H = 1 7.93 [5.70] / 7.71 [5.50], H = 2 14.82
// [6.55] / 14.37 [6.14], 3 blocks/SM, 80 registers.
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError() (or the launch's own error).

#include "copy_rows.cuh"
#include "stencil_direct.cuh"
#include "sync_flags.cuh"

constexpr int MAX_LOCAL = 16;  // shards of one launch (one device)
constexpr int MAX_PARTS = 8;   // send ranges per face

// One shard of the launch: static for the life of its state.
struct FusedShard {
  void* glo;                  // landing buffer, low ghost slab (H, ny, nz)
  void* ghi;                  // landing buffer of the high ghost slab
  unsigned long long* flags;  // [2][MAX_PARTS]: side 0 low ghost, 1 high
  int nparts;                 // ranges per face
  int wait_lo;                // 1: the low ghost is pushed by a neighbour
  int wait_hi;
  int rank;                   // the shard's rank (error codes)
};

// One send: a y-range of one x-face slab into one receiver's landing buffer.
struct FusedSend {
  void* dst;                  // receiver's landing buffer (peer pointer)
  unsigned long long* flag;   // receiver's flag word of this range
  unsigned int* counter;      // arrival counter (sender's device)
  int shard;                  // local index of the sender
  int x0;                     // first source plane
  int y0;                     // y-range [y0, y1)
  int y1;
  int tile0;                  // first push tile of this send
  int ntiles;
};

struct FusedArgs {
  const void* u[MAX_LOCAL];
  void* out[MAX_LOCAL];
  const FusedShard* shards;   // device memory, nlocal entries
  const FusedSend* sends;     // device memory, nsends entries (tile0 ascending)
  unsigned long long epoch;
  long long timeout_ns;
  int nlocal;
  int nsends;
  int push_tiles;
  int nx;
  int ny;
  int nz;
  int xchunk;                 // interior x-chunk length
  int periodic;
  float bc;                   // bc rounded to the storage type
  Program prog;
};

namespace {

// Elements of one push tile. Each tile ends in a system-scope fence, a
// barrier and an arrival: 128 KB (fp32) tiles took the two-update launch
// 6.90 / 6.62 ms over (8,1,1) and 6.62 / 6.27 over (4,1,1) where 8 KB
// tiles took 6.93 and 6.85 (chip_smoke.py fused_times on copies with this
// constant edited, one call, "NVIDIA H100 80GB HBM3, 700.00 W"); the
// one-update launch did not move.
constexpr int PUSH_CHUNK = NTHREADS * 128;

template <class T>
struct Bits;
template <>
struct Bits<float> {
  typedef uint32_t type;
};
template <>
struct Bits<__nv_bfloat16> {
  typedef uint16_t type;
};

// Loads of one plane element: the shard's own planes are read-only for the
// launch (the read-only path); a landing-buffer plane was written during it
// by another block or another GPU, so it is read bypassing L1.
__device__ __forceinline__ float load_own(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_own(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float load_landed(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float load_landed(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ int wrapi(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

template <class T, int F, bool LANDED>
__device__ __forceinline__ void fill_plane(float* dst, const T* src, int y0,
                                           int z0, int ny, int nz,
                                           bool periodic, float bc) {
  constexpr int FY = TY + 2 * F;
  constexpr int FZ = TZ + 2 * F;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int idx = tid; idx < FY * FZ; idx += NTHREADS) {
    const int a = idx / FZ;
    const int b = idx - a * FZ;
    int gy = y0 - F + a;
    int gz = z0 - F + b;
    float v = bc;
    if (periodic) {
      gy = wrapi(gy, ny);
      gz = wrapi(gz, nz);
    }
    if (gy >= 0 && gy < ny && gz >= 0 && gz < nz) {
      const T* p = src + (int64_t)gy * nz + gz;
      v = LANDED ? load_landed(p) : load_own(p);
    }
    dst[idx] = v;
  }
}

// Load plane `src` (a (ny, nz) plane, or null: all bc) into a (TY+2F,
// TZ+2F) slot, the y/z frame a domain boundary (wrap or bc).
template <class T, int F>
__device__ __forceinline__ void load_src_plane(float* dst, const T* src,
                                               bool landing, int y0, int z0,
                                               int ny, int nz, bool periodic,
                                               float bc) {
  if (src == nullptr) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int idx = tid; idx < (TY + 2 * F) * (TZ + 2 * F); idx += NTHREADS) {
      dst[idx] = bc;
    }
  } else if (landing) {
    fill_plane<T, F, true>(dst, src, y0, z0, ny, nz, periodic, bc);
  } else {
    fill_plane<T, F, false>(dst, src, y0, z0, ny, nz, periodic, bc);
  }
}

// The plane of virtual x index gx of local shard `li`: its own plane, a
// landing plane, or null (bc at a Dirichlet x domain face).
template <class T, int H>
__device__ __forceinline__ const T* plane_of(const FusedArgs& a,
                                             const FusedShard& sh, int li,
                                             int gx, bool* landing) {
  const int64_t plane = (int64_t)a.ny * a.nz;
  *landing = false;
  if (gx >= 0 && gx < a.nx) {
    return static_cast<const T*>(a.u[li]) + gx * plane;
  }
  if (gx < 0) {
    if (!sh.wait_lo) return nullptr;
    *landing = true;
    return static_cast<const T*>(sh.glo) + (gx + H) * plane;
  }
  if (!sh.wait_hi) return nullptr;
  *landing = true;
  return static_cast<const T*>(sh.ghi) + (gx - a.nx) * plane;
}

// Output planes [xs, xe) of tile (y0, z0) of shard li: one update.
template <class T>
__device__ __forceinline__ void march1(const FusedArgs& a,
                                       const FusedShard& sh, int li,
                                       const Program& sp, float* ring,
                                       int y0, int z0, int xs, int xe) {
  constexpr int FZ = TZ + 2;
  constexpr int PS = (TY + 2) * FZ;
  const bool periodic = a.periodic != 0;
  T* __restrict__ out = static_cast<T*>(a.out[li]);
  for (int i = 0; i < xe - xs + 2; ++i) {
    bool landing;
    const T* src = plane_of<T, 1>(a, sh, li, xs - 1 + i, &landing);
    load_src_plane<T, 1>(ring + (i % 3) * PS, src, landing, y0, z0, a.ny,
                         a.nz, periodic, a.bc);
    __syncthreads();
    if (i >= 2) {
      const float* pm = ring + ((i - 2) % 3) * PS;
      const float* p0 = ring + ((i - 1) % 3) * PS;
      const float* pp = ring + (i % 3) * PS;
      const int64_t ox = xs + i - 2;
      for (int ty = threadIdx.y; ty < TY; ty += BY) {
        const int gy = y0 + ty;
        const int gz = z0 + threadIdx.x;
        if (gy < a.ny && gz < a.nz) {
          const float r =
              apply_program(sp, pm, p0, pp, ty + 1, threadIdx.x + 1, FZ);
          out[(ox * a.ny + gy) * a.nz + gz] = from_f<T>(r);
        }
      }
    }
    __syncthreads();
  }
}

// Output planes [xs, xe) of tile (y0, z0) of shard li: two fused updates.
template <class T>
__device__ __forceinline__ void march2(const FusedArgs& a,
                                       const FusedShard& sh, int li,
                                       const Program& sp, float* ring_a,
                                       float* ring_b, int y0, int z0, int xs,
                                       int xe) {
  constexpr int FAZ = TZ + 4;
  constexpr int PA = (TY + 4) * FAZ;
  constexpr int FBZ = TZ + 2;
  constexpr int PB = (TY + 2) * FBZ;
  const bool periodic = a.periodic != 0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  T* __restrict__ out = static_cast<T*>(a.out[li]);
  // slot i%3 of ring_a holds input plane xs-2+i; from i >= 2 the mid plane
  // xs-3+i goes to slot (i-2)%3 of ring_b; from i >= 4 output plane xs+i-4
  for (int i = 0; i < xe - xs + 4; ++i) {
    bool landing;
    const T* src = plane_of<T, 2>(a, sh, li, xs - 2 + i, &landing);
    load_src_plane<T, 2>(ring_a + (i % 3) * PA, src, landing, y0, z0, a.ny,
                         a.nz, periodic, a.bc);
    __syncthreads();
    if (i >= 2) {
      const float* pm = ring_a + ((i - 2) % 3) * PA;
      const float* p0 = ring_a + ((i - 1) % 3) * PA;
      const float* pp = ring_a + (i % 3) * PA;
      float* dst = ring_b + ((i - 2) % 3) * PB;
      const int gm = xs - 3 + i;
      // the intermediate's x ghost plane at a Dirichlet domain face
      const bool x_ghost =
          (gm < 0 && !sh.wait_lo) || (gm >= a.nx && !sh.wait_hi);
      for (int idx = tid; idx < PB; idx += NTHREADS) {
        const int r = idx / FBZ;
        const int c = idx - r * FBZ;
        const int gy = y0 - 1 + r;
        const int gz = z0 - 1 + c;
        float v;
        if (!periodic &&
            (x_ghost || gy < 0 || gy >= a.ny || gz < 0 || gz >= a.nz)) {
          v = a.bc;
        } else {
          v = to_f(from_f<T>(
              apply_program(sp, pm, p0, pp, r + 1, c + 1, FAZ)));
        }
        dst[idx] = v;
      }
    }
    __syncthreads();
    if (i >= 4) {
      const float* pm = ring_b + ((i - 4) % 3) * PB;
      const float* p0 = ring_b + ((i - 3) % 3) * PB;
      const float* pp = ring_b + ((i - 2) % 3) * PB;
      const int64_t ox = xs + i - 4;
      for (int ty = threadIdx.y; ty < TY; ty += BY) {
        const int gy = y0 + ty;
        const int gz = z0 + threadIdx.x;
        if (gy < a.ny && gz < a.nz) {
          const float r =
              apply_program(sp, pm, p0, pp, ty + 1, threadIdx.x + 1, FBZ);
          out[(ox * a.ny + gy) * a.nz + gz] = from_f<T>(r);
        }
      }
    }
  }
  __syncthreads();
}

// Push tile t: its chunk of one send, then the arrival; the last arrival of
// the send publishes the epoch into the receiver's flag word.
template <class T, int H>
__device__ void push_tile(const FusedArgs& a, int t) {
  typedef typename Bits<T>::type B;
  int s = 0;
  while (s + 1 < a.nsends && a.sends[s + 1].tile0 <= t) ++s;
  const FusedSend snd = a.sends[s];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ry = snd.y1 - snd.y0;
  const int64_t n = (int64_t)H * ry * a.nz;
  const int64_t plane = (int64_t)a.ny * a.nz;
  const int64_t lo = (int64_t)(t - snd.tile0) * PUSH_CHUNK;
  const int64_t hi = lo + PUSH_CHUNK < n ? lo + PUSH_CHUNK : n;
  B* dst = static_cast<B*>(snd.dst);
  const B* src = static_cast<const B*>(a.u[snd.shard]);
  for (int64_t i = lo + tid; i < hi; i += NTHREADS) {
    const int c = (int)(i % a.nz);
    const int64_t r = i / a.nz;
    const int yy = snd.y0 + (int)(r % ry);
    const int q = (int)(r / ry);
    const int64_t row = (int64_t)yy * a.nz + c;
    dst[q * plane + row] = src[(snd.x0 + q) * plane + row];
  }
  // arrival: this block's stores are visible system-wide before it counts
  __threadfence_system();
  __syncthreads();
  if (tid == 0) {
    if (atomicAdd(snd.counter, 1u) == (unsigned int)snd.ntiles - 1u) {
      atomicExch(snd.counter, 0u);  // the next launch starts at 0
      __threadfence_system();
      store_release_sys(snd.flag, a.epoch);
    }
  }
  __syncthreads();
}

template <class T, int H>
__global__ void __launch_bounds__(NTHREADS)
    fused_kernel(FusedArgs a, unsigned int* err) {
  constexpr int RING = H == 1 ? 3 * (TY + 2) * (TZ + 2)
                              : 3 * (TY + 4) * (TZ + 4);
  constexpr int RING_B = H == 1 ? 1 : 3 * (TY + 2) * (TZ + 2);
  __shared__ float ring[RING];
  __shared__ float ring_b[RING_B];
  __shared__ Program sp;
  copy_program(&sp, a.prog);
  __syncthreads();
  const int G = gridDim.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // 1. pushes
  for (int t = blockIdx.x; t < a.push_tiles; t += G) push_tile<T, H>(a, t);

  const int nyt = (a.ny + TY - 1) / TY;
  const int nzt = (a.nz + TZ - 1) / TZ;
  const int yz = nyt * nzt;

  // 2. interior: output planes [H, nx-H), local data only
  const int inner = a.nx - 2 * H;
  const int nchunks = inner > 0 ? (inner + a.xchunk - 1) / a.xchunk : 0;
  const int interior_tiles = a.nlocal * nchunks * yz;
  for (int t = blockIdx.x; t < interior_tiles; t += G) {
    const int li = t / (nchunks * yz);
    const int rest = t - li * nchunks * yz;
    const int ch = rest / yz;
    const int tyz = rest - ch * yz;
    const int y0 = (tyz / nzt) * TY;
    const int z0 = (tyz % nzt) * TZ;
    const int xs = H + ch * a.xchunk;
    const int xe = min(a.nx - H, xs + a.xchunk);
    const FusedShard sh = a.shards[li];
    if constexpr (H == 1) {
      march1<T>(a, sh, li, sp, ring, y0, z0, xs, xe);
    } else {
      march2<T>(a, sh, li, sp, ring, ring_b, y0, z0, xs, xe);
    }
  }

  // 3. skin: output planes [0, H) and [nx-H, nx), after the waits
  const int skin_tiles = a.nlocal * 2 * yz;
  for (int t = blockIdx.x; t < skin_tiles; t += G) {
    const int li = t / (2 * yz);
    const int rest = t - li * 2 * yz;
    const int side = rest / yz;
    const int tyz = rest - side * yz;
    const int y0 = (tyz / nzt) * TY;
    const int z0 = (tyz % nzt) * TZ;
    const FusedShard sh = a.shards[li];
    if (tid == 0 && (side == 0 ? sh.wait_lo : sh.wait_hi)) {
      const unsigned long long t0 = globaltimer_ns();
      const unsigned int code = 1u + 2u * (unsigned int)sh.rank + side;
      for (int p = 0; p < sh.nparts; ++p) {
        spin_until(sh.flags + side * MAX_PARTS + p, a.epoch, t0,
                   a.timeout_ns, code, err);
      }
      __threadfence();
    }
    __syncthreads();
    const int xs = side == 0 ? 0 : a.nx - H;
    if constexpr (H == 1) {
      march1<T>(a, sh, li, sp, ring, y0, z0, xs, xs + 1);
    } else {
      march2<T>(a, sh, li, sp, ring, ring_b, y0, z0, xs, xs + 2);
    }
  }
}

// ---------------------------------------------------------------------------
// The compile-time instances: fused_chain_kernel<T, H, S, M>, the sweep of
// direct_kernel<T, H, S, M> (stencil_direct.cuh) over the shard's planes,
// the landing buffers and bc.

// The input planes of a skin tile's shard for H updates: its own
// (0 <= gx < nx), the landed ghost planes -H..-1 and nx..nx+H-1 (the
// landing buffers, each (H, ny, nz)), or bc (null: a Dirichlet x domain
// face, no neighbour).
template <class T, int H>
struct ShardPlanes {
  static constexpr bool kLands = true;
  const T* u;
  const T* lo;  // planes -H..-1
  const T* hi;  // planes nx..nx+H-1
  int64_t plane;
  int nx;
  // a landed plane's index in its landing buffer
  __device__ __forceinline__ int slab(int gx) const {
    return gx < 0 ? gx + H : gx - nx;
  }
  __device__ __forceinline__ const T* at(int gx) const {
    if (!landed(gx)) return u + gx * plane;
    const T* b = gx < 0 ? lo : hi;
    return b == nullptr ? nullptr : b + slab(gx) * plane;
  }
  __device__ __forceinline__ bool is_bc(int gx) const {
    return at(gx) == nullptr;
  }
  __device__ __forceinline__ bool landed(int gx) const {
    return gx < 0 || gx >= nx;
  }
  // bf16: a landed plane starts at the parity of its slab offset
  __device__ __forceinline__ int parity(int gx) const {
    return (int)((landed(gx) ? slab(gx) : gx) & plane & 1);
  }
};

// Push tile t: its chunk of one send, the sender's planes x0..x0+H-1 over
// rows [y0, y1). Those are H runs of (y1 - y0) * nz elements, one a plane
// (they meet when the range is the whole face), laid end to end as the
// host counts the send's tiles (ceil(H * (y1 - y0) * nz / PUSH_CHUNK));
// each run's part of the chunk is copied as vectors where the source and
// destination allow. Then the arrival, as in push_tile.
template <class T, int H>
__device__ void push_flat(const FusedArgs& a, int t) {
  typedef typename Bits<T>::type B;
  int s = 0;
  while (s + 1 < a.nsends && a.sends[s + 1].tile0 <= t) ++s;
  const FusedSend snd = a.sends[s];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int64_t plane = (int64_t)a.ny * a.nz;
  const int64_t at = (int64_t)snd.y0 * a.nz;
  const int64_t run = (int64_t)(snd.y1 - snd.y0) * a.nz;
  const int64_t lo = (int64_t)(t - snd.tile0) * PUSH_CHUNK;
  const int64_t hi = lo + PUSH_CHUNK < H * run ? lo + PUSH_CHUNK : H * run;
  const B* src = static_cast<const B*>(a.u[snd.shard]) +
                 (int64_t)snd.x0 * plane + at;
  B* dst = static_cast<B*>(snd.dst) + at;
#pragma unroll
  for (int q = 0; q < H; ++q) {
    const int64_t b = lo > q * run ? lo : q * run;
    const int64_t e = hi < (q + 1) * run ? hi : (q + 1) * run;
    if (b < e) {
      const int64_t o = q * plane + (b - q * run);
      copy_row<B>(dst + o, src + o, (int)(e - b), tid, SNT, false, B(0), 0u);
    }
  }
  // arrival: this block's stores are visible system-wide before it counts
  __threadfence_system();
  __syncthreads();
  if (tid == 0) {
    if (atomicAdd(snd.counter, 1u) == (unsigned int)snd.ntiles - 1u) {
      atomicExch(snd.counter, 0u);  // the next launch starts at 0
      __threadfence_system();
      store_release_sys(snd.flag, a.epoch);
    }
  }
}

// Launch bounds: three blocks an SM, so a thread may hold 85 registers.
// One update: at four (64) the tile loops spill (chip probe: 3 blocks/SM, no
// spills, ran faster than 4 or 5 with spills). Two updates, 7pt fp32 at
// 1024^3 over (8,1,1) / (4,1,1) (chip_smoke.py fused_times on copies with
// this bound edited, "NVIDIA H100 80GB HBM3, 700.00 W"): 3 blocks/SM, 80
// registers, 12 bytes of spills, 6.93 / 6.85 ms against 4 blocks/SM, 64
// registers, 4 bytes of spills, 7.80 / 6.73 and 7.56 / 7.05 in the same
// call; 2 blocks/SM, 117 registers, no spills, lost to 3 in an earlier
// call (8.66 / 7.68 against 7.79 / 7.44).
constexpr int CHAIN_MIN_BLOCKS = 3;

// A sweep's block state over the launch's geometry, its slots in `smem`.
template <class T, int H, int S, class M, class Src>
__device__ __forceinline__ void init_sweep(Direct<T, H, S, M, Src>& st,
                                           unsigned char* smem,
                                           const FusedArgs& a) {
  using G = Geom<H>;
  st.in_slot = reinterpret_cast<T*>(smem);
  st.lvl = st.in_slot + in_slots<T, H, S>() * G::FH * in_stride<T, H>();
  st.xsp = reinterpret_cast<float*>(st.lvl + (H - 1) * G::FH * G::FW);
  st.ny = a.ny;
  st.nz = a.nz;
  st.periodic = a.periodic;
  st.bc = M::template read<T>(a.bc);
}

template <class T, int H, int S, class M>
__global__ void __launch_bounds__(SNT, CHAIN_MIN_BLOCKS)
    fused_chain_kernel(FusedArgs a, Weights w, unsigned int* err) {
  static_assert(centre_x_only<S>(),
                "chain reads x-1/x+1 planes off the cell: generic instance");
  using G = Geom<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NB = gridDim.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // 1. pushes
  for (int t = blockIdx.x; t < a.push_tiles; t += NB) push_flat<T, H>(a, t);

  const int64_t plane = (int64_t)a.ny * a.nz;
  const int nzt = (a.nz + G::TZ - 1) / G::TZ;
  const int yz = ((a.ny + G::TY - 1) / G::TY) * nzt;

  // 2. interior: output planes [H, nx-H). Their input planes are the
  // shard's own, so the field's plane source serves (no wrap, nothing
  // landed: the sweep state of direct_kernel).
  {
    Direct<T, H, S, M, FieldPlanes<T>> st;
    init_sweep(st, smem_raw, a);
    const int inner = a.nx - 2 * H;
    const int nchunks = inner > 0 ? (inner + a.xchunk - 1) / a.xchunk : 0;
    const int interior_tiles = a.nlocal * nchunks * yz;
    for (int t = blockIdx.x; t < interior_tiles; t += NB) {
      const int li = t / (nchunks * yz);
      const int rest = t - li * nchunks * yz;
      const int ch = rest / yz;
      const int tyz = rest - ch * yz;
      st.src = FieldPlanes<T>{static_cast<const T*>(a.u[li]), plane, a.nx, 0};
      st.out = static_cast<T*>(a.out[li]);
      st.y0 = (tyz / nzt) * G::TY;
      st.z0 = (tyz % nzt) * G::TZ;
      st.xs0 = H + ch * a.xchunk;
      __syncthreads();  // the previous tile has read its slots
      st.run(min(a.nx - H, st.xs0 + a.xchunk), w);
    }
  }

  // 3. skin: output planes [0, H) and [nx-H, nx), after the waits
  Direct<T, H, S, M, ShardPlanes<T, H>> st;
  init_sweep(st, smem_raw, a);
  const int skin_tiles = a.nlocal * 2 * yz;
  for (int t = blockIdx.x; t < skin_tiles; t += NB) {
    const int li = t / (2 * yz);
    const int rest = t - li * 2 * yz;
    const int side = rest / yz;
    const int tyz = rest - side * yz;
    const FusedShard sh = a.shards[li];
    st.src = ShardPlanes<T, H>{
        static_cast<const T*>(a.u[li]),
        sh.wait_lo ? static_cast<const T*>(sh.glo) : nullptr,
        sh.wait_hi ? static_cast<const T*>(sh.ghi) : nullptr, plane, a.nx};
    st.out = static_cast<T*>(a.out[li]);
    st.y0 = (tyz / nzt) * G::TY;
    st.z0 = (tyz % nzt) * G::TZ;
    st.xs0 = side == 0 ? 0 : a.nx - H;
    __syncthreads();  // the previous tile has read its slots
    if (tid == 0 && (side == 0 ? sh.wait_lo : sh.wait_hi)) {
      const unsigned long long t0 = globaltimer_ns();
      const unsigned int code = 1u + 2u * (unsigned int)sh.rank + side;
      for (int p = 0; p < sh.nparts; ++p) {
        spin_until(sh.flags + side * MAX_PARTS + p, a.epoch, t0,
                   a.timeout_ns, code, err);
      }
      __threadfence();
    }
    __syncthreads();
    st.run(st.xs0 + H, w);
  }
}

// Grid and launch of one instance: the cooperative grid is the resident
// blocks (occupancy x SMs), or fewer when there are fewer tiles.
int cooperative_grid(const void* fn, int threads, int smem, long long want,
                     int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return 1002;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return 1003;
  const long long cap = (long long)per_sm * sms;
  *grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  return 0;
}

// The compile-time instance of H updates of chain S under policy M.
template <class T, int H, int S, class M>
struct Chain {
  static constexpr int bytes = smem_bytes<T, H, S>();
  static const void* fn() {
    return reinterpret_cast<const void*>(fused_chain_kernel<T, H, S, M>);
  }
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> done{0};
    return set_smem_once(done, fused_chain_kernel<T, H, S, M>, bytes);
  }
  static int launch(const FusedArgs& a, cudaStream_t stream) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    using G = Geom<H>;
    const long long yz = (long long)((a.ny + G::TY - 1) / G::TY) *
                         ((a.nz + G::TZ - 1) / G::TZ);
    const int inner = a.nx - 2 * H;
    const int nchunks = inner > 0 ? (inner + a.xchunk - 1) / a.xchunk : 0;
    long long want = a.push_tiles;
    if ((long long)a.nlocal * nchunks * yz > want) {
      want = (long long)a.nlocal * nchunks * yz;
    }
    if ((long long)a.nlocal * 2 * yz > want) want = (long long)a.nlocal * 2 * yz;
    int grid = 0;
    const int res = cooperative_grid(fn(), SNT, bytes, want, &grid);
    if (res != 0) return res;
    FusedArgs args = a;
    Weights w;
    for (int i = 0; i < MAX_TERMS; ++i) w.w[i] = i < a.prog.n ? a.prog.t[i].w : 0.f;
    unsigned int* e = g_err_dev;
    void* params[] = {&args, &w, &e};
    err = cudaLaunchCooperativeKernel(fn(), dim3(grid), dim3(SBZ, SBY), params,
                                      bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
};

// The interpreted kernel of H updates (the generic instance at H = 1).
template <class T, int H>
int launch_interpreted(const FusedArgs& a, cudaStream_t stream) {
  const int nyt = (a.ny + TY - 1) / TY;
  const int nzt = (a.nz + TZ - 1) / TZ;
  const int inner = a.nx - 2 * H;
  const int nchunks = inner > 0 ? (inner + a.xchunk - 1) / a.xchunk : 0;
  long long want = a.push_tiles;
  const long long interior = (long long)a.nlocal * nchunks * nyt * nzt;
  const long long skin = (long long)a.nlocal * 2 * nyt * nzt;
  if (interior > want) want = interior;
  if (skin > want) want = skin;
  int grid = 0;
  const int res = cooperative_grid(
      reinterpret_cast<const void*>(fused_kernel<T, H>), NTHREADS, 0, want,
      &grid);
  if (res != 0) return res;
  FusedArgs args = a;
  unsigned int* e = g_err_dev;
  void* params[] = {&args, &e};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_kernel<T, H>), dim3(grid),
      dim3(BZ, BY), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The interpreted kernel as an instance.
template <class T, int H>
struct Interpreted {
  static constexpr int bytes = 0;
  static const void* fn() {
    return reinterpret_cast<const void*>(fused_kernel<T, H>);
  }
  static cudaError_t prepare() { return cudaSuccess; }
  static int launch(const FusedArgs& a, cudaStream_t stream) {
    return launch_interpreted<T, H>(a, stream);
  }
};

// f.template run<Instance, threads>() for instance (halo, spec, dtype,
// compute): spec 0 the interpreted kernel (both compute dtypes:
// Program::bf16), 1 / 2 the compile-time 7pt / 27pt chain.
template <class T, int H, class M, class F>
int by_spec(int spec, const F& f) {
  switch (spec) {
    case SPEC_7PT:
      return f.template run<Chain<T, H, SPEC_7PT, M>>(SNT);
    case SPEC_27PT:
      return f.template run<Chain<T, H, SPEC_27PT, M>>(SNT);
    default:
      return f.template run<Interpreted<T, H>>(NTHREADS);
  }
}

template <class T, class M, class F>
int by_halo(int halo, int spec, const F& f) {
  return halo == 1 ? by_spec<T, 1, M>(spec, f) : by_spec<T, 2, M>(spec, f);
}

template <class F>
int with_instance(int halo, int spec, int dtype, int compute, const F& f) {
  if ((dtype != 0 && dtype != 1) || (compute != 0 && compute != 1) ||
      (halo != 1 && halo != 2) || spec < SPEC_GENERIC || spec > SPEC_27PT) {
    return f.bad;
  }
  if (dtype == 0) {
    return compute == 0 ? by_halo<float, F32Math>(halo, spec, f)
                        : by_halo<float, Bf16Math>(halo, spec, f);
  }
  return compute == 0 ? by_halo<__nv_bfloat16, F32Math>(halo, spec, f)
                      : by_halo<__nv_bfloat16, Bf16Math>(halo, spec, f);
}

struct BlocksPerSm {
  int bad = -1;
  template <class I>
  int run(int threads) const {
    if (I::prepare() != cudaSuccess) return -1;
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, I::fn(), threads, I::bytes) == cudaSuccess
               ? n
               : -1;
  }
};
struct Registers {
  int bad = -1;
  template <class I>
  int run(int) const {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, I::fn()) == cudaSuccess
               ? attr.numRegs
               : -1;
  }
};
struct SmemBytes {
  int bad = -1;
  template <class I>
  int run(int) const { return I::bytes; }
};
struct Launch {
  int bad = 1000;
  const FusedArgs* a;
  cudaStream_t stream;
  template <class I>
  int run(int) const { return I::launch(*a, stream); }
};

}  // namespace

extern "C" {

int heat3d_fused_init() { return alloc_error_word(); }

// 0, or the code of the first wait that timed out (1 + 2 * shard rank +
// side).
unsigned int heat3d_fused_error() { return read_error_word(); }

// Resident blocks per SM of instance (halo, spec, dtype, compute) (the
// cooperative grid is this times the SM count), registers a thread and
// dynamic shared memory of one block; -1 on an error or for no such
// instance. spec: 0 the interpreted kernel, 1 / 2 the compile-time 7pt /
// 27pt chain.
int heat3d_fused_blocks_per_sm(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, BlocksPerSm{});
}
int heat3d_fused_registers(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, Registers{});
}
int heat3d_fused_smem_bytes(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, SmemBytes{});
}

// Constants the wrapper lays its tables out by, and the (y, z) tile of an
// instance (spec 0: the interpreted kernel's; else the chain's of `halo`
// updates).
int heat3d_fused_max_local() { return MAX_LOCAL; }
int heat3d_fused_max_parts() { return MAX_PARTS; }
int heat3d_fused_push_chunk() { return PUSH_CHUNK; }
int heat3d_fused_tile_y(int halo, int spec) {
  return spec == SPEC_GENERIC ? TY : halo == 1 ? Geom<1>::TY : Geom<2>::TY;
}
int heat3d_fused_tile_z(int halo, int spec) {
  return spec == SPEC_GENERIC ? TZ : halo == 1 ? Geom<1>::TZ : Geom<2>::TZ;
}
int heat3d_fused_args_bytes() { return (int)sizeof(FusedArgs); }
int heat3d_fused_shard_bytes() { return (int)sizeof(FusedShard); }
int heat3d_fused_send_bytes() { return (int)sizeof(FusedSend); }

// halo: 1 or 2 updates; spec as above (a chain's program must be that
// chain: prog's (src, row, dk)); dtype: 0 float, 1 bf16 storage; compute:
// 0 float, 1 bf16 (the program's weights already in that dtype; prog.bf16
// is set from it). Returns a cudaError_t (0 on success); 1000 for bad
// arguments, 1002 when the device cannot launch cooperatively, 1003 when
// no block fits an SM.
int heat3d_fused_launch(int halo, int spec, int dtype, int compute,
                        const FusedArgs* a, void* stream) {
  if (g_err_dev == nullptr || a == nullptr || (halo != 1 && halo != 2) ||
      (dtype != 0 && dtype != 1) || (compute != 0 && compute != 1) ||
      a->nlocal < 1 ||
      a->nlocal > MAX_LOCAL || a->nx < 2 * halo || a->ny < 1 || a->nz < 1 ||
      a->xchunk < 1 || a->nsends < 0 || a->push_tiles < 0 ||
      a->shards == nullptr || a->prog.n < 1 || a->prog.n > MAX_TERMS ||
      (spec == SPEC_7PT && !matches<SPEC_7PT>(a->prog)) ||
      (spec == SPEC_27PT && !matches<SPEC_27PT>(a->prog))) {
    return 1000;
  }
  FusedArgs args = *a;
  args.prog.bf16 = compute == 1;
  Launch f;
  f.a = &args;
  f.stream = static_cast<cudaStream_t>(stream);
  return with_instance(halo, spec, dtype, compute, f);
}

}  // extern "C"
