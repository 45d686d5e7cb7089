// Exchange-path stencil kernels for Hopper (sm_90a): a ghost-padded field
// in (the halo exchange wrote the ghosts), its interior after one update
// (K = 1) or after K = 2..4 fused updates out.
//
// Replaces heat3d_tpu/ops/stencil_pallas.py:
//   * ::apply_taps_pallas_stream (_stream_kernel) and its dispatcher
//     ::apply_taps_pallas -> K = 1. The dispatcher's windowed
//     _stencil_kernel exists because a TPU plane ring can overflow VMEM; a
//     (y, z)-tiled kernel has no such limit, so one kernel covers both;
//   * ::apply_taps_pallas_streamk (_streamk_kernel) and its two-stage form
//     ::apply_taps_pallas_stream2 (_stream2_kernel) -> K = 2..4.
//
// Two families of instances:
//   * stream_kernel<T, K, S, M>: the tap chain S fixed at compile time. S is
//     one of the two emission programs the solver's stencils give under
//     the default factoring knobs: the plain lexicographic 7pt chain (7
//     terms) and the x- and y-factored 27pt chain (12 terms). Their
//     (src, row, dk) sequences come from the wrapper's table
//     (ops/stencil_stream.py CHAINS), which the build passes to nvcc as
//     HEAT3D_CHAIN_7PT / HEAT3D_CHAIN_27PT; the weights are a kernel
//     argument. The wrapper picks S by comparing emission_program(taps)
//     with that table. M is the arithmetic policy (stencil_common.cuh):
//     F32Math, or Bf16Math for bf16 compute;
//   * stream1_generic / streamk_generic<T, K>: any other chain (other taps,
//     HEAT3D_FACTOR_7PT=1, HEAT3D_FACTOR_Y=0), interpreted per cell from
//     the Program in shared memory (stencil_common.cuh), over 3-slot float
//     rings of framed planes; the compute dtype is Program::bf16.
//
// Bound: device-memory bytes. A launch reads the width-K padded field once
// and writes the interior once; the K updates cost 13 (7pt) to 33 (27pt,
// factored) flops per cell each, plus the recompute of the shrinking ghost
// rings: at 1024^3 the bytes take 2.57-2.59 ms on an H100 SXM, the raw
// trapezoid's flops 0.2-0.8 ms. The generic instances are bound by their
// instruction stream (per cell and term: a Term read from shared memory,
// two branches, index arithmetic). Design of stream_kernel against that:
//   * the chain is unrolled at compile time: a term is one or two shared
//     loads at immediate offsets, __fmul_rn and __fadd_rn. Each x-plane
//     sum (pm + pp) is computed once per cell position and each y-row sum
//     once per term, from the same operands in the same order as the
//     cached sums of the plain version (ops.stencil_eager);
//   * a block of 32 x 8 threads owns a (TY, TZ) tile and marches one
//     x-chunk. Thread (tx, ty) owns the frame positions (ty + 8 l,
//     tx + 32 m): rows of the frame are warps, columns are lanes, so every
//     shared access of a warp is 32 consecutive elements. Its x-neighbours
//     (the previous plane of each level, and the fresh plane of the stage
//     below) live in registers, so of each level only the plane whose y/z
//     neighbours are read sits in shared memory: one slot per stage level
//     (in the storage type: the intermediates are rounded through it), plus
//     for 27pt one float slot of the x-plane sum;
//   * input planes land by cp.async (4 B; bf16 as aligned element pairs,
//     each row shifted by the parity of its first element), two planes
//     ahead into a 4-slot ring (one ahead, 3 slots, where a fourth slot
//     would cost the fourth block of an SM: fp32 K=4 27pt), so the loads
//     of planes i+1 and i+2 are in flight while the stages run on plane
//     i. Each warp loads whole rows; out-of-range cells are zero-filled by
//     the copy itself;
//   * the frame is 64 columns by 32 rows (40 for K = 1) and the tile is
//     the frame less 2K on each axis: for K = 4 a read amplification of
//     1.52 and a trapezoid of 1.19x the updates (16 x 64 tiles: 1.69 and
//     1.25), in 48 KB (7pt) or 56 KB (27pt) of fp32 shared memory, about
//     half in bf16; launch bounds hold the registers to 64, so four blocks
//     of 256 threads fit an SM;
//   * Dirichlet pins are tested per row and per column once per block.
//
// Measured (chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md
// section 6), ms per launch at 1024^3 fp32 7pt against the bytes bound:
// K = 1 5.07 / 2.57, K = 2 4.80 / 2.58, K = 3 7.10 / 2.59, K = 4 11.15 /
// 2.59 (27pt K = 4 22.26; 7pt bf16 K = 4 14.37 / 1.30). The previous
// design, now the generic instance, took 9.87, 21.06, 35.46 and 58.42.
// Still above the bound by 2x (K = 1) to 4.3x (K = 4): a deeper prefetch
// moved little, so barriers and instruction throughput, not load latency,
// are the suspects. bf16 compute (chip_smoke.py compute_bf16_times, fp32
// storage, the fp32-compute instance of the same call in brackets): K = 1
// 6.91 [4.96], K = 2 11.79 [4.63], K = 3 17.16 [6.99], K = 4 24.70
// [11.10], same registers and blocks per SM.
//
// Semantics: before a stage other than the last passes its plane on, the
// plane is rounded through the storage type and, under Dirichlet, every
// cell that lies beyond a DOMAIN face of the shard -- its block index
// (padded index - K) outside [0, n) on an axis whose low or high face the
// shard touches (the 6-bit `edges` mask: x_lo, x_hi, y_lo, y_hi, z_lo,
// z_hi) -- is set to bc (already rounded to the storage type by the
// wrapper): exactly what K separate exchange + update steps see. Ring
// cells across a face shared with a neighbouring shard are genuine
// neighbour values and stay (the JAX kernel pins at domain-edge shards
// only, from axis_index). A whole-domain block has all six bits set. Under
// periodic boundaries nothing is pinned: the exchange wrapped the ghosts,
// so the ring cells are genuine wrapped values. Every instance equals
// ops.stencil_eager (one apply_taps_padded per update) bitwise.
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "stencil_chain.cuh"

namespace {

constexpr int MAX_K = 4;

// Copy padded plane (element offset plane_off) rows y0.., columns z0.. into
// input slot `slot` ((FH, in_stride) elements of T). Warp ty copies rows
// ty + 8 l. Cells past the padded extent (ragged edge tiles) are
// zero-filled: they feed no cell that is written out. A bf16 row is copied
// as 4-byte element pairs from the pair holding its first element, so
// frame column c sits at row index c + (parity of the row's first element).
template <class T, int K>
__device__ __forceinline__ void load_plane(T* slot, const T* __restrict__ up,
                                           int64_t plane_off, int y0, int z0,
                                           int py, int pz) {
  using G = Geom<K>;
  constexpr int SW = in_stride<T, K>();
  const int tx = threadIdx.x;
  const int nz_valid = min(G::FW, pz - z0);
#pragma unroll
  for (int l = 0; l < G::LA; ++l) {
    const int a = threadIdx.y + SBY * l;
    const bool row_ok = y0 + a < py;
    const int64_t g0 = plane_off + (int64_t)(y0 + a) * pz + z0;
    T* dst = slot + a * SW;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int m = 0; m < G::MB; ++m) {
        const int c = tx + SBZ * m;
        const bool ok = row_ok && c < nz_valid;
        cp_async4(dst + c, ok ? up + g0 + c : up, ok ? 4 : 0);
      }
    } else {
      const int s = (int)(g0 & 1);
      const T* src = up + (g0 - s);
#pragma unroll
      for (int m = 0; m < G::MB / 2 + 1; ++m) {
        const int w = tx + SBZ * m;
        const int c = 2 * w - s;  // frame column of the pair's first element
        if (w <= G::FW / 2) {
          const int bytes =
              !row_ok ? 0 : c + 1 < nz_valid ? 4 : c < nz_valid ? 2 : 0;
          cp_async4(dst + 2 * w, bytes ? src + 2 * w : up, bytes);
        }
      }
    }
  }
}

// The state of one block of stream_kernel<T, K, S, M>.
template <class T, int K, int S, class M>
struct Stream {
  using G = Geom<K>;
  static constexpr int LA = G::LA, MB = G::MB, P = G::P;
  static constexpr int FH = G::FH, FW = G::FW, SWI = in_stride<T, K>();
  static constexpr bool XS = uses_xsum<S>();
  static constexpr bool SHIFT = sizeof(T) == 2;
  static constexpr int NS = in_slots<T, K, S>();  // input slots
  static constexpr int D = NS - 2;                // planes loaded ahead
  using InView = View<T, SWI, SHIFT>;
  using LvView = View<T, FW, false>;
  using XsView = View<float, FW, false>;

  const T* __restrict__ up;
  T* __restrict__ out;
  T* in_slot;   // NS input slots
  T* lvl;       // K-1 level slots, level L at (L-1) * FH * FW
  float* xsp;   // the x-sum slot (27pt)
  int nx, ny, nz, xs0, y0, z0, py, pz;
  int64_t plane;
  int periodic, edges;
  float bc;            // the pin value as M reads a T
  int rowpin, colpin;  // Dirichlet pins of the thread's rows / columns
  int rowout, colout;  // the thread's rows / columns inside the interior
  float g[K][P];       // level L's plane before the one in its slot
  float v[2][P];       // a stage's fresh plane until it reaches its slot

  __device__ __forceinline__ int tid_base(int sw) const {
    return threadIdx.y * sw + threadIdx.x;
  }

  // Input slot of chunk-relative plane q as this thread reads it.
  __device__ __forceinline__ InView in_view(int q) const {
    const T* base = in_slot + (q % NS) * FH * SWI + tid_base(SWI);
    if constexpr (SHIFT) {
      // parity of the first element of frame row a of plane xs0 + q
      const int podd = py & pz & 1;
      const int bp = ((xs0 + q) & podd) ^ (y0 & pz & 1) ^ (z0 & 1);
      const int s_mid = bp ^ (threadIdx.y & pz & 1);
      const int s_nb = bp ^ ((threadIdx.y + 1) & pz & 1);
      return InView{base + s_mid, s_nb - s_mid};
    } else {
      return InView{base, 0};
    }
  }

  __device__ __forceinline__ LvView lv_view(int L) const {
    return LvView{lvl + (L - 1) * FH * FW + tid_base(FW), 0};
  }

  __device__ __forceinline__ XsView xs_view() const {
    return XsView{xsp + tid_base(FW), 0};
  }

  // Frame membership of the thread's row l / column m at stage J: the
  // stage-J planes span frame rows [J, FH - J) and columns [J, FW - J).
  __device__ __forceinline__ bool row_in(int l, int J) const {
    const int a = threadIdx.y + SBY * l;
    return a >= J && a < FH - J;
  }
  __device__ __forceinline__ bool col_in(int m, int J) const {
    const int b = threadIdx.x + SBZ * m;
    return b >= J && b < FW - J;
  }

  __device__ __forceinline__ void init_masks() {
    rowpin = colpin = rowout = colout = 0;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int gy = y0 + threadIdx.y + SBY * l - K;  // block index
      if (!periodic && ((gy < 0 && (edges & 4)) || (gy >= ny && (edges & 8)))) {
        rowpin |= 1 << l;
      }
      if (row_in(l, K) && gy < ny) rowout |= 1 << l;
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int gz = z0 + threadIdx.x + SBZ * m - K;
      if (!periodic &&
          ((gz < 0 && (edges & 16)) || (gz >= nz && (edges & 32)))) {
        colpin |= 1 << m;
      }
      if (col_in(m, K) && gz < nz) colout |= 1 << m;
    }
  }

  // Stage J at step i: level L = J-1's plane q = i - J (the slot, or the
  // input slot for L = 0) with its neighbours q-1 (g[L]) and q+1 (v, or
  // the input slot), once the stage has work (i >= 2J). Then level L's
  // fresh plane of this step (if any) replaces its slot's.
  template <int J>
  __device__ __forceinline__ void stage(int i, const Weights& w) {
    constexpr int L = J - 1;
    const bool active = i >= 2 * J;  // uniform across the block
    if (active) {
      if constexpr (XS) {
        if constexpr (J == 2) __syncthreads();  // stage 1 has read xsp
        // x-plane sum of level L over its frame
        const InView cur = in_view(i);
#pragma unroll
        for (int l = 0; l < LA; ++l) {
          if (!row_in(l, L)) continue;
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (!col_in(m, L)) continue;
            const int p = l * MB + m;
            const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
            xsp[tid_base(FW) + SBY * l * FW + SBZ * m] = M::add(g[L][p], pp);
          }
        }
        __syncthreads();
      }
      const int q = i - J;
      if constexpr (L == 0) {
        compute<J>(q, in_view(i - 1), in_view(i), w);
      } else {
        compute<J>(q, lv_view(L), in_view(i), w);
      }
    }
    if constexpr (L == 0) {
      if (i >= 1) {
        const InView prev = in_view(i - 1);
#pragma unroll
        for (int l = 0; l < LA; ++l) {
#pragma unroll
          for (int m = 0; m < MB; ++m) g[0][l * MB + m] = prev.at(l, m, 0, 0);
        }
      }
    } else {
      if (i >= 2 * L) {
        __syncthreads();  // stage J has read level L's slot (and xsp)
        T* s = lvl + (L - 1) * FH * FW + tid_base(FW);
#pragma unroll
        for (int l = 0; l < LA; ++l) {
          if (!row_in(l, L)) continue;
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (!col_in(m, L)) continue;
            const int p = l * MB + m;
            const int o = SBY * l * FW + SBZ * m;
            g[L][p] = to_f(s[o]);
            s[o] = from_f<T>(v[L & 1][p]);
          }
        }
      }
    }
  }

  template <int J, class V0>
  __device__ __forceinline__ void compute(int q, const V0& p0,
                                          const InView& cur,
                                          const Weights& w) {
    constexpr int L = J - 1;
    const XsView xs = xs_view();
    const int gx = xs0 + q - K;  // block index of the plane
    const bool x_out = !periodic && ((gx < 0 && (edges & 1)) ||
                                     (gx >= nx && (edges & 2)));
    // index of output cell (ty, tx) of the frame (last stage only)
    const int64_t o0 = ((int64_t)gx * ny + y0 + (int)threadIdx.y - K) * nz +
                       z0 + (int)threadIdx.x - K;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (J < K ? !row_in(l, J) : !((rowout >> l) & 1)) continue;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (J < K ? !col_in(m, J) : !((colout >> m) & 1)) continue;
        const int p = l * MB + m;
        const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
        const Cell<V0, XsView> c{g[L][p], pp, p0, xs, l, m};
        const float r = chain<S, M>(w, c);
        if constexpr (J < K) {
          const bool pin =
              x_out || ((rowpin >> l) & 1) || ((colpin >> m) & 1);
          v[J & 1][p] = pin ? bc : to_f(from_f<T>(r));
        } else {
          out[o0 + (SBY * l * nz + SBZ * m)] = from_f<T>(r);
        }
      }
    }
  }

  template <int... J>
  __device__ __forceinline__ void stages(int i, const Weights& w,
                                         std::integer_sequence<int, J...>) {
    (stage<J + 1>(i, w), ...);
  }

  __device__ __forceinline__ void run(int xchunk, const Weights& w) {
    const int nc = min(nx, xs0 + xchunk) - xs0;
    const int n_in = nc + 2 * K;
    init_masks();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d < n_in) {
        load_plane<T, K>(in_slot + d * FH * SWI, up,
                         (int64_t)(xs0 + d) * plane, y0, z0, py, pz);
      }
      cp_async_commit();
    }
    for (int i = 0; i < n_in; ++i) {
      cp_async_wait<D - 1>();
      round_landed<T, M, G>(in_slot + (i % NS) * FH * SWI);
      __syncthreads();  // plane i landed; the slot of plane i+D is free
      if (i + D < n_in) {
        load_plane<T, K>(in_slot + ((i + D) % NS) * FH * SWI, up,
                         (int64_t)(xs0 + i + D) * plane, y0, z0, py, pz);
      }
      cp_async_commit();  // one group a step, empty at the end
      stages(i, w, std::make_integer_sequence<int, K>{});
    }
  }
};

template <class T, int K, int S, class M>
__global__ void __launch_bounds__(SNT, MIN_BLOCKS)
    stream_kernel(const T* __restrict__ up, T* __restrict__ out, int nx,
                  int ny, int nz, int xchunk, int periodic, float bc,
                  int edges, Weights w) {
  static_assert(centre_x_only<S>(),
                "chain reads x-1/x+1 planes off the cell: generic instance");
  using G = Geom<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stream<T, K, S, M> st;
  st.up = up;
  st.out = out;
  st.in_slot = reinterpret_cast<T*>(smem_raw);
  st.lvl = st.in_slot + in_slots<T, K, S>() * G::FH * in_stride<T, K>();
  st.xsp = reinterpret_cast<float*>(st.lvl + (K - 1) * G::FH * G::FW);
  st.nx = nx;
  st.ny = ny;
  st.nz = nz;
  st.xs0 = blockIdx.z * xchunk;
  st.y0 = blockIdx.y * G::TY;
  st.z0 = blockIdx.x * G::TZ;
  st.py = ny + 2 * K;
  st.pz = nz + 2 * K;
  st.plane = (int64_t)st.py * st.pz;
  st.periodic = periodic;
  st.edges = edges;
  st.bc = M::template read<T>(bc);
  st.run(xchunk, w);
}

// ---------------------------------------------------------------------------
// Generic instances: the interpreted emission program (stencil_common.cuh)
// over 3-slot float rings, (TY, TZ) tiles of stencil_common.cuh.

// Floats of one plane framed by r cells.
__host__ __device__ constexpr int plane_floats(int r) {
  return (TY + 2 * r) * (TZ + 2 * r);
}

// Floats of shared memory before the ring of frame r, the rings laid out
// as r = K (the input), K-1, ..., 1; ring_offset(K, 0) is their total.
__host__ __device__ constexpr int ring_offset(int K, int r) {
  return r >= K ? 0 : 3 * plane_floats(r + 1) + ring_offset(K, r + 1);
}

// Load padded plane p, rows y0.. and columns z0.. of it, into an (FY, FZ)
// float slot. Cells past the padded extent (ragged edge tiles) read 0:
// they feed no cell that is written out.
template <class T, int FY, int FZ>
__device__ void load_padded(float* dst, const T* __restrict__ up, int p,
                            int y0, int z0, int pny, int pnz) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const T* plane = up + (int64_t)p * pny * pnz;
  for (int idx = tid; idx < FY * FZ; idx += NTHREADS) {
    const int a = idx / FZ;
    const int b = idx - a * FZ;
    const int gy = y0 + a;
    const int gz = z0 + b;
    dst[idx] = (gy < pny && gz < pnz) ? to_f(plane[(int64_t)gy * pnz + gz])
                                      : 0.0f;
  }
}

template <class T>
__global__ void __launch_bounds__(NTHREADS)
    stream1_generic(const T* __restrict__ up, T* __restrict__ out, int nx,
                    int ny, int nz, int xchunk, Program prog) {
  constexpr int FZ = TZ + 2;
  constexpr int PS = (TY + 2) * FZ;
  __shared__ float ring[3 * PS];
  __shared__ Program sp;
  copy_program(&sp, prog);
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int xs = blockIdx.z * xchunk;
  const int xe = min(nx, xs + xchunk);
  // padded planes xs .. xe+1: slot i%3 holds plane xs+i; output plane
  // xs+i-2 is emitted from padded planes xs+i-2 .. xs+i
  for (int i = 0; i < xe - xs + 2; ++i) {
    load_padded<T, TY + 2, FZ>(ring + (i % 3) * PS, up, xs + i, y0, z0,
                               ny + 2, nz + 2);
    __syncthreads();
    if (i >= 2) {
      const float* pm = ring + ((i - 2) % 3) * PS;
      const float* p0 = ring + ((i - 1) % 3) * PS;
      const float* pp = ring + (i % 3) * PS;
      const int64_t ox = xs + i - 2;
      for (int ty = threadIdx.y; ty < TY; ty += BY) {
        const int gy = y0 + ty;
        const int gz = z0 + threadIdx.x;
        if (gy < ny && gz < nz) {
          const float r =
              apply_program(sp, pm, p0, pp, ty + 1, threadIdx.x + 1, FZ);
          out[(ox * ny + gy) * nz + gz] = from_f<T>(r);
        }
      }
    }
    __syncthreads();
  }
}

template <class T, int K>
__global__ void __launch_bounds__(NTHREADS)
    streamk_generic(const T* __restrict__ up, T* __restrict__ out, int nx,
                    int ny, int nz, int xchunk, int periodic, float bc,
                    int edges, Program prog) {
  extern __shared__ float smem[];
  __shared__ Program sp;
  copy_program(&sp, prog);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int xs = blockIdx.z * xchunk;
  const int nc = min(nx, xs + xchunk) - xs;
  // Chunk-relative padded x: q = 0 is padded plane xs (global x xs-K).
  // Step i loads input plane q = i into slot i%3 of the input ring; stage
  // j then emits its plane q = i-j into slot q%3 of its ring from stage
  // j-1's planes q-1, q, q+1, once those exist (i >= 2j). Stage K's plane
  // q is output plane xs+q-K.
  for (int i = 0; i < nc + 2 * K; ++i) {
    load_padded<T, TY + 2 * K, TZ + 2 * K>(smem + (i % 3) * plane_floats(K),
                                           up, xs + i, y0, z0, ny + 2 * K,
                                           nz + 2 * K);
    __syncthreads();
#pragma unroll
    for (int j = 1; j <= K; ++j) {
      if (i < 2 * j) break;  // uniform across the block
      const int r = K - j;   // frame of stage j's planes
      const int q = i - j;
      const float* src = smem + ring_offset(K, r + 1);
      const int sps = plane_floats(r + 1);
      const float* pm = src + ((q - 1) % 3) * sps;
      const float* p0 = src + (q % 3) * sps;
      const float* pp = src + ((q + 1) % 3) * sps;
      const int sfz = TZ + 2 * (r + 1);
      if (j < K) {
        const int fz = TZ + 2 * r;
        const int cells = (TY + 2 * r) * fz;
        float* dst = smem + ring_offset(K, r) + (q % 3) * plane_floats(r);
        const int gx = xs + q - K;
        const bool x_out = (gx < 0 && (edges & 1)) || (gx >= nx && (edges & 2));
        for (int idx = tid; idx < cells; idx += NTHREADS) {
          const int a = idx / fz;
          const int b = idx - a * fz;
          const int gy = y0 - r + a;
          const int gz = z0 - r + b;
          float v;
          if (!periodic &&
              (x_out || (gy < 0 && (edges & 4)) || (gy >= ny && (edges & 8)) ||
               (gz < 0 && (edges & 16)) || (gz >= nz && (edges & 32)))) {
            v = bc;
          } else {
            v = to_f(from_f<T>(
                apply_program(sp, pm, p0, pp, a + 1, b + 1, sfz)));
          }
          dst[idx] = v;
        }
      } else {
        const int64_t ox = xs + q - K;
        for (int ty = threadIdx.y; ty < TY; ty += BY) {
          const int gy = y0 + ty;
          const int gz = z0 + threadIdx.x;
          if (gy < ny && gz < nz) {
            const float v =
                apply_program(sp, pm, p0, pp, ty + 1, threadIdx.x + 1, sfz);
            out[(ox * ny + gy) * nz + gz] = from_f<T>(v);
          }
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// One instance: its kernel, dynamic shared memory, tile and launch.
template <class T, int K, int S, class M>
struct Spec {
  static constexpr int bytes = smem_bytes<T, K, S>();
  static constexpr int ty = Geom<K>::TY;
  static constexpr int tz = Geom<K>::TZ;
  static dim3 block() { return dim3(SBZ, SBY); }
  static void* fn() { return (void*)stream_kernel<T, K, S, M>; }
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> done{0};
    return set_smem_once(done, stream_kernel<T, K, S, M>, bytes);
  }
  static cudaError_t launch(dim3 grid, const void* up, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, int edges, const Program& prog,
                            cudaStream_t stream) {
    Weights w;
    for (int i = 0; i < MAX_TERMS; ++i) w.w[i] = i < prog.n ? prog.t[i].w : 0.f;
    stream_kernel<T, K, S, M><<<grid, block(), bytes, stream>>>(
        static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, edges, w);
    return cudaGetLastError();
  }
};

template <class T, int K>
struct Generic {
  static constexpr int bytes = K == 1 ? 0 : ring_offset(K, 0) * (int)sizeof(float);
  static constexpr int ty = TY;
  static constexpr int tz = TZ;
  static dim3 block() { return dim3(BZ, BY); }
  static void* fn() {
    if constexpr (K == 1) {
      return (void*)stream1_generic<T>;
    } else {
      return (void*)streamk_generic<T, K>;
    }
  }
  static cudaError_t prepare() {
    if constexpr (K == 1) {
      return cudaSuccess;
    } else {
      static std::atomic<unsigned long long> done{0};
      return set_smem_once(done, streamk_generic<T, K>, bytes);
    }
  }
  static cudaError_t launch(dim3 grid, const void* up, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, int edges, const Program& prog,
                            cudaStream_t stream) {
    if constexpr (K == 1) {
      stream1_generic<T><<<grid, block(), 0, stream>>>(
          static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz,
          xchunk, prog);
    } else {
      streamk_generic<T, K><<<grid, block(), bytes, stream>>>(
          static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz,
          xchunk, periodic, bc, edges, prog);
    }
    return cudaGetLastError();
  }
};

// f.template run<Instance>() for instance (k, spec, dtype, compute); `bad`
// for arguments no instance takes. The generic instances serve both
// compute dtypes (Program::bf16).
template <class T, int K, class M, class F>
int by_spec(int spec, const F& f) {
  switch (spec) {
    case SPEC_7PT:
      return f.template run<Spec<T, K, SPEC_7PT, M>>();
    case SPEC_27PT:
      return f.template run<Spec<T, K, SPEC_27PT, M>>();
    default:
      return f.template run<Generic<T, K>>();
  }
}

template <class T, class M, class F>
int by_k(int k, int spec, const F& f) {
  switch (k) {
    case 1:
      return by_spec<T, 1, M>(spec, f);
    case 2:
      return by_spec<T, 2, M>(spec, f);
    case 3:
      return by_spec<T, 3, M>(spec, f);
    default:
      return by_spec<T, 4, M>(spec, f);
  }
}

template <class F>
int with_instance(int k, int spec, int dtype, int compute, int bad,
                  const F& f) {
  if ((dtype != 0 && dtype != 1) || (compute != 0 && compute != 1) ||
      spec < SPEC_GENERIC || spec > SPEC_27PT || k < 1 || k > MAX_K) {
    return bad;
  }
  if (dtype == 0) {
    return compute == 0 ? by_k<float, F32Math>(k, spec, f)
                        : by_k<float, Bf16Math>(k, spec, f);
  }
  return compute == 0 ? by_k<__nv_bfloat16, F32Math>(k, spec, f)
                      : by_k<__nv_bfloat16, Bf16Math>(k, spec, f);
}

struct TileY {
  template <class I>
  int run() const { return I::ty; }
};
struct TileZ {
  template <class I>
  int run() const { return I::tz; }
};
struct SmemBytes {
  template <class I>
  int run() const { return I::bytes; }
};
struct BlocksPerSm {
  template <class I>
  int run() const {
    if (I::prepare() != cudaSuccess) return -1;
    const dim3 b = I::block();
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, I::fn(), (int)(b.x * b.y), I::bytes) != cudaSuccess) {
      return -1;
    }
    return n;
  }
};
struct Registers {
  template <class I>
  int run() const {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, I::fn()) == cudaSuccess ? a.numRegs : -1;
  }
};
struct Launch {
  const void* up;
  void* out;
  int nx, ny, nz, xchunk, periodic;
  float bc;
  int edges;
  const Program* prog;
  cudaStream_t stream;
  template <class I>
  int run() const {
    const cudaError_t err = I::prepare();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nz + I::tz - 1) / I::tz, (ny + I::ty - 1) / I::ty,
                    (nx + xchunk - 1) / xchunk);
    return (int)I::launch(grid, up, out, nx, ny, nz, xchunk, periodic, bc,
                          edges, *prog, stream);
  }
};

}  // namespace

extern "C" {

// Tile extents of instance (k, spec) (spec 0 generic, 1 the 7pt chain, 2
// the 27pt chain), so the wrapper sizes its x-chunks from the same
// numbers; -1 if there is no such instance.
int heat3d_stream_tile_y(int k, int spec) {
  return with_instance(k, spec, 0, 0, -1, TileY{});
}
int heat3d_stream_tile_z(int k, int spec) {
  return with_instance(k, spec, 0, 0, -1, TileZ{});
}

// Dynamic shared memory of one block of instance (k, spec, dtype,
// compute), bytes.
int heat3d_stream_smem_bytes(int k, int spec, int dtype, int compute) {
  return with_instance(k, spec, dtype, compute, -1, SmemBytes{});
}

// Resident blocks per SM of instance (k, spec, dtype, compute) on the
// current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on
// error.
int heat3d_stream_blocks_per_sm(int k, int spec, int dtype, int compute) {
  return with_instance(k, spec, dtype, compute, -1, BlocksPerSm{});
}

// Registers a thread of instance (k, spec, dtype, compute) uses
// (cudaFuncGetAttributes); -1 on error.
int heat3d_stream_registers(int k, int spec, int dtype, int compute) {
  return with_instance(k, spec, dtype, compute, -1, Registers{});
}

// k: 1 (one update) or 2..4 (fused updates); spec: 0 generic, 1 the 7pt
// chain, 2 the 27pt chain (prog's (src, row, dk) must be that chain's);
// dtype: 0 float, 1 bf16 storage; compute: 0 float, 1 bf16 (prog's
// weights already in that dtype; prog->bf16 is set from it). up is the
// (nx+2k, ny+2k, nz+2k) padded field, out the (nx, ny, nz) interior;
// periodic, bc and the domain-face mask edges (bit 0 x_lo .. bit 5 z_hi;
// 63 for a whole-domain block) are read for k >= 2 only. Returns a
// cudaError_t (0 on success); 1000 for bad arguments.
int heat3d_stream_launch(int k, int spec, int dtype, int compute,
                         const void* up, void* out, int nx, int ny, int nz,
                         int xchunk, int periodic, float bc, int edges,
                         const Program* prog, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || xchunk < 1 || prog == nullptr ||
      prog->n < 1 || prog->n > MAX_TERMS ||
      (spec == SPEC_7PT && !matches<SPEC_7PT>(*prog)) ||
      (spec == SPEC_27PT && !matches<SPEC_27PT>(*prog))) {
    return 1000;
  }
  Program p = *prog;
  p.bf16 = compute == 1;
  const Launch f{up, out, nx, ny, nz, xchunk, periodic, bc, edges, &p,
                 static_cast<cudaStream_t>(stream)};
  return with_instance(k, spec, dtype, compute, 1000, f);
}

}  // extern "C"
