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
//   * stream_generic<T, K, M>: any other chain of 1 to 27 terms (other taps,
//     advection's unequal x pair, a zero centre, HEAT3D_FACTOR_7PT=1,
//     HEAT3D_FACTOR_Y=0), on the same block (Stream: geometry, masks,
//     loader, views). Such a chain may read the planes x-1 and x+1 away
//     from the cell, so every level keeps its planes in a float ring of
//     three slots in shared memory; the host folds each term (src, row, dk)
//     into a source and an offset (stencil_chain.cuh GenericArgs, a kernel
//     argument): a term is one or two shared loads at immediate offsets
//     (four for a row sum of the x-sum, which the term forms from its two
//     planes), __fmul_rn and __fadd_rn for each of the thread's positions,
//     in a loop unrolled to 27 terms with a branch on the term count that
//     is uniform across the launch; M is a template policy. It replaces the
//     first design's interpreted kernels (stream1_generic, streamk_generic:
//     a per-cell walk of the Program over synchronously loaded rings).
//
// Bound: device-memory bytes. A launch reads the width-K padded field once
// and writes the interior once; the K updates cost 13 (7pt) to 33 (27pt,
// factored) flops per cell each, plus the recompute of the shrinking ghost
// rings: at 1024^3 the bytes take 2.57-2.59 ms on an H100 SXM, the raw
// trapezoid's flops 0.2-0.8 ms. The generic instance is bound by the
// latency of its shared loads and barriers (PERF.md section 6, PR 22's
// direct sweep and this one). Design of stream_kernel against the bound:
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
// design took 9.87, 21.06, 35.46 and 58.42. The generic instance forced
// on the 7pt chain (scripts/torch_stream_probe.py --generic, same card):
// K = 1 4.0-4.2 (four blocks an SM), K = 2 8.6-8.7 (four), K = 3 15.1-15.3
// (three), K = 4 26.4-26.6 (two); the first design's kernels of the same
// card 9.97, 21.39, 36.79 and 60.57. Each level's chain costs about 3.5 ms
// a plane at four blocks an SM and more at two; with the input slot (fp32
// at three and two blocks an SM) K = 2 and 3 took 9.3 and 18.2, with 24-row
// frames (four and three blocks) K = 3 and 4 took 17.2 and 28.3, and fp32
// planes landing in level 0's ring right after stage 1 instead of before
// the output stage 21.7 and 48.1 (PERF.md section 6). The compile-time
// instances are still above the bound by 2x (K = 1) to 4.3x (K = 4): a
// deeper prefetch moved little, so barriers and instruction throughput,
// not load latency, are the suspects. bf16 compute (chip_smoke.py
// compute_bf16_times, fp32 storage, the fp32-compute instance of the same
// call in brackets): K = 1 6.91 [4.96], K = 2 11.79 [4.63], K = 3 17.16
// [6.99], K = 4 24.70 [11.10], same registers and blocks per SM.
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
// The generic instance: any emission program, folded at launch.

// The sweep of the generic instance: the chains' block (Stream: geometry,
// masks, loader, views) with every level's planes in shared memory. Level
// L (0 the input, 1..K-1 the intermediates) has a float ring of three
// slots, its plane m in slot m % 3. Step i lands input plane i; stage j =
// 1..K-1 then writes level j's plane i - j (rounded through T and, under
// Dirichlet, pinned to bc beyond the domain faces of `edges`) from level
// j-1's planes i-j-1 .. i-j+1, a barrier after each; stage K writes output
// plane i - K from level K-1's. A plane's slot is rewritten three steps
// later, after the barrier that opens the step, so three slots a level
// suffice: a term that reads the x-sum plane adds its two planes at the
// term (the same operands in the same order as the plain version's cached
// sum), and no level keeps a fourth slot for it. An fp32 plane at K >= 2
// lands by cp.async straight in level 0's ring (DIRECT; rounded there in
// place under bf16 compute): plane i + 1 is started into the slot of plane
// i - 2 (which stage 1 has read) once stages 1..K-1 are done, and lands
// while stage K runs and the next step waits; the sweep keeps no input
// slot and makes no copy, so fp32 holds four blocks an SM at K = 2 and
// three at K = 3 (three and two with the input slot). Started right after
// stage 1 instead, the load slowed each later stage that ends in a
// barrier (K = 3 and 4 ran 1.1x and 1.8x slower). Otherwise (bf16 rows
// come as element pairs at a per-row shift; at K = 1 stage 1 is the
// output) a plane lands in the one input slot, is copied into level 0's
// ring as M reads a T and its slot refilled with the next plane at once.

// The generic instance's fp32 planes land straight in level 0's ring at
// K >= 2 (else in the input slot, copied).
template <class T, int K>
__host__ __device__ constexpr bool lands_direct() {
  return sizeof(T) == 4 && K >= 2;
}

template <class T, int K, class M>
struct StreamSweep : Stream<T, K, SPEC_GENERIC, M> {
  using B = Stream<T, K, SPEC_GENERIC, M>;
  using G = typename B::G;
  static constexpr int MB = B::MB, P = B::P, FW = B::FW;
  static constexpr int PS = B::FH * FW;  // floats of a ring slot
  static constexpr bool DIRECT = lands_direct<T, K>();

  float* rings;  // K rings of three slots

  // Offset of the thread's position p from its first one in a slot.
  __host__ __device__ static constexpr int pos(int p) {
    return SBY * (p / MB) * FW + SBZ * (p % MB);
  }

  // The slot of level L's plane m.
  __device__ __forceinline__ float* slot0(int L, int m) const {
    return rings + (3 * L + m % 3) * PS;
  }

  // The thread's first position in the slot of level L's plane m.
  __device__ __forceinline__ float* slot(int L, int m) const {
    return slot0(L, m) + this->tid_base(FW);
  }
  // Term i of a cell: w v, the first term not added to 0.
  __device__ __forceinline__ static void term(float& acc, int i, float w,
                                              float v) {
    const float m = M::mul(w, v);
    acc = i == 0 ? m : M::add(acc, m);
  }

  // acc: the chain of level L's plane q at the thread's positions.
  __device__ __forceinline__ void eval(int L, int q, const GenericArgs& a,
                                       float (&acc)[P]) const {
    const float* pm = slot(L, q - 1);
    const float* p0 = slot(L, q);
    const float* pp = slot(L, q + 1);
#pragma unroll
    for (int i = 0; i < MAX_TERMS; ++i) {
      if (i < a.n) {  // uniform across the launch
        const int s = a.s[i];
        const float* t = (s == 1 ? p0 : s == 2 ? pp : pm) + a.o[i];
        constexpr int Y = 2 * FW;
        if (s == 3) {  // the x-sum: planes x-1 and x+1
          const float* u = pp + a.o[i];
          if (a.y[i]) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const int o = pos(p);
              term(acc[p], i, a.w[i],
                   M::add(M::add(t[o], u[o]), M::add(t[o + Y], u[o + Y])));
            }
          } else {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              term(acc[p], i, a.w[i], M::add(t[pos(p)], u[pos(p)]));
            }
          }
        } else if (a.y[i]) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            term(acc[p], i, a.w[i], M::add(t[pos(p)], t[pos(p) + Y]));
          }
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) term(acc[p], i, a.w[i], t[pos(p)]);
        }
      }
    }
  }

  // Input plane i from its slot into level 0's ring.
  __device__ __forceinline__ void land(int i) const {
    const auto cur = this->in_view(i);
    float* d = slot(0, i);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      d[pos(p)] = M::template read<T>(cur.at(p / MB, p % MB, 0, 0));
    }
  }

  // Stage j < K: level j's plane q into its ring.
  __device__ __forceinline__ void level(int j, int q,
                                        const GenericArgs& a) const {
    float acc[P];
    eval(j - 1, q, a, acc);
    const int gx = this->xs0 + q - K;  // block index of the plane
    const bool x_out =
        !this->periodic && ((gx < 0 && (this->edges & 1)) ||
                            (gx >= this->nx && (this->edges & 2)));
    float* d = slot(j, q);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool pin = x_out || ((this->rowpin >> (p / MB)) & 1) ||
                       ((this->colpin >> (p % MB)) & 1);
      d[pos(p)] = pin ? this->bc : to_f(from_f<T>(acc[p]));
    }
  }

  // Stage K: output plane q at the thread's positions of the tile.
  __device__ __forceinline__ void emit(int q, const GenericArgs& a) const {
    float acc[P];
    eval(K - 1, q, a, acc);
    const int gx = this->xs0 + q - K;
    const int64_t o0 =
        ((int64_t)gx * this->ny + this->y0 + (int)threadIdx.y - K) * this->nz +
        this->z0 + (int)threadIdx.x - K;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int l = p / MB, m = p % MB;
      if (((this->rowout >> l) & 1) && ((this->colout >> m) & 1)) {
        this->out[o0 + (SBY * l * this->nz + SBZ * m)] = from_f<T>(acc[p]);
      }
    }
  }

  // Start input plane i (if any) into level 0's ring or the input slot.
  __device__ __forceinline__ void fetch(int i, int n_in) {
    if (i < n_in) {
      load_plane<T, K>(DIRECT ? reinterpret_cast<T*>(slot0(0, i))
                              : this->in_slot,
                       this->up, (int64_t)(this->xs0 + i) * this->plane,
                       this->y0, this->z0, this->py, this->pz);
    }
    cp_async_commit();
  }

  // Stages 1..K-1 at step i (those with work: i >= 2 j).
  __device__ __forceinline__ void levels(int i, const GenericArgs& a) {
#pragma unroll 1
    for (int j = 1; j < K && i >= 2 * j; ++j) {  // uniform
      level(j, i - j, a);
      __syncthreads();  // level j's plane i - j out
    }
  }

  // Output planes [xs0, xs0 + xchunk) of the interior.
  __device__ __forceinline__ void run(int xchunk, const GenericArgs& a) {
    const int nc = min(this->nx, this->xs0 + xchunk) - this->xs0;
    const int n_in = nc + 2 * K;
    this->init_masks();
    fetch(0, n_in);
    for (int i = 0; i < n_in; ++i) {
      cp_async_wait<0>();
      // DIRECT under bf16 compute: the thread's own positions, in place
      if constexpr (DIRECT) {
        round_landed<T, M, G>(reinterpret_cast<T*>(slot0(0, i)));
      }
      __syncthreads();  // plane i landed; the slots step i writes are read
      if constexpr (DIRECT) {
        levels(i, a);
        fetch(i + 1, n_in);  // into the slot of plane i - 2, which stage 1 read
      } else {
        land(i);
        // an fp32 thread copies and reads its own positions of the input
        // slot; bf16 pairs are other threads' positions
        if constexpr (sizeof(T) == 4) fetch(i + 1, n_in);
        __syncthreads();  // level 0's plane i out
        if constexpr (sizeof(T) != 4) fetch(i + 1, n_in);
        levels(i, a);
      }
      if (i >= 2 * K) emit(i - K, a);  // uniform
    }
  }
};

// Bytes of shared memory before the generic instance's rings: the input
// slot, or where planes land in level 0's ring a row and a column that
// the positions outside level 0's planes read.
template <class T, int K>
__host__ __device__ constexpr int generic_front() {
  using G = Geom<K>;
  return lands_direct<T, K>()
             ? (G::FW + 4) * (int)sizeof(float)
             : G::FH * in_stride<T, K>() * (int)sizeof(T);
}

// Dynamic shared memory of the generic instance (T, K): the front, the K
// rings, and a row and a column beyond the last ring that the positions
// outside a level's planes read.
template <class T, int K>
__host__ __device__ constexpr int generic_smem() {
  using G = Geom<K>;
  return generic_front<T, K>() +
         (3 * K * G::FH * G::FW + G::FW + 4) * (int)sizeof(float);
}

// Launch bounds: as many blocks an SM as the shared memory holds (an H100
// SM's 228 KB, 1 KB of it reserved for each block), at most four (64
// registers): fp32 four at K = 1 and 2, three (80) at K = 3, two (128) at
// K = 4.
template <class T, int K>
__host__ __device__ constexpr int generic_min_blocks() {
  return 233472 / (generic_smem<T, K>() + 1024) < 4
             ? 233472 / (generic_smem<T, K>() + 1024)
             : 4;
}

template <class T, int K, class M>
__global__ void __launch_bounds__(SNT, (generic_min_blocks<T, K>()))
    stream_generic(const T* __restrict__ up, T* __restrict__ out, int nx,
                   int ny, int nz, int xchunk, int periodic, float bc,
                   int edges, GenericArgs a) {
  using G = Geom<K>;
  using W = StreamSweep<T, K, M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W st;
  st.up = up;
  st.out = out;
  st.in_slot = reinterpret_cast<T*>(smem_raw);
  st.rings = reinterpret_cast<float*>(smem_raw + generic_front<T, K>());
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
  st.run(xchunk, a);
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

template <class T, int K, class M>
struct Generic {
  static constexpr int bytes = generic_smem<T, K>();
  static constexpr int ty = Geom<K>::TY;
  static constexpr int tz = Geom<K>::TZ;
  static dim3 block() { return dim3(SBZ, SBY); }
  static void* fn() { return (void*)stream_generic<T, K, M>; }
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> done{0};
    return set_smem_once(done, stream_generic<T, K, M>, bytes);
  }
  static cudaError_t launch(dim3 grid, const void* up, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, int edges, const Program& prog,
                            cudaStream_t stream) {
    stream_generic<T, K, M><<<grid, block(), bytes, stream>>>(
        static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, edges, fold(prog, Geom<K>::FW));
    return cudaGetLastError();
  }
};

// f.template run<Instance>() for instance (k, spec, dtype, compute); `bad`
// for arguments no instance takes.
template <class T, int K, class M, class F>
int by_spec(int spec, const F& f) {
  switch (spec) {
    case SPEC_7PT:
      return f.template run<Spec<T, K, SPEC_7PT, M>>();
    case SPEC_27PT:
      return f.template run<Spec<T, K, SPEC_27PT, M>>();
    default:
      return f.template run<Generic<T, K, M>>();
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

// k: 1 (one update) or 2..4 (fused updates); spec: 0 generic (any
// program of 1 to 27 terms), 1 the 7pt chain, 2 the 27pt chain (prog's
// (src, row, dk) must be that chain's); dtype: 0 float, 1 bf16 storage;
// compute: 0 float, 1 bf16 (prog's weights already in that dtype). up is
// the (nx+2k, ny+2k, nz+2k) padded field, out the (nx, ny, nz) interior;
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
      (spec == SPEC_27PT && !matches<SPEC_27PT>(*prog)) ||
      (spec == SPEC_GENERIC && !foldable(*prog))) {
    return 1000;
  }
  const Launch f{up, out, nx, ny, nz, xchunk, periodic, bc, edges, prog,
                 static_cast<cudaStream_t>(stream)};
  return with_instance(k, spec, dtype, compute, 1000, f);
}

}  // extern "C"
