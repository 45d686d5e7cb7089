// The sweep of the port's direct-stencil kernels (stencil_direct.cu) and of
// the compile-time instances of the fused kernels (stencil_fused.cu): H
// updates of the output planes [xs0, xe) of one (y, z) tile, with the y/z
// ghosts built by the loader as a domain boundary (Dirichlet bc or periodic
// wrap) and the input planes taken from a plane source Src:
//   * FieldPlanes (direct, and the fused kernels' interior tiles): the
//     unpadded field's plane, wrapped under periodic boundaries, or bc
//     beyond a Dirichlet x domain face;
//   * ShardPlanes<T, H> (the fused kernels' skin tiles): a shard's own
//     plane, one of the H planes on each side that another block or GPU
//     landed in a buffer during the launch (loaded through L2, not L1), or
//     bc at a Dirichlet x domain face.
// A source answers at(gx) (the plane's base, null for a bc plane),
// is_bc(gx) (at(gx) is null: at H = 2 the level-1 plane there is pinned to
// bc), landed(gx) and parity(gx) (bf16: the parity of the plane's first
// element, every buffer being 4-byte aligned), and says with kLands whether
// it can land planes at all (FieldPlanes cannot: the landed path compiles
// away). The sweep asks the source nothing else, so the depth of the
// landed region is the source's own. The arithmetic is the policy M's
// (stencil_common.cuh: F32Math or Bf16Math); under bf16 compute the input
// slots' float field values are rounded as they are read, and bc (ghosts
// and the level-1 pins) is read as M reads a T (the kernels set it so). The
// design is described at the head of stencil_direct.cu.

#pragma once

#include "stencil_chain.cuh"

namespace {

__host__ __device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// A load through L2 only (ld.global.cg): data another SM or GPU may have
// written during the launch.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// The planes of the unpadded (nx, ny, nz) field u.
template <class T>
struct FieldPlanes {
  static constexpr bool kLands = false;
  const T* u;
  int64_t plane;  // ny * nz
  int nx;
  int periodic;
  __device__ __forceinline__ int x_of(int gx) const {
    return periodic ? wrap(gx, nx) : gx;
  }
  __device__ __forceinline__ const T* at(int gx) const {
    return is_bc(gx) ? nullptr : u + x_of(gx) * plane;
  }
  __device__ __forceinline__ bool is_bc(int gx) const {
    return !periodic && (gx < 0 || gx >= nx);
  }
  __device__ __forceinline__ bool landed(int) const { return false; }
  __device__ __forceinline__ int parity(int gx) const {
    return (int)(x_of(gx) & plane & 1);
  }
};

// The state of one block of the sweep: H updates of the output planes
// [xs0, xe) of the (y0, z0) tile under the arithmetic policy M, the input
// planes from the source Src.
template <class T, int H, int S, class M, class Src>
struct Direct {
  using G = Geom<H>;
  static constexpr int LA = G::LA, MB = G::MB, P = G::P;
  static constexpr int FH = G::FH, FW = G::FW, SWI = in_stride<T, H>();
  static constexpr bool XS = uses_xsum<S>();
  static constexpr bool MEHR = S == SPEC_MEHR;
  static constexpr bool SHIFT = sizeof(T) == 2;
  static constexpr int NS = in_slots<T, H, S>();  // input slots
  static constexpr int D = NS - 2;                // planes loaded ahead
  static constexpr int NP = MB / 2 + 1;           // bf16 pairs a thread copies
  using InView = View<T, SWI, SHIFT, M>;
  using LvView = View<T, FW, false>;
  using XsView = View<float, FW, false>;

  Src src;
  T* __restrict__ out;
  T* in_slot;   // NS input slots
  T* lvl;       // the level-1 slot (H = 2)
  float* xsp;   // the x-sum slot (27pt); Mehrstellen: the z131 slot of
                // each level, then at H = 2 level 1's two q planes
  int ny, nz, xs0, y0, z0;
  int periodic;
  float bc;            // the Dirichlet value as M reads a T
  int rowin, colin;    // the thread's frame rows / columns inside the domain
  int pairin;          // bf16: pair j of shift s inside the domain, bit j+NP*s
  int zfull;           // every column the block copies lies inside [0, nz)
  int rowout, colout;  // the thread's rows / columns of the output tile
  float g[H][P];       // level L's plane before the one in its slot
  float v[2][P];       // a stage's fresh plane until it reaches its slot
  // Mehrstellen: the q planes of level 0's planes q-1 (qm) and q (q0)
  float qm[MEHR ? P : 1], q0[MEHR ? P : 1];

  __device__ __forceinline__ int tid_base(int sw) const {
    return threadIdx.y * sw + threadIdx.x;
  }

  // The x of chunk-relative input plane q.
  __device__ __forceinline__ int plane_x(int q) const { return xs0 + q - H; }

  // bf16: the parity of frame row 0's first element in source plane x
  // (any parity for a bc plane), as if the frame's rows were the plane's
  // rows y0 - H ..: row a sits shifted by parity0(x) ^ (a & nz & 1) in its
  // slot row.
  __device__ __forceinline__ int parity0(int x) const {
    return src.parity(x) ^ ((y0 - H) & nz & 1) ^ ((z0 - H) & 1);
  }

  __device__ __forceinline__ InView in_view(int q) const {
    const T* base = in_slot + (q % NS) * FH * SWI + tid_base(SWI);
    if constexpr (SHIFT) {
      const int bp = parity0(plane_x(q));
      const int s_mid = bp ^ (threadIdx.y & nz & 1);
      const int s_nb = bp ^ ((threadIdx.y + 1) & nz & 1);
      return InView{base + s_mid, s_nb - s_mid};
    } else {
      return InView{base, 0};
    }
  }

  __device__ __forceinline__ LvView lv_view() const {
    return LvView{lvl + tid_base(FW), 0};
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
    rowin = colin = pairin = rowout = colout = 0;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int gy = y0 + threadIdx.y + SBY * l - H;
      if (gy >= 0 && gy < ny) rowin |= 1 << l;
      if (row_in(l, H) && gy < ny) rowout |= 1 << l;
    }
    const int zb = z0 - H;  // global z of frame column 0
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int gz = zb + threadIdx.x + SBZ * m;
      if (gz >= 0 && gz < nz) colin |= 1 << m;
      if (col_in(m, H) && gz < nz) colout |= 1 << m;
    }
    if constexpr (SHIFT) {
      // pair j holds frame columns 2 w - s and 2 w - s + 1
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int gz = zb + 2 * (threadIdx.x + SBZ * j) - s;
          if (gz >= 0 && gz + 1 < nz) pairin |= 1 << (j + NP * s);
        }
      }
      zfull = zb >= 1 && zb + FW + 1 <= nz;
    } else {
      zfull = zb >= 0 && zb + FW <= nz;
    }
  }

  // The thread's part of slot row `dst` set to bc (every slot column).
  __device__ __forceinline__ void fill_row(T* dst, T b) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int m = 0; m < MB; ++m) dst[threadIdx.x + SBZ * m] = b;
    } else {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int w = threadIdx.x + SBZ * j;
        if (w <= FW / 2) {
          dst[2 * w] = b;
          dst[2 * w + 1] = b;
        }
      }
    }
  }

  // Source value of global column gz of the source row at `row`: the field,
  // the wrap, or bc; a landed row is read bypassing L1.
  __device__ __forceinline__ T ghost_z(const T* row, int gz, T b,
                                       bool landed) const {
    if (gz >= 0 && gz < nz) return landed ? load_cg(row + gz) : row[gz];
    if (!periodic) return b;
    const T* p = row + wrap(gz, nz);
    return landed ? load_cg(p) : *p;
  }

  // Start the copies of input plane q into its slot; the ghost cells are
  // stored by the threads themselves. A landed plane (written during the
  // launch by another block or GPU) is loaded synchronously through L2.
  __device__ __forceinline__ void load_plane(int q) {
    T* slot = in_slot + (q % NS) * FH * SWI;
    const T b = from_f<T>(bc);
    const int gx = plane_x(q);
    const T* plane = src.at(gx);
    if (plane == nullptr) {  // a bc plane: uniform across the block
#pragma unroll
      for (int l = 0; l < LA; ++l) {
        fill_row(slot + (threadIdx.y + SBY * l) * SWI, b);
      }
      return;
    }
    const bool landed = Src::kLands && src.landed(gx);
    const int zb = z0 - H;
    const int bp = SHIFT ? parity0(gx) : 0;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int a = threadIdx.y + SBY * l;
      T* dst = slot + a * SWI;
      const bool in = (rowin >> l) & 1;
      if (!in && !periodic) {
        fill_row(dst, b);
        continue;
      }
      const int gy = y0 - H + a;
      const T* row = plane + (int64_t)(in ? gy : wrap(gy, ny)) * nz;
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const int c = threadIdx.x + SBZ * m;
          if (zfull || ((colin >> m) & 1)) {
            if (landed) {
              dst[c] = load_cg(row + zb + c);
            } else {
              cp_async4(dst + c, row + zb + c, 4);
            }
          } else {
            dst[c] = ghost_z(row, zb + c, b, landed);
          }
        }
      } else {
        // frame column c at slot column c + s; a pair copies as one word
        // when its source pair is aligned the same way
        const int s = bp ^ (a & nz & 1);
        const bool aligned =
            (((reinterpret_cast<uintptr_t>(row) >> 1) + zb - s) & 1) == 0;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int w = threadIdx.x + SBZ * j;
          if (w > FW / 2) continue;
          const int gz = zb + 2 * w - s;
          if (aligned && (zfull || ((pairin >> (j + NP * s)) & 1))) {
            if (landed) {
              *reinterpret_cast<unsigned int*>(dst + 2 * w) =
                  __ldcg(reinterpret_cast<const unsigned int*>(row + gz));
            } else {
              cp_async4(dst + 2 * w, row + gz, 4);
            }
          } else {
            dst[2 * w] = ghost_z(row, gz, b, landed);
            dst[2 * w + 1] = ghost_z(row, gz + 1, b, landed);
          }
        }
      }
    }
  }

  // Stage J at step i: level L = J-1's plane q = i - J (its slot, or the
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
        compute<J>(q, lv_view(), in_view(i), w);
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
        T* s = lvl + tid_base(FW);
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
    const int gx = plane_x(q);  // x of the plane the stage emits
    const bool x_out = src.is_bc(gx);
    // index of output cell (ty, tx) of the frame (last stage only)
    const int64_t o0 = ((int64_t)gx * ny + y0 + (int)threadIdx.y - H) * nz +
                       z0 + (int)threadIdx.x - H;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (J < H ? !row_in(l, J) : !((rowout >> l) & 1)) continue;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (J < H ? !col_in(m, J) : !((colout >> m) & 1)) continue;
        const int p = l * MB + m;
        const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
        const Cell<V0, XsView> c{g[L][p], pp, p0, xs, l, m};
        const float r = chain<S, M>(w, c);
        if constexpr (J < H) {
          const bool pin = !periodic && (x_out || !((rowin >> l) & 1) ||
                                         !((colin >> m) & 1));
          v[J & 1][p] = pin ? bc : to_f(from_f<T>(r));
        } else {
          out[o0 + (SBY * l * nz + SBZ * m)] = from_f<T>(r);
        }
      }
    }
  }

  // --- The Mehrstellen q-ring route (S == SPEC_MEHR), the JAX kernels'
  // _plane_q / _plane_mehrstellen: out = (a u0 + b S) + d psum, with
  // S = (q[x-1] + q[x+1]) + 3 q[x] over the q planes of the level's planes
  // and q = the plane's [1,3,1] (x) [1,3,1] sum. Each plane's q is formed
  // once, when the plane is fresh, and carried to the two later outputs
  // that read it: level 0's in registers (qm, q0), level 1's in two float
  // planes of shared memory, plane n's q at slot n & 1 (each thread reads
  // and writes its own positions only: no barrier). Registers for both
  // levels spill at H = 2 (PERF.md section 6).

  // Level 1's shared q slot of plane n at the thread's position (l, m),
  // after the two z131 slots.
  __device__ __forceinline__ float* q_slot(int n, int l, int m) const {
    return xsp + (2 + (n & 1)) * FH * FW + tid_base(FW) + SBY * l * FW +
           SBZ * m;
  }

  // q of level L's fresh plane, whose values at the thread's positions are
  // f, over level L+1's frame: z131 = (z- + z+) + 3 u along the frame row
  // (one warp's: the z neighbours are lanes, or the next column of lane 0
  // / 31), stored in the float slot; then y131 = (y- + y+) + 3 z131 from
  // the rows above and below. Positions outside level L+1's columns hold
  // junk that no output reads.
  template <int L>
  __device__ __forceinline__ void plane_q(const float (&f)[P], float (&q)[P]) {
    constexpr unsigned kAll = 0xffffffffu;
    const int tx = threadIdx.x;
    float* zs = xsp + L * FH * FW + tid_base(FW);  // level L's z131 slot
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (!row_in(l, L)) continue;  // uniform across the warp
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int p = l * MB + m;
        // each lane offers column b to its neighbours; lane 31 offers its
        // column before (lane 0's z-1), lane 0 its column after (lane 31's z+1)
        float lo = m > 0 && tx == SBZ - 1 ? f[p - 1] : f[p];
        float hi = m < MB - 1 && tx == 0 ? f[p + 1] : f[p];
        lo = __shfl_sync(kAll, lo, (tx + SBZ - 1) % SBZ);
        hi = __shfl_sync(kAll, hi, (tx + 1) % SBZ);
        q[p] = M::add(M::add(lo, hi), M::mul(3.0f, f[p]));
        zs[SBY * l * FW + SBZ * m] = q[p];
      }
    }
    __syncthreads();
    const XsView z{xsp + L * FH * FW + tid_base(FW), 0};
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (!row_in(l, L + 1)) continue;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int p = l * MB + m;
        q[p] = M::add(M::add(z.at(l, m, -1, 0), z.at(l, m, 1, 0)),
                      M::mul(3.0f, q[p]));
      }
    }
  }

  // Stage J at step i: q of level L = J-1's fresh plane n (input plane i,
  // or the level-1 plane i-1 that stage 1 made this step), then, once the
  // stage has work (i >= 2J), level J's plane q = i - J from level L's
  // planes q-1 (g[L] and its q), q (its slot and q) and q+1 (the fresh
  // plane and qp). Then the q planes and level L's slot move on.
  template <int J>
  __device__ __forceinline__ void stage_mehr(int i, const Weights& w) {
    constexpr int L = J - 1;
    if (i < 2 * L) return;  // level L has no plane yet (uniform)
    float qp[P];
    if constexpr (L == 0) {
      float f[P];
      const InView cur = in_view(i);
#pragma unroll
      for (int l = 0; l < LA; ++l) {
#pragma unroll
        for (int m = 0; m < MB; ++m) f[l * MB + m] = cur.at(l, m, 0, 0);
      }
      plane_q<L>(f, qp);
    } else {
      plane_q<L>(v[L & 1], qp);
    }
    const int n = i - L;  // level L's fresh plane
    if (i >= 2 * J) {
      if constexpr (L == 0) {
        compute_mehr<J>(i - J, n, in_view(i - 1), in_view(i), qp, w);
      } else {
        compute_mehr<J>(i - J, n, lv_view(), in_view(i), qp, w);
      }
    }
    if constexpr (L == 1) {
#pragma unroll
      for (int l = 0; l < LA; ++l) {
        if (!row_in(l, L + 1)) continue;
#pragma unroll
        for (int m = 0; m < MB; ++m) *q_slot(n, l, m) = qp[l * MB + m];
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        qm[p] = q0[p];
        q0[p] = qp[p];
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
      __syncthreads();  // stage J has read level L's slot
      T* s = lvl + tid_base(FW);
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

  // Level J's plane q at the thread's positions of level J's frame (the
  // output tile at J = H): (a u0 + b S) + d ((px + py) + pz), the JAX
  // kernel's op order, then rounded and pinned (J < H) or stored.
  template <int J, class V0>
  __device__ __forceinline__ void compute_mehr(int q, int n, const V0& p0,
                                               const InView& cur,
                                               const float (&qp)[P],
                                               const Weights& w) {
    constexpr int L = J - 1;
    const float a = w.w[0], b = w.w[1], d = w.w[2];
    const int gx = plane_x(q);
    const bool x_out = src.is_bc(gx);
    const int64_t o0 = ((int64_t)gx * ny + y0 + (int)threadIdx.y - H) * nz +
                       z0 + (int)threadIdx.x - H;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (J < H ? !row_in(l, J) : !((rowout >> l) & 1)) continue;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (J < H ? !col_in(m, J) : !((colout >> m) & 1)) continue;
        const int p = l * MB + m;
        float qmv, q0v;  // q of level L's planes n-2 and n-1
        if constexpr (L == 1) {
          qmv = *q_slot(n, l, m);
          q0v = *q_slot(n - 1, l, m);
        } else {
          qmv = qm[p];
          q0v = q0[p];
        }
        const float sq = M::add(M::add(qmv, qp[p]), M::mul(3.0f, q0v));
        const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
        const float px = M::add(g[L][p], pp);
        const float py = M::add(p0.at(l, m, -1, 0), p0.at(l, m, 1, 0));
        const float pz = M::add(p0.at(l, m, 0, -1), p0.at(l, m, 0, 1));
        const float psum = M::add(M::add(px, py), pz);
        const float r =
            M::add(M::add(M::mul(a, p0.at(l, m, 0, 0)), M::mul(b, sq)),
                   M::mul(d, psum));
        if constexpr (J < H) {
          const bool pin = !periodic && (x_out || !((rowin >> l) & 1) ||
                                         !((colin >> m) & 1));
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
    if constexpr (MEHR) {
      (stage_mehr<J + 1>(i, w), ...);
    } else {
      (stage<J + 1>(i, w), ...);
    }
  }

  // Output planes [xs0, xe).
  __device__ __forceinline__ void run(int xe, const Weights& w) {
    const int n_in = xe - xs0 + 2 * H;
    init_masks();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d < n_in) load_plane(d);
      cp_async_commit();
    }
    for (int i = 0; i < n_in; ++i) {
      cp_async_wait<D - 1>();
      __syncthreads();  // plane i landed; the slot of plane i+D is free
      if (i + D < n_in) load_plane(i + D);
      cp_async_commit();  // one group a step, empty at the end
      stages(i, w, std::make_integer_sequence<int, H>{});
    }
  }
};

}  // namespace
