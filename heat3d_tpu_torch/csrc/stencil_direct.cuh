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
// slots' float field values are rounded once, as their plane lands
// (round_landed), and bc (ghosts and the level-1 pins) is read as M reads a
// T (the kernels set it so). The design is described at the head of
// stencil_direct.cu.

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
// planes from the source Src. PK: the direct kernel's own instance, which
// packs its columns under bf16 compute (PAIR).
template <class T, int H, int S, class M, class Src, bool PK = false>
struct Direct {
  using G = Geom<H, S>;
  static constexpr int LA = G::LA, MB = G::MB, P = G::P;
  static constexpr int FH = G::FH, FW = G::FW, SWI = in_stride<T, H, S>();
  static constexpr bool XS = uses_xsum<S>();
  static constexpr bool MEHR = S == SPEC_MEHR;
  // the Mehrstellen two-update route: rows owned in runs, state in registers
  static constexpr bool QR = row_runs<H, S>();
  static constexpr bool SHIFT = sizeof(T) == 2;
  static constexpr int NS = in_slots<T, H, S>();  // input slots
  // planes loaded ahead: the chains read planes i-1 and i of the ring, the
  // QR route plane i only
  static constexpr int D = QR ? NS - 1 : NS - 2;
  static constexpr int NP = MB / 2 + 1;           // bf16 pairs a thread copies
  // bf16 compute of an fp32 field over two updates, a chain (the PAIR
  // design of stencil_direct.cu): the thread's columns tx and tx + 32 as
  // one bf16x2 word, column tx in the high half, in packed rows of words
  // -1 .. 32 (the lanes' 32 words and the copies of columns 31 and 32 that
  // lanes 0 and 31 read as z neighbours)
  static constexpr bool PAIR = PK && rounds_landed<T, M>() && H == 2 && !MEHR;
  static constexpr int MC = PAIR ? 1 : MB;  // computed positions a row
  static constexpr int PC = LA * MC;
  static constexpr int PW = SBZ + 2;         // words of a packed row
  static constexpr int CW = PAIR ? PW : FW;  // row stride of lvl and xsp
  using InView = View<T, PAIR ? PW : SWI, SHIFT>;
  using LvView = View<T, CW, false>;
  using XsView = View<float, CW, false>;

  Src src;
  T* __restrict__ out;
  T* in_slot;   // NS input slots
  T* lvl;       // the level-1 slot (H = 2)
  float* xsp;   // the x-sum slot (27pt); Mehrstellen: the z131 slot
                // (H = 1), the edge-row exchange (H = 2)
  float* pk;    // PAIR: three packed input planes, plane q at q % 3
  int ny, nz, xs0, y0, z0;
  int periodic;
  float bc;            // the Dirichlet value as M reads a T
  int rowin, colin;    // the thread's frame rows / columns inside the domain
  int pairin;          // bf16: pair j of shift s inside the domain, bit j+NP*s
  int zfull;           // every column the block copies lies inside [0, nz)
  int rowout, colout;  // the thread's rows / columns of the output tile
  float g[H][PC];      // level L's plane before the one in its slot
  float v[2][PC];      // a stage's fresh plane until it reaches its slot
  // Mehrstellen, H = 1: the q planes of planes q-1 (qm) and q (q0)
  float qm[MEHR && !QR ? P : 1], q0[MEHR && !QR ? P : 1];
  // QR: per thread row r (bit r), the rows whose level-1 value is pinned
  // to bc wherever the plane is (Dirichlet: outside the domain in y or z)
  // and the rows of the output tile
  int qpin, qout;
  // QR, fp32: the source row of each of the thread's loader rows
  // (ty + 8 l) and the source column of its column, wrapped under periodic
  // boundaries, -1 where a Dirichlet ghost takes bc
  int qsrcy[QR ? LA : 1], qsrcz;
  // QR: each level's planes at the thread's positions, plane n in buffer
  // n % 3 (the step loop runs three steps an iteration, so the buffers
  // rotate by name, with no copies): its values, q, z sums and the rows
  // just above and below the thread's
  struct Ring {
    float f[3][LA][MB], q[3][LA][MB], zs[3][LA][MB], fh[3][2][MB];
  };
  Ring ring[QR ? H : 1];

  __device__ __forceinline__ int tid_base(int sw) const {
    return threadIdx.y * sw + threadIdx.x;
  }

  // The thread's first position in lvl, xsp and (PAIR) the packed planes.
  __device__ __forceinline__ int cbase() const {
    return PAIR ? threadIdx.y * PW + 1 + threadIdx.x : tid_base(FW);
  }

  // PAIR: the bf16 value of a float word in both halves (weights, bc).
  __device__ __forceinline__ static float both(float x) {
    const unsigned u = __float_as_uint(x);
    return __uint_as_float(u | (u >> 16));
  }

  // PAIR: the thread's word w into the packed row at `row` (its own word),
  // with the copies lanes 0 and 31 keep: word 32 (column 32 in the high
  // half) from lane 0, word -1 (column 31 in the low half) from lane 31.
  __device__ __forceinline__ void put_pair(float* row, float w) const {
    row[0] = w;
    const float sw =
        __uint_as_float(__byte_perm(__float_as_uint(w), 0, 0x1032));
    if (threadIdx.x == 0) row[SBZ] = sw;
    if (threadIdx.x == SBZ - 1) row[-SBZ] = sw;
  }

  // PAIR: input plane i, landed in its float slot, rounded to bf16 and
  // packed into plane i % 3, a word for each of the thread's rows.
  __device__ __forceinline__ void pack_landed(int i) {
    const float* s = in_slot + (i % NS) * FH * SWI + tid_base(SWI);
    float* d = pk + (i % 3) * FH * PW + cbase();
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(s[SBY * l * SWI + SBZ], s[SBY * l * SWI]);
      put_pair(d + SBY * l * PW,
               __uint_as_float(*reinterpret_cast<const unsigned*>(&h)));
    }
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
    if constexpr (PAIR) return InView{pk + (q % 3) * FH * PW + cbase(), 0};
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
    return LvView{lvl + cbase(), 0};
  }

  __device__ __forceinline__ XsView xs_view() const {
    return XsView{xsp + cbase(), 0};
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
    if constexpr (QR) {
      static_assert(MB == 1, "the QR route owns one column a thread");
      const int gz = zb + threadIdx.x;
      const bool zin = gz >= 0 && gz < nz;
      const bool zout = threadIdx.x >= H && threadIdx.x < FW - H && gz < nz;
      qpin = qout = 0;
      qsrcz = zin ? gz : periodic ? wrap(gz, nz) : -1;
#pragma unroll
      for (int l = 0; l < LA; ++l) {
        const int gy = y0 + threadIdx.y + SBY * l - H;
        qsrcy[l] = gy >= 0 && gy < ny ? gy : periodic ? wrap(gy, ny) : -1;
      }
#pragma unroll
      for (int r = 0; r < LA; ++r) {
        const int a = LA * threadIdx.y + r;
        const int gy = y0 + a - H;
        if (!periodic && !(zin && gy >= 0 && gy < ny)) qpin |= 1 << r;
        if (zout && a >= H && a < FH - H && gy < ny) qout |= 1 << r;
      }
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

  // fp32: landed plane `plane` into `slot` at the thread's positions,
  // every load issued before the first store (a store to the slot may
  // alias a later load for all the compiler knows, which would keep the
  // loads one at a time).
  __device__ __forceinline__ void load_landed(T* slot, const T* plane,
                                              T b) const {
    const int zb = z0 - H;
    T v[LA][MB];
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const bool in = (rowin >> l) & 1;
      const int gy = y0 - H + threadIdx.y + SBY * l;
      const T* row = plane + (int64_t)(in ? gy : wrap(gy, ny)) * nz;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int c = zb + threadIdx.x + SBZ * m;
        v[l][m] = !in && !periodic                  ? b
                  : zfull || ((colin >> m) & 1) ? load_cg(row + c)
                                                : ghost_z(row, c, b, true);
      }
    }
#pragma unroll
    for (int l = 0; l < LA; ++l) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        slot[(threadIdx.y + SBY * l) * SWI + threadIdx.x + SBZ * m] = v[l][m];
      }
    }
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
    if constexpr (sizeof(T) == 4) {
      if (landed) {
        load_landed(slot, plane, b);
        return;
      }
    }
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
            cp_async4(dst + c, row + zb + c, 4);
          } else {
            dst[c] = ghost_z(row, zb + c, b, false);
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

  // The QR route's fp32 loader: input plane q into its slot, each thread
  // its own positions (rows ty + 8 l, column tx), from the source rows and
  // column fixed once per block; ghosts beyond a Dirichlet face take bc.
  __device__ __forceinline__ void load_plane_qr(int q) {
    static_assert(!Src::kLands && sizeof(T) == 4, "field planes, fp32");
    T* dst = in_slot + (q % NS) * FH * SWI + tid_base(SWI);
    const T* plane = src.at(plane_x(q));  // null: a bc plane
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (plane != nullptr && qsrcy[l] >= 0 && qsrcz >= 0) {
        cp_async4(dst + SBY * l * SWI, plane + (int64_t)qsrcy[l] * nz + qsrcz,
                  4);
      } else {
        dst[SBY * l * SWI] = from_f<T>(bc);
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
          for (int m = 0; m < MC; ++m) {
            if (!PAIR && !col_in(m, L)) continue;
            const int p = l * MC + m;
            const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
            float* x = xsp + cbase() + SBY * l * CW + SBZ * m;
            if constexpr (PAIR) {
              put_pair(x, M::add(g[L][p], pp));
            } else {
              *x = M::add(g[L][p], pp);
            }
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
          for (int m = 0; m < MC; ++m) g[0][l * MC + m] = prev.at(l, m, 0, 0);
        }
      }
    } else {
      if (i >= 2 * L) {
        __syncthreads();  // stage J has read level L's slot (and xsp)
        T* s = lvl + cbase();
#pragma unroll
        for (int l = 0; l < LA; ++l) {
          if (!row_in(l, L)) continue;
#pragma unroll
          for (int m = 0; m < MC; ++m) {
            if (!PAIR && !col_in(m, L)) continue;
            const int p = l * MC + m;
            const int o = SBY * l * CW + SBZ * m;
            g[L][p] = to_f(s[o]);
            if constexpr (PAIR) {
              put_pair(s + o, v[L & 1][p]);
            } else {
              s[o] = from_f<T>(v[L & 1][p]);
            }
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
      for (int m = 0; m < MC; ++m) {
        if (!PAIR && (J < H ? !col_in(m, J) : !((colout >> m) & 1))) continue;
        const int p = l * MC + m;
        const float pp = L == 0 ? cur.at(l, m, 0, 0) : v[L & 1][p];
        const Cell<V0, XsView> c{g[L][p], pp, p0, xs, l, m};
        const float r = chain<S, M>(w, c);
        if constexpr (PAIR) {
          const unsigned u = __float_as_uint(r);
          if constexpr (J < H) {
            // the halves pinned to bc: a whole row or plane, or a column
            const unsigned pin = periodic                       ? 0u
                                 : x_out || !((rowin >> l) & 1) ? 0xffffffffu
                                 : ((colin & 1) ? 0u : 0xffff0000u) |
                                       ((colin & 2) ? 0u : 0xffffu);
            const unsigned b = __float_as_uint(both(bc));
            v[J & 1][p] = __uint_as_float((u & ~pin) | (b & pin));
          } else {
            T* o = out + o0 + SBY * l * nz;
            if (colout & 1) o[0] = __uint_as_float(u & 0xffff0000u);
            if (colout & 2) o[SBZ] = __uint_as_float(u << 16);
          }
        } else if constexpr (J < H) {
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
  // S = (q[x-1] + q[x+1]) + 3 q[x] over the q planes of the level's planes,
  // q = the plane's [1,3,1] (x) [1,3,1] sum and psum = (px + py) + pz the
  // face neighbours' pair sums. Each plane's q is formed once, when the
  // plane is fresh, and carried to the outputs that read it.

  // (z-1) + (z+1) along one frame row, whose values at the thread's
  // columns tx + 32 m are f[m]: the z neighbours are lanes, or the next
  // column of lane 0 / 31 (junk at frame columns 0 and FW - 1, which no
  // output reads). Every lane of the warp calls it on the same row.
  __device__ __forceinline__ void zsum(const float (&f)[MB],
                                       float (&s)[MB]) const {
    constexpr unsigned kAll = 0xffffffffu;
    const int tx = threadIdx.x;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      // each lane offers column b to its neighbours; lane 31 offers its
      // column before (lane 0's z-1), lane 0 its column after (lane 31's z+1)
      float lo = m > 0 && tx == SBZ - 1 ? f[m - 1] : f[m];
      float hi = m < MB - 1 && tx == 0 ? f[m + 1] : f[m];
      lo = __shfl_sync(kAll, lo, (tx + SBZ - 1) % SBZ);
      hi = __shfl_sync(kAll, hi, (tx + 1) % SBZ);
      s[m] = M::add(lo, hi);
    }
  }

  // H = 1: q of the fresh input plane, whose values at the thread's
  // positions are f, over the output frame: z131 = (z- + z+) + 3 u along
  // the frame row, stored in the float slot; then y131 = (y- + y+) + 3 z131
  // from the rows above and below.
  __device__ __forceinline__ void plane_q(const float (&f)[LA][MB],
                                          float (&q)[LA][MB]) {
    float* zs = xsp + tid_base(FW);
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      float s[MB];
      zsum(f[l], s);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        q[l][m] = M::add(s[m], M::mul(3.0f, f[l][m]));
        zs[SBY * l * FW + SBZ * m] = q[l][m];
      }
    }
    __syncthreads();
    const XsView z{xsp + tid_base(FW), 0};
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (!row_in(l, 1)) continue;  // uniform across the warp
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        q[l][m] = M::add(M::add(z.at(l, m, -1, 0), z.at(l, m, 1, 0)),
                         M::mul(3.0f, q[l][m]));
      }
    }
  }

  // H = 1, step i: q of input plane i, then the output plane i - 1 from
  // planes i-2 (g[0], qm), i-1 (its slot, q0) and i (f, qp); then the q
  // planes move on. Level 0's q planes ride in registers (qm, q0).
  __device__ __forceinline__ void stage_mehr(int i, const Weights& w) {
    float f[LA][MB], qp[LA][MB];
    const InView cur = in_view(i);
#pragma unroll
    for (int l = 0; l < LA; ++l) {
#pragma unroll
      for (int m = 0; m < MB; ++m) f[l][m] = cur.at(l, m, 0, 0);
    }
    plane_q(f, qp);
    if (i >= 2) compute_mehr(i - 1, in_view(i - 1), f, qp, w);
#pragma unroll
    for (int l = 0; l < LA; ++l) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int p = l * MB + m;
        qm[p] = q0[p];
        q0[p] = qp[l][m];
      }
    }
    if (i >= 1) {
      const InView prev = in_view(i - 1);
#pragma unroll
      for (int l = 0; l < LA; ++l) {
#pragma unroll
        for (int m = 0; m < MB; ++m) g[0][l * MB + m] = prev.at(l, m, 0, 0);
      }
    }
  }

  // H = 1: output plane q at the thread's positions of the output tile:
  // (a u0 + b S) + d ((px + py) + pz), the JAX kernel's op order.
  __device__ __forceinline__ void compute_mehr(int q, const InView& p0,
                                               const float (&pp)[LA][MB],
                                               const float (&qp)[LA][MB],
                                               const Weights& w) {
    const float a = w.w[0], b = w.w[1], d = w.w[2];
    const int64_t o0 =
        ((int64_t)plane_x(q) * ny + y0 + (int)threadIdx.y - H) * nz + z0 +
        (int)threadIdx.x - H;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      if (!((rowout >> l) & 1)) continue;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (!((colout >> m) & 1)) continue;
        const int p = l * MB + m;
        const float sq = M::add(M::add(qm[p], qp[l][m]), M::mul(3.0f, q0[p]));
        const float px = M::add(g[0][p], pp[l][m]);
        const float py = M::add(p0.at(l, m, -1, 0), p0.at(l, m, 1, 0));
        const float pz = M::add(p0.at(l, m, 0, -1), p0.at(l, m, 0, 1));
        const float psum = M::add(M::add(px, py), pz);
        const float r =
            M::add(M::add(M::mul(a, p0.at(l, m, 0, 0)), M::mul(b, sq)),
                   M::mul(d, psum));
        out[o0 + (SBY * l * nz + SBZ * m)] = from_f<T>(r);
      }
    }
  }

  // --- H = 2 (QR): warp ty owns the LA consecutive frame rows LA ty + r,
  // lane tx the frame column tx (MB = 1). A level's fresh plane arrives
  // with the rows just above and below the thread's (input planes from the
  // slot, level-1 planes through the edge-row exchange); its z sums are
  // shuffles, and its y sums and every neighbour an output reads come from
  // the thread's registers: each level keeps its planes n-2 and n-1 in a
  // Ring. Rows beyond the frame read clamped rows: junk that no output
  // reads.

  // Input plane value at frame row LA ty + r (r in -1 .. LA), column m, of
  // the slot whose bf16 rows start at parity bp.
  __device__ __forceinline__ float in_at(const T* slot, int bp, int r,
                                         int m) const {
    int a = LA * (int)threadIdx.y + r;
    if (r < 0) a = max(a, 0);
    if (r >= LA) a = min(a, FH - 1);
    int o = a * SWI + (int)threadIdx.x + SBZ * m;
    if constexpr (SHIFT) o += bp ^ (a & nz & 1);
    return to_f(slot[o]);
  }

  // Level J-1's fresh plane n = q + 1, in buffer B of its ring (values
  // and the rows above and below), streamed row by row: a row's z sum and
  // z131, and, once the row below has its z131, the q of the thread's row
  // r above it; then, when `active`, level J's plane q at row r from
  // planes n-2, n-1 and n (into the next ring's buffer v at J < H, else
  // stored). Rows stream so that few of them are live at once.
  template <int J, int B>
  __device__ __forceinline__ void qr_level(int q, bool active,
                                           const Weights& w,
                                           float (&v)[LA][MB]) {
    constexpr int B1 = (B + 2) % 3, B2 = (B + 1) % 3;  // planes n-1, n-2
    Ring& R = ring[J - 1];
    const float a = w.w[0], b = w.w[1], d = w.w[2];
    const int gx = plane_x(q);
    const bool xpin = !periodic && src.is_bc(gx);
    const int64_t o0 =
        ((int64_t)gx * ny + y0 + LA * (int)threadIdx.y - H) * nz + z0 +
        (int)threadIdx.x - H;
    float z2[MB], z1[MB];  // z131 of the two rows above the current one
#pragma unroll
    for (int j = 0; j < LA + 2; ++j) {  // rows LA ty - 1 + j
      float row[MB], zs[MB], z[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        row[m] = j == 0        ? R.fh[B][0][m]
                 : j == LA + 1 ? R.fh[B][1][m]
                               : R.f[B][j - 1][m];
      }
      zsum(row, zs);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        z[m] = M::add(zs[m], M::mul(3.0f, row[m]));
        if (j >= 1 && j <= LA) R.zs[B][j - 1][m] = zs[m];
      }
      if (j >= 2) {
        const int r = j - 2;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float qn = M::add(M::add(z2[m], z[m]), M::mul(3.0f, z1[m]));
          R.q[B][r][m] = qn;
          if (active && (J < H || ((qout >> r) & 1))) {
            const float above = r == 0 ? R.fh[B1][0][m] : R.f[B1][r - 1][m];
            const float below =
                r == LA - 1 ? R.fh[B1][1][m] : R.f[B1][r + 1][m];
            const float sq =
                M::add(M::add(R.q[B2][r][m], qn), M::mul(3.0f, R.q[B1][r][m]));
            const float px = M::add(R.f[B2][r][m], R.f[B][r][m]);
            const float py = M::add(above, below);
            const float psum = M::add(M::add(px, py), R.zs[B1][r][m]);
            const float res =
                M::add(M::add(M::mul(a, R.f[B1][r][m]), M::mul(b, sq)),
                       M::mul(d, psum));
            if constexpr (J < H) {
              const bool pin = xpin || ((qpin >> r) & 1);
              v[r][m] = pin ? bc : to_f(from_f<T>(res));
            } else {
              out[o0 + ((int64_t)r * nz + SBZ * m)] = from_f<T>(res);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        z2[m] = z1[m];
        z1[m] = z[m];
      }
    }
  }

  // H = 2, step i: level 0's fresh plane is input plane i (from its slot,
  // read at this step only) into buffer PH = i % 3 of ring 0, level 1's the
  // plane i-1 that level 0 emits into buffer (i - 1) % 3 of ring 1. Its
  // edge rows go through the exchange (rows 2 ty and 2 ty + 1: the warp's
  // first and last row), one barrier, and each warp takes the rows above
  // and below its own.
  template <int PH>
  __device__ __forceinline__ void stage_qr(int i, const Weights& w) {
    constexpr int L1 = (PH + 2) % 3;
    Ring &R0 = ring[0], &R1 = ring[1];
    {
      const T* slot = in_slot + (i % NS) * FH * SWI;
      const int bp = SHIFT ? parity0(plane_x(i)) : 0;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
#pragma unroll
        for (int r = 0; r < LA; ++r) R0.f[PH][r][m] = in_at(slot, bp, r, m);
        R0.fh[PH][0][m] = in_at(slot, bp, -1, m);
        R0.fh[PH][1][m] = in_at(slot, bp, LA, m);
      }
    }
    qr_level<1, PH>(i - 1, i >= 2, w, R1.f[L1]);
    if (i < 2) return;  // level 1 has no plane yet (uniform)
    const int ty = threadIdx.y, tx = threadIdx.x;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      xsp[2 * ty * FW + tx + SBZ * m] = R1.f[L1][0][m];
      xsp[(2 * ty + 1) * FW + tx + SBZ * m] = R1.f[L1][LA - 1][m];
    }
    __syncthreads();  // the edge rows are out
    const int above = max(2 * ty - 1, 0), below = min(2 * ty + 2, 2 * SBY - 1);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      R1.fh[L1][0][m] = xsp[above * FW + tx + SBZ * m];
      R1.fh[L1][1][m] = xsp[below * FW + tx + SBZ * m];
    }
    float unused[LA][MB];
    qr_level<2, L1>(i - 2, i >= 4, w, unused);
  }

  template <int... J>
  __device__ __forceinline__ void stages(int i, const Weights& w,
                                         std::integer_sequence<int, J...>) {
    if constexpr (MEHR) {
      stage_mehr(i, w);
    } else {
      (stage<J + 1>(i, w), ...);
    }
  }

  __device__ __forceinline__ void load(int q) {
    if constexpr (QR && sizeof(T) == 4) {
      load_plane_qr(q);
    } else {
      load_plane(q);
    }
  }

  // Step i of n_in: plane i landed, plane i + D started, the stages.
  template <int PH>
  __device__ __forceinline__ void step(int i, int n_in, const Weights& w) {
    cp_async_wait<D - 1>();
    if constexpr (PAIR) {
      pack_landed(i);
    } else {
      round_landed<T, M, G>(in_slot + (i % NS) * FH * SWI);
    }
    __syncthreads();  // plane i landed; the slot of plane i+D is free
    if (i + D < n_in) load(i + D);
    cp_async_commit();  // one group a step, empty at the end
    if constexpr (QR) {
      stage_qr<PH>(i, w);
    } else {
      stages(i, w, std::make_integer_sequence<int, H>{});
    }
  }

  // Output planes [xs0, xe).
  __device__ __forceinline__ void run(int xe, const Weights& w) {
    if constexpr (PAIR) {  // the weights in both halves
      Weights wp;
#pragma unroll
      for (int k = 0; k < MAX_TERMS; ++k) wp.w[k] = both(w.w[k]);
      sweep(xe, wp);
    } else {
      sweep(xe, w);
    }
  }

  __device__ __forceinline__ void sweep(int xe, const Weights& w) {
    const int n_in = xe - xs0 + 2 * H;
    init_masks();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d < n_in) load(d);
      cp_async_commit();
    }
    if constexpr (QR) {
      // three steps an iteration: the rings' buffers rotate by name
      for (int i = 0; i < n_in; i += 3) {
        step<0>(i, n_in, w);
        if (i + 1 < n_in) step<1>(i + 1, n_in, w);
        if (i + 2 < n_in) step<2>(i + 2, n_in, w);
      }
    } else {
      for (int i = 0; i < n_in; ++i) step<0>(i, n_in, w);
    }
  }
};

// ---------------------------------------------------------------------------
// The generic sweep: any emission program, folded at launch (GenericArgs),
// over any plane source: direct_generic<T, H, M> (stencil_direct.cu) runs
// it over the field's planes, fused_generic<T, H, M> (stencil_fused.cu)
// over the field's planes in its interior tiles and the shard's planes in
// its skin tiles.
//
// The chains' block (Direct: geometry, masks, loader, views) with every
// level's planes in shared memory. Each level has a float ring of four
// slots: its plane m in slot m & 3, and the x-sum of plane q (planes q-1
// and q+1) in slot (q + 2) & 3, the one the next plane overwrites. An
// input plane lands in the one input slot, is copied into level 0's ring
// as M reads a T (rounded there under bf16 compute of an fp32 field) and
// its slot refilled with the next plane at once; at H = 2 level 1's
// planes, rounded through T and pinned to bc outside a Dirichlet domain
// (the x pin where the source has a bc plane), go to level 1's ring. Each
// thread forms the x-sums at its own positions from the planes it wrote
// itself.
template <class T, int H, class M, class Src>
struct GenericSweep : Direct<T, H, SPEC_GENERIC, M, Src> {
  using B = Direct<T, H, SPEC_GENERIC, M, Src>;
  static constexpr int LA = B::LA, MB = B::MB, P = B::P, FW = B::FW;
  static constexpr int PS = B::FH * FW;  // floats of a ring slot

  float* rings;  // H rings of four slots

  // The input slot and the rings in the block's dynamic shared memory
  // (generic_smem).
  __device__ __forceinline__ void place(unsigned char* smem) {
    this->in_slot = reinterpret_cast<T*>(smem);
    rings = reinterpret_cast<float*>(this->in_slot + B::FH * B::SWI);
  }

  // Offset of the thread's position p from its first one in a slot.
  __host__ __device__ static constexpr int pos(int p) {
    return SBY * (p / MB) * FW + SBZ * (p % MB);
  }

  // The thread's first position in slot k & 3 of level L's ring.
  __device__ __forceinline__ float* slot(int L, int k) const {
    return rings + (4 * L + (k & 3)) * PS + this->tid_base(FW);
  }

  // acc: the chain of level L's plane q at the thread's positions.
  __device__ __forceinline__ void eval(int L, int q, const GenericArgs& a,
                                       float (&acc)[P]) const {
    const float* lb = rings + 4 * L * PS + this->tid_base(FW);
    const int qr = q + 3;
#pragma unroll
    for (int i = 0; i < MAX_TERMS; ++i) {
      if (i < a.n) {  // uniform across the launch
        const float* t = lb + ((qr + a.s[i]) & 3) * PS + a.o[i];
        if (a.y[i]) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            term(acc[p], i, a.w[i], M::add(t[pos(p)], t[pos(p) + 2 * FW]));
          }
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) term(acc[p], i, a.w[i], t[pos(p)]);
        }
      }
    }
  }

  // Term i of a cell: w v, the first term not added to 0.
  __device__ __forceinline__ static void term(float& acc, int i, float w,
                                              float v) {
    const float m = M::mul(w, v);
    acc = i == 0 ? m : M::add(acc, m);
  }

  // Store value v of plane m at position p of level L's slot m & 3 and,
  // when `xs`, the x-sum of plane m - 1 (planes m - 2 and m) in slot
  // (m + 1) & 3; the thread wrote plane m - 2 there itself.
  __device__ __forceinline__ void put(int L, int m, int p, float v,
                                      bool xs) const {
    slot(L, m)[pos(p)] = v;
    if (xs) slot(L, m + 1)[pos(p)] = M::add(slot(L, m - 2)[pos(p)], v);
  }

  // Input plane i from its slot into level 0's ring.
  __device__ __forceinline__ void land(int i, const GenericArgs& a) const {
    const auto cur = this->in_view(i);
    const bool xs = a.xsum && i >= 2;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      put(0, i, p, M::template read<T>(cur.at(p / MB, p % MB, 0, 0)), xs);
    }
  }

  // H = 2, step i: level 1's plane m = i - 1 into its ring.
  __device__ __forceinline__ void level1(int i, const GenericArgs& a) const {
    const int m = i - 1;
    float acc[P];
    eval(0, m, a, acc);
    const bool x_out = this->src.is_bc(this->plane_x(m));
    const bool xs = a.xsum && i >= 4;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool in = ((this->rowin >> (p / MB)) & 1) &&
                      ((this->colin >> (p % MB)) & 1);
      const bool pin = !this->periodic && (x_out || !in);
      put(1, m, p, pin ? this->bc : to_f(from_f<T>(acc[p])), xs);
    }
  }

  // Output plane q of level L at the thread's positions of the tile.
  __device__ __forceinline__ void emit(int L, int q,
                                       const GenericArgs& a) const {
    float acc[P];
    eval(L, q, a, acc);
    const int64_t row0 = (int64_t)this->plane_x(q) * this->ny + this->y0 +
                         (int)threadIdx.y - H;
    const int64_t o0 = row0 * this->nz + this->z0 + (int)threadIdx.x - H;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int l = p / MB, m = p % MB;
      if (((this->rowout >> l) & 1) && ((this->colout >> m) & 1)) {
        this->out[o0 + (SBY * l * this->nz + SBZ * m)] = from_f<T>(acc[p]);
      }
    }
  }

  // Start input plane i + 1 (if any) into the input slot.
  __device__ __forceinline__ void next(int i, int n_in) {
    if (i + 1 < n_in) this->load_plane(i + 1);
    cp_async_commit();
  }

  // Output planes [xs0, xe). Step i lands input plane i; level 1's plane
  // i - 1 (H = 2) and the output plane i - H follow.
  __device__ __forceinline__ void run(int xe, const GenericArgs& a) {
    const int n_in = xe - this->xs0 + 2 * H;
    this->init_masks();
    this->load_plane(0);
    cp_async_commit();
    for (int i = 0; i < n_in; ++i) {
      cp_async_wait<0>();
      __syncthreads();  // plane i landed; the slots step i writes are read
      land(i, a);
      // an fp32 thread copies and reads its own positions of the input
      // slot, whatever the plane (a cp.async, a landed plane's synchronous
      // load, a ghost or a bc row: load_plane, fill_row); bf16 pairs are
      // other threads' positions
      if constexpr (sizeof(T) == 4) next(i, n_in);
      __syncthreads();  // level 0's planes and x-sum out
      if constexpr (sizeof(T) != 4) next(i, n_in);
      if constexpr (H == 1) {
        if (i >= 2) emit(0, i - 1, a);
      } else {
        if (i >= 2) {  // uniform
          level1(i, a);
          __syncthreads();  // level 1's planes and x-sum out
        }
        if (i >= 4) emit(1, i - 2, a);
      }
    }
  }
};

// Dynamic shared memory of the generic instance (T, H): the input slot,
// the H rings, and a row and a column beyond the last ring that the
// positions outside a level's planes read (the input slot lies before the
// first ring).
template <class T, int H>
__host__ __device__ constexpr int generic_smem() {
  using G = Geom<H>;
  return G::FH * in_stride<T, H>() * (int)sizeof(T) +
         (4 * H * G::FH * G::FW + G::FW + 4) * (int)sizeof(float);
}

// Launch bounds: four blocks an SM (64 registers) at H = 1, three (80)
// at H = 2, as many as the shared memory holds.
template <int H>
__host__ __device__ constexpr int generic_min_blocks() {
  return H == 1 ? 4 : 3;
}

}  // namespace
