// BC-fused direct-stencil kernels for Hopper (sm_90a): one explicit-Euler
// update (halo H = 1) or two fused updates (H = 2) of the UNPADDED field,
// with the Dirichlet/periodic ghosts built by the loader.
//
// Replaces heat3d_tpu/ops/stencil_pallas_direct.py::apply_taps_direct
// (_direct_kernel, H = 1) and ::apply_taps_direct2 (_direct2_kernel,
// H = 2).
//
// Two families of instances, as in stencil_stream.cu:
//   * direct_kernel<T, H, S, M>: the tap chain S fixed at compile time (the 7pt
//     and the factored 27pt chain of the wrapper's table, ops/stencil_stream.py
//     CHAINS, passed to nvcc as HEAT3D_CHAIN_7PT / HEAT3D_CHAIN_27PT; the
//     weights are a kernel argument). The wrapper picks S by comparing
//     emission_program(taps) with that table. S = SPEC_MEHR is the
//     Mehrstellen q-ring route of the JAX kernels (HEAT3D_MEHRSTELLEN, taps
//     a*delta + b*S + d*F; a, b, d are the first three weights): each
//     plane's [1,3,1] (x) [1,3,1] sum q is formed once per level, when the
//     plane is fresh, and carried to the outputs that read it; an output is
//     (a u0 + b ((q[x-1] + q[x+1]) + 3 q[x])) + d psum, 19 fp32 ops a cell
//     and update. At H = 1 (the first design) the z sums are shuffles, the
//     y sums go through a float z131 slot and level 0's q planes ride in
//     registers: three blocks an SM (80 registers; bf16 storage four). At
//     H = 2 (the QR design, stencil_direct.cuh) warp ty owns frame rows
//     4 ty .. 4 ty + 3 and lane tx column tx of a 32 x 32 frame (28 x 28
//     output tiles): a level's fresh plane comes with the rows above and
//     below the warp's (from the input slot, or for level 1 through a 2 KB
//     exchange of the warps' edge rows), z sums are shuffles, and every
//     other neighbour an output reads, q, the z sums and the planes x-1 and
//     x+1, lives in registers: each level keeps a ring of three planes
//     that rotates by name (the step loop runs three steps an iteration).
//     Two barriers a plane, about 8.5 shared accesses and shuffles a cell
//     against ~28 of the first design; 128 registers, two blocks an SM
//     (at 80 registers it spills and runs 1.7x slower), six input slots.
//     M is the arithmetic policy (stencil_common.cuh): F32Math, or Bf16Math
//     for bf16 compute (native bf16x2 add and multiply; an fp32-storage
//     field value rounded to bf16 once, as its plane lands), an instance of
//     its own for each chain and the Mehrstellen route. The chains' bf16
//     compute of an fp32 field at H = 2 is the PAIR design
//     (stencil_direct.cuh): the landing packs the thread's columns tx and
//     tx + 32, rounded, into one bf16x2 word of a packed plane (rows of
//     words -1 .. 32, lanes 0 and 31 keeping the copies of columns 32 and
//     31 their neighbours read), and the whole chain runs on those words
//     with the weights in both halves: one add.rn.bf16x2 / mul.rn.bf16x2
//     and one shared load for two cells, per-half pins, the two halves
//     stored apart (50 KB shared, four blocks an SM);
//   * direct_generic<T, H, M>: any other chain (other taps, advection's unequal
//     x pair, a zero centre, HEAT3D_FACTOR_7PT=1, HEAT3D_FACTOR_Y=0), of 1 to
//     27 terms, on the same block (Direct: geometry, masks, the loader that
//     builds the ghosts), by the generic sweep of stencil_direct.cuh
//     (GenericSweep, over the field's planes; the fused kernels' generic
//     instance runs it over their plane sources). Such a chain may read the
//     planes x-1 and x+1 away from the cell, so every level keeps its planes in
//     a float ring of four slots in shared memory (plane m in slot m & 3, the
//     x-sum of plane q in slot (q + 2) & 3); an input plane lands by cp.async
//     in one input slot and is copied into level 0's ring as M reads a T, its
//     slot refilled at once. The host folds each term (src, row, dk) into a
//     slot shift and an offset (GenericArgs, a kernel argument): a term is an
//     add and a mask on the constant bank, then one or two shared loads at
//     immediate offsets, __fmul_rn and __fadd_rn for each of the thread's
//     positions, in a loop unrolled to 27 terms with a branch on the term count
//     that is uniform across the launch; no switch on src, no division, the
//     compute dtype a template policy. Two barriers a plane at H = 1, three at
//     H = 2. It replaces the first design's interpreted kernels (a per-cell
//     program walk over synchronously loaded rings; 10.217 / 20.371 ms).
//     Measured (PERF.md section 6, 1024^3 fp32, the 7pt chain forced):
//     4.40-4.72 ms at H = 1 (four blocks an SM; the 7pt chain instance
//     5.14-5.24 in the same calls), 9.52-9.79 at H = 2 (three blocks an SM). At
//     H = 2 each level's chain costs about 3 ms over a 2.6 ms skeleton of
//     loads, copies and barriers, about what a chain costs a frame position at
//     H = 1 (scripts/torch_direct_probe.py --generic --variants with switches
//     since removed: without level 1's chain 5.53, without the output's 6.02,
//     without both 2.63): it runs at under half the issue and shared-memory
//     rates, and four blocks an SM (a 24-row frame), a 40-row frame at two
//     blocks, two or three input slots, the next term's loads issued before
//     this term's arithmetic (copied, or into a buffer of the term's parity),
//     and no third barrier each left it at 9.4-13.1.
//
// Bound: device-memory bytes. One sweep reads the field once and writes it
// once (8 B/cell in fp32, 4 B/cell in bf16) for 13 (7pt) to 26 (27pt,
// factored) flops per cell and update: at 1024^3 fp32 the bytes take 2.56
// ms on an H100 SXM, the flops of two updates 0.4-0.8 ms. Design of
// direct_kernel against that, the sweep of stream_kernel (stencil_chain.cuh)
// with a loader that builds the ghosts:
//   * the chain is unrolled at compile time: a term is one or two shared
//     loads at immediate offsets, __fmul_rn and __fadd_rn; each x-plane sum
//     is formed once per position and each y-row sum per term, from the
//     same operands in the same order as the cached sums of the plain
//     version (ops.stencil_eager);
//   * 32 x 8 threads own the positions (ty + 8 l, tx + 32 m) of a frame of
//     64 columns (z) by 40 (H = 1) or 32 (H = 2) rows (y), which starts at
//     (y0 - H, z0 - H); the output tile is the frame less 2H on each axis.
//     x-neighbours live in registers, so of each level one shared slot
//     (storage type; plus a float x-sum slot for 27pt) holds the plane whose
//     y/z neighbours are read. Launch bounds hold 64 registers, so four
//     blocks of 256 threads fit an SM;
//   * input planes land by cp.async (4 B; bf16 as the aligned element pairs
//     that hold each row, read with a per-row shift), two planes ahead into
//     a 4-slot ring where four blocks still fit an SM, else one ahead;
//   * the loader builds the ghosts. Which of the thread's rows and columns
//     lie inside the domain is decided once per block. A Dirichlet cell
//     outside the domain on any axis takes bc (a whole x-ghost plane needs
//     no copy); the threads store it, since cp.async's zero fill gives 0,
//     before the barrier that publishes the plane. Under periodic
//     boundaries the source plane and row wrap; in an edge tile the columns
//     across z = 0 or z = nz wrap per element, and a row whose wrapped
//     source starts on the other parity than the frame's layout (odd ny*nz)
//     is stored per element. Interior tiles copy whole rows;
//   * H = 2 computes the intermediate over the frame less one ring, rounds
//     it through T and, under Dirichlet, pins it to bc wherever its global
//     index lies outside the domain on any axis (stream_kernel's pin with
//     all six domain faces); under periodic nothing is pinned.
//
// Every instance equals apply_taps_direct_ref / apply_taps_direct2_ref
// (ops/stencil_direct.py) bitwise.
//
// Measured (chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md
// section 6), ms per launch at 1024^3 fp32 7pt against the bytes bound of
// 2.56: direct1 5.13 (5 blocks per SM, 46 registers), direct2 5.45 (4
// blocks, 60 registers), no spills; 27pt 5.00 / 9.11, 7pt bf16 4.11 / 7.16
// (bound 1.28); the Mehrstellen instances 4.66 / 6.31 fp32 (the 27pt chain
// of the same call 5.00 / 9.11; the first design's two-update instance
// took 8.24-8.44). On the way to the QR design (scripts/torch_direct_probe.py
// --variants): rings copied a step 8.60-8.96, rotated by name at two blocks
// an SM 7.55, with a loader of fixed source rows 6.31-6.57; level 1
// pipelined a step behind level 0 (one barrier a plane) 6.74-7.03, not
// kept. The generic instance forced on the 7pt chain: see PERF.md
// section 6, rows 1 and 2 (the first design took 10.217 / 20.371).
// The QR route's main loop issues about 110 instructions a frame cell
// (--variants --sass), at ~60% of the issue rate: latency-bound at 16
// warps an SM. In bf16 compute (chip_smoke.py compute_bf16_times, same
// card, the fp32-compute instance of the same call in brackets): 7pt fp32
// storage 5.04 [5.13] / 5.18 [5.46] (the first Bf16Math policy 6.55 /
// 11.93: a conversion beside every fp32 op; direct2 with a word a column,
// 6.10 [5.45]: of its 0.65 ms over fp32 the native bf16 ops took ~0.45,
// the landing rounding ~0.27, each replaced by its fp32 counterpart in a
// probe variant); Mehrstellen 5.02 [4.62] / 7.90 [6.46] (9.37 / 17.80
// before).
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "stencil_direct.cuh"

namespace {

constexpr int MAX_H = 2;

// Blocks per SM the launch bounds set the register budget for: four (64
// registers) for the chains and the bf16 one-update Mehrstellen instance;
// three (80) for the fp32 one-update Mehrstellen instance, which carries q
// planes beside the chain's registers (at 64 it spills;
// scripts/torch_direct_probe.py, PERF.md section 6); two (128) for the
// two-update Mehrstellen instances, whose two rings of planes live in
// registers (at 80 they spill 104-144 bytes and run 1.7x slower).
// Dynamic shared memory of instance (T, H, S, M): the chains' and the
// Mehrstellen route's (stencil_chain.cuh smem_bytes), or under PAIR the
// float input slots, then lvl and xsp in packed rows and three packed
// input planes.
template <class T, int H, int S, class M>
__host__ __device__ constexpr int direct_smem() {
  using D = Direct<T, H, S, M, FieldPlanes<T>, true>;
  if constexpr (D::PAIR) {
    return D::NS * D::FH * D::SWI * (int)sizeof(T) +
           ((H - 1) + (D::XS ? 1 : 0) + 3) * D::FH * D::PW * (int)sizeof(float);
  } else {
    return smem_bytes<T, H, S>();
  }
}

template <class T, int H, int S>
struct Bounds {
  static constexpr int min_blocks = row_runs<H, S>() ? 2
                                    : S == SPEC_MEHR && sizeof(T) == 4
                                        ? 3
                                        : MIN_BLOCKS;
};

// ---------------------------------------------------------------------------
// Specialised instances.

template <class T, int H, int S, class M>
__global__ void __launch_bounds__(SNT, (Bounds<T, H, S>::min_blocks))
    direct_kernel(const T* __restrict__ u, T* __restrict__ out, int nx,
                  int ny, int nz, int xchunk, int periodic, float bc,
                  Weights w) {
  static_assert(centre_x_only<S>(),
                "chain reads x-1/x+1 planes off the cell: generic instance");
  using G = Geom<H, S>;
  using D = Direct<T, H, S, M, FieldPlanes<T>, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  D st;
  st.src = FieldPlanes<T>{u, (int64_t)ny * nz, nx, periodic};
  st.out = out;
  st.in_slot = reinterpret_cast<T*>(smem_raw);
  st.lvl = st.in_slot + D::NS * G::FH * D::SWI;
  st.xsp = reinterpret_cast<float*>(
      st.lvl + (row_runs<H, S>() ? 0 : (H - 1) * G::FH * D::CW));
  st.pk = st.xsp + (D::XS ? G::FH * D::CW : 0);
  st.ny = ny;
  st.nz = nz;
  st.xs0 = blockIdx.z * xchunk;
  st.y0 = blockIdx.y * G::TY;
  st.z0 = blockIdx.x * G::TZ;
  st.periodic = periodic;
  st.bc = M::template read<T>(bc);
  st.run(min(nx, st.xs0 + xchunk), w);
}

// ---------------------------------------------------------------------------
// The generic instance: any emission program, folded at launch, by the
// generic sweep (stencil_direct.cuh) over the field's planes.

template <class T, int H, class M>
__global__ void __launch_bounds__(SNT, (generic_min_blocks<H>()))
    direct_generic(const T* __restrict__ u, T* __restrict__ out, int nx, int ny,
                   int nz, int xchunk, int periodic, float bc, GenericArgs a) {
  using G = Geom<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenericSweep<T, H, M, FieldPlanes<T>> st;
  st.src = FieldPlanes<T>{u, (int64_t)ny * nz, nx, periodic};
  st.out = out;
  st.place(smem_raw);
  st.ny = ny;
  st.nz = nz;
  st.xs0 = blockIdx.z * xchunk;
  st.y0 = blockIdx.y * G::TY;
  st.z0 = blockIdx.x * G::TZ;
  st.periodic = periodic;
  st.bc = M::template read<T>(bc);
  st.run(min(nx, st.xs0 + xchunk), a);
}

// ---------------------------------------------------------------------------
// Host side.

// One instance: its kernel, dynamic shared memory, tile and launch.
template <class T, int H, int S, class M>
struct Spec {
  static constexpr int bytes = direct_smem<T, H, S, M>();
  static constexpr int ty = Geom<H, S>::TY;
  static constexpr int tz = Geom<H, S>::TZ;
  static dim3 block() { return dim3(SBZ, SBY); }
  static void* fn() { return (void*)direct_kernel<T, H, S, M>; }
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> done{0};
    return set_smem_once(done, direct_kernel<T, H, S, M>, bytes);
  }
  static cudaError_t launch(dim3 grid, const void* u, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, const Program& prog,
                            cudaStream_t stream) {
    Weights w;
    for (int i = 0; i < MAX_TERMS; ++i) w.w[i] = i < prog.n ? prog.t[i].w : 0.f;
    direct_kernel<T, H, S, M><<<grid, block(), bytes, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, w);
    return cudaGetLastError();
  }
};

template <class T, int H, class M>
struct Generic {
  static constexpr int bytes = generic_smem<T, H>();
  static constexpr int ty = Geom<H>::TY;
  static constexpr int tz = Geom<H>::TZ;
  static dim3 block() { return dim3(SBZ, SBY); }
  static void* fn() { return (void*)direct_generic<T, H, M>; }
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> done{0};
    return set_smem_once(done, direct_generic<T, H, M>, bytes);
  }
  static cudaError_t launch(dim3 grid, const void* u, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, const Program& prog,
                            cudaStream_t stream) {
    direct_generic<T, H, M><<<grid, block(), bytes, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, fold(prog, Geom<H>::FW));
    return cudaGetLastError();
  }
};

// f.template run<Instance>() for instance (halo, spec, dtype, compute);
// `bad` for arguments no instance takes.
template <class T, int H, class M, class F>
int by_spec(int spec, const F& f) {
  switch (spec) {
    case SPEC_7PT:
      return f.template run<Spec<T, H, SPEC_7PT, M>>();
    case SPEC_27PT:
      return f.template run<Spec<T, H, SPEC_27PT, M>>();
    case SPEC_MEHR:
      return f.template run<Spec<T, H, SPEC_MEHR, M>>();
    default:
      return f.template run<Generic<T, H, M>>();
  }
}

template <class T, class M, class F>
int by_halo(int halo, int spec, const F& f) {
  return halo == 1 ? by_spec<T, 1, M>(spec, f) : by_spec<T, 2, M>(spec, f);
}

template <class F>
int with_instance(int halo, int spec, int dtype, int compute, int bad,
                  const F& f) {
  if ((dtype != 0 && dtype != 1) || (compute != 0 && compute != 1) ||
      spec < SPEC_GENERIC || spec > SPEC_MEHR || halo < 1 || halo > MAX_H) {
    return bad;
  }
  if (dtype == 0) {
    return compute == 0 ? by_halo<float, F32Math>(halo, spec, f)
                        : by_halo<float, Bf16Math>(halo, spec, f);
  }
  return compute == 0 ? by_halo<__nv_bfloat16, F32Math>(halo, spec, f)
                      : by_halo<__nv_bfloat16, Bf16Math>(halo, spec, f);
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
  const void* u;
  void* out;
  int nx, ny, nz, xchunk, periodic;
  float bc;
  const Program* prog;
  cudaStream_t stream;
  template <class I>
  int run() const {
    const cudaError_t err = I::prepare();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nz + I::tz - 1) / I::tz, (ny + I::ty - 1) / I::ty,
                    (nx + xchunk - 1) / xchunk);
    return (int)I::launch(grid, u, out, nx, ny, nz, xchunk, periodic, bc,
                          *prog, stream);
  }
};

}  // namespace

extern "C" {

// Tile extents of instance (halo, spec) (spec 0 generic, 1 the 7pt chain,
// 2 the 27pt chain, 3 the Mehrstellen route), so the wrapper sizes its
// x-chunks from the same numbers; -1 if there is no such instance.
int heat3d_direct_tile_y(int halo, int spec) {
  return with_instance(halo, spec, 0, 0, -1, TileY{});
}
int heat3d_direct_tile_z(int halo, int spec) {
  return with_instance(halo, spec, 0, 0, -1, TileZ{});
}

// Dynamic shared memory of one block of instance (halo, spec, dtype,
// compute), bytes.
int heat3d_direct_smem_bytes(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, -1, SmemBytes{});
}

// Resident blocks per SM of instance (halo, spec, dtype, compute) on the
// current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on
// error.
int heat3d_direct_blocks_per_sm(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, -1, BlocksPerSm{});
}

// Registers a thread of instance (halo, spec, dtype, compute) uses
// (cudaFuncGetAttributes); -1 on error.
int heat3d_direct_registers(int halo, int spec, int dtype, int compute) {
  return with_instance(halo, spec, dtype, compute, -1, Registers{});
}

// halo: 1 (one update) or 2 (two fused updates); spec: 0 generic, 1 the 7pt
// chain, 2 the 27pt chain (prog's (src, row, dk) must be that chain's), 3
// the Mehrstellen route (prog holds three terms whose weights are a, b and
// d); dtype: 0 float, 1 bf16 storage; compute: 0 float, 1 bf16 (prog's
// weights already in that dtype). u and out are (nx, ny, nz); bc is the
// Dirichlet value already rounded to the storage type. Returns a
// cudaError_t (0 on success); 1000 for bad arguments.
int heat3d_direct_launch(int halo, int spec, int dtype, int compute,
                         const void* u, void* out, int nx, int ny, int nz,
                         int xchunk, int periodic, float bc,
                         const Program* prog, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || xchunk < 1 || prog == nullptr ||
      prog->n < 1 || prog->n > MAX_TERMS ||
      (spec == SPEC_7PT && !matches<SPEC_7PT>(*prog)) ||
      (spec == SPEC_27PT && !matches<SPEC_27PT>(*prog)) ||
      (spec == SPEC_MEHR && prog->n != 3) ||
      (spec == SPEC_GENERIC && !foldable(*prog))) {
    return 1000;
  }
  const Launch f{u, out, nx, ny, nz, xchunk, periodic, bc, prog,
                 static_cast<cudaStream_t>(stream)};
  return with_instance(halo, spec, dtype, compute, 1000, f);
}

}  // extern "C"
