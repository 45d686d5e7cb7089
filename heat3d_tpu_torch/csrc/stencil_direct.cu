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
//     plane is fresh (z along the warp's lanes by shuffles, y through a
//     float z131 slot per level), and carried to the outputs that read it
//     (in registers; at H = 2 the level-1 q planes in two float planes of
//     shared memory, each thread at its own positions); an output is
//     (a u0 + b ((q[x-1] + q[x+1]) + 3 q[x])) + d psum, 19 fp32 ops a cell
//     and update. At H = 2 the level-1 q comes from the rounded, pinned
//     intermediate, as the second update would read it. These instances
//     carry more registers than the chains: fp32 and H = 2 run three
//     blocks an SM (80 registers, no spills), bf16 H = 1 four. M is the
//     arithmetic policy (stencil_common.cuh): F32Math, or Bf16Math for
//     bf16 compute (each read of a float field and each multiply and add
//     rounded to bf16), an instance of its own for each chain and the
//     Mehrstellen route;
//   * direct1_generic / direct2_generic<T>: any other chain (other taps,
//     HEAT3D_FACTOR_7PT=1, HEAT3D_FACTOR_Y=0), interpreted per cell from the
//     Program in shared memory (stencil_common.cuh) over 3-slot float rings
//     of ghost-framed planes loaded synchronously: the first design. The
//     compute dtype rides in the program (Program::bf16).
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
// 2.56: direct1 5.16 (5 blocks per SM, 46 registers), direct2 5.42 (4
// blocks, 60 registers), no spills; 27pt 4.96 / 8.95, 7pt bf16 4.13 / 7.26
// (bound 1.28); the Mehrstellen instances 4.61 / 8.47 fp32 (27pt chain of
// the same call 4.90 / 8.92) and 5.70 / 10.60 bf16 (5.78 / 10.47). The
// first design, now the generic instance, took 10.64 / 20.66. direct2
// still trails streamk K=2 (4.69), the same sweep on a padded block: the
// loader's ghost logic and 64 registers are suspects, not measured. In bf16
// compute (chip_smoke.py compute_bf16_times, same card, the fp32-compute
// instance of the same call in brackets): 7pt fp32 storage 6.55 [5.05] /
// 11.93 [5.42], bf16 storage 5.67 [4.08] / 11.12 [7.09], Mehrstellen 9.37
// [4.58] / 17.80 [8.24], with the same blocks per SM and registers: each
// rounding to bf16 is a conversion and a shift beside every fp32 op.
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "stencil_direct.cuh"

namespace {

constexpr int MAX_H = 2;

// Blocks per SM the launch bounds set the register budget for: four (64
// registers) for the chains and the bf16 one-update Mehrstellen instance;
// three (80) for the fp32 one-update and both two-update Mehrstellen
// instances, which carry q planes beside the chain's registers (at 64
// they spill; scripts/torch_direct_probe.py, PERF.md section 6).
template <class T, int H, int S>
struct Bounds {
  static constexpr int min_blocks =
      S == SPEC_MEHR && (H == 2 || sizeof(T) == 4) ? 3 : MIN_BLOCKS;
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
  using G = Geom<H>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Direct<T, H, S, M, FieldPlanes<T>> st;
  st.src = FieldPlanes<T>{u, (int64_t)ny * nz, nx, periodic};
  st.out = out;
  st.in_slot = reinterpret_cast<T*>(smem_raw);
  st.lvl = st.in_slot + in_slots<T, H, S>() * G::FH * in_stride<T, H>();
  st.xsp = reinterpret_cast<float*>(st.lvl + (H - 1) * G::FH * G::FW);
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
// Generic instances: the interpreted emission program (stencil_common.cuh)
// over 3-slot float rings, (TY, TZ) tiles of stencil_common.cuh.

// Load global plane gx into a ghost-framed (TY+2H, TZ+2H) float slot.
template <class T, int H>
__device__ void load_framed(float* dst, const T* __restrict__ u, int gx,
                            int y0, int z0, int nx, int ny, int nz,
                            bool periodic, float bc) {
  constexpr int FY = TY + 2 * H;
  constexpr int FZ = TZ + 2 * H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const bool x_in = gx >= 0 && gx < nx;
  const int x = periodic ? wrap(gx, nx) : gx;
  for (int idx = tid; idx < FY * FZ; idx += NTHREADS) {
    const int a = idx / FZ;
    const int b = idx - a * FZ;
    const int gy = y0 - H + a;
    const int gz = z0 - H + b;
    float v;
    if (periodic) {
      v = to_f(u[((int64_t)x * ny + wrap(gy, ny)) * nz + wrap(gz, nz)]);
    } else if (x_in && gy >= 0 && gy < ny && gz >= 0 && gz < nz) {
      v = to_f(u[((int64_t)x * ny + gy) * nz + gz]);
    } else {
      v = bc;
    }
    dst[idx] = v;
  }
}

template <class T>
__global__ void __launch_bounds__(NTHREADS)
    direct1_generic(const T* __restrict__ u, T* __restrict__ out, int nx,
                    int ny, int nz, int xchunk, int periodic, float bc,
                    Program prog) {
  constexpr int FZ = TZ + 2;
  constexpr int PS = (TY + 2) * FZ;
  __shared__ float ring[3 * PS];
  __shared__ Program sp;
  copy_program(&sp, prog);
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int xs = blockIdx.z * xchunk;
  const int xe = min(nx, xs + xchunk);
  // planes xs-1 .. xe: slot i%3 holds plane xs-1+i; output plane xs+i-2
  for (int i = 0; i < xe - xs + 2; ++i) {
    load_framed<T, 1>(ring + (i % 3) * PS, u, xs - 1 + i, y0, z0, nx, ny,
                      nz, periodic, bc);
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

template <class T>
__global__ void __launch_bounds__(NTHREADS)
    direct2_generic(const T* __restrict__ u, T* __restrict__ out, int nx,
                    int ny, int nz, int xchunk, int periodic, float bc,
                    Program prog) {
  constexpr int FAZ = TZ + 4;
  constexpr int PA = (TY + 4) * FAZ;
  constexpr int FBZ = TZ + 2;
  constexpr int PB = (TY + 2) * FBZ;
  __shared__ float ring_a[3 * PA];  // input planes, two-cell frame
  __shared__ float ring_b[3 * PB];  // intermediate planes, one-cell frame
  __shared__ Program sp;
  copy_program(&sp, prog);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int xs = blockIdx.z * xchunk;
  const int xe = min(nx, xs + xchunk);
  // slot i%3 of ring_a holds input plane xs-2+i; from i >= 2 intermediate
  // plane j = i-2 (global xs-1+j) goes to slot j%3 of ring_b; from i >= 4
  // output plane xs+i-4 is emitted from intermediates i-4 .. i-2.
  for (int i = 0; i < xe - xs + 4; ++i) {
    load_framed<T, 2>(ring_a + (i % 3) * PA, u, xs - 2 + i, y0, z0, nx, ny,
                      nz, periodic, bc);
    __syncthreads();
    if (i >= 2) {
      const float* pm = ring_a + ((i - 2) % 3) * PA;
      const float* p0 = ring_a + ((i - 1) % 3) * PA;
      const float* pp = ring_a + (i % 3) * PA;
      float* dst = ring_b + ((i - 2) % 3) * PB;
      const int gm = xs - 3 + i;
      const bool x_ghost = gm < 0 || gm >= nx;
      for (int idx = tid; idx < PB; idx += NTHREADS) {
        const int a = idx / FBZ;
        const int b = idx - a * FBZ;
        const int gy = y0 - 1 + a;
        const int gz = z0 - 1 + b;
        float v;
        if (!periodic &&
            (x_ghost || gy < 0 || gy >= ny || gz < 0 || gz >= nz)) {
          v = bc;
        } else {
          v = to_f(from_f<T>(
              apply_program(sp, pm, p0, pp, a + 1, b + 1, FAZ)));
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
        if (gy < ny && gz < nz) {
          const float r =
              apply_program(sp, pm, p0, pp, ty + 1, threadIdx.x + 1, FBZ);
          out[(ox * ny + gy) * nz + gz] = from_f<T>(r);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// One instance: its kernel, dynamic shared memory, tile and launch.
template <class T, int H, int S, class M>
struct Spec {
  static constexpr int bytes = smem_bytes<T, H, S>();
  static constexpr int ty = Geom<H>::TY;
  static constexpr int tz = Geom<H>::TZ;
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

template <class T, int H>
struct Generic {
  static constexpr int bytes = 0;
  static constexpr int ty = TY;
  static constexpr int tz = TZ;
  static dim3 block() { return dim3(BZ, BY); }
  static void* fn() {
    if constexpr (H == 1) {
      return (void*)direct1_generic<T>;
    } else {
      return (void*)direct2_generic<T>;
    }
  }
  static cudaError_t prepare() { return cudaSuccess; }
  static cudaError_t launch(dim3 grid, const void* u, void* out, int nx,
                            int ny, int nz, int xchunk, int periodic,
                            float bc, const Program& prog,
                            cudaStream_t stream) {
    if constexpr (H == 1) {
      direct1_generic<T><<<grid, block(), 0, stream>>>(
          static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
          periodic, bc, prog);
    } else {
      direct2_generic<T><<<grid, block(), 0, stream>>>(
          static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
          periodic, bc, prog);
    }
    return cudaGetLastError();
  }
};

// f.template run<Instance>() for instance (halo, spec, dtype, compute);
// `bad` for arguments no instance takes. The generic instance serves both
// compute dtypes (Program::bf16).
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
      return f.template run<Generic<T, H>>();
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
// weights already in that dtype; prog->bf16 is set from it). u and out
// are (nx, ny, nz); bc is the Dirichlet value already rounded to the
// storage type. Returns a cudaError_t (0 on success); 1000 for bad
// arguments.
int heat3d_direct_launch(int halo, int spec, int dtype, int compute,
                         const void* u, void* out, int nx, int ny, int nz,
                         int xchunk, int periodic, float bc,
                         const Program* prog, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || xchunk < 1 || prog == nullptr ||
      prog->n < 1 || prog->n > MAX_TERMS ||
      (spec == SPEC_7PT && !matches<SPEC_7PT>(*prog)) ||
      (spec == SPEC_27PT && !matches<SPEC_27PT>(*prog)) ||
      (spec == SPEC_MEHR && prog->n != 3)) {
    return 1000;
  }
  Program p = *prog;
  p.bf16 = compute == 1;
  const Launch f{u, out, nx, ny, nz, xchunk, periodic, bc, &p,
                 static_cast<cudaStream_t>(stream)};
  return with_instance(halo, spec, dtype, compute, 1000, f);
}

}  // extern "C"
