// BC-fused direct-stencil kernels for Hopper (sm_90a): one explicit-Euler
// update (halo 1) or two fused updates (halo 2) of the UNPADDED field, with
// Dirichlet/periodic ghosts synthesized at load time.
//
// Replaces heat3d_tpu/ops/stencil_pallas_direct.py::apply_taps_direct
// (_direct_kernel) and ::apply_taps_direct2 (_direct2_kernel).
//
// Bound: device-memory bytes. One sweep reads the field once and writes it
// once (8 B/cell in fp32, 4 B/cell in bf16) for 13 (7pt) to ~33 (27pt,
// factored) flops per cell and update -- far below Hopper's ~20 flop/B
// fp32 balance point. Design against that bound:
//   * each thread block owns a (TY, TZ) tile of the (y, z) plane and marches
//     along x (one x-chunk per block), keeping a 3-slot ring of ghost-framed
//     planes in shared memory, so each input plane is read from device
//     memory once per sweep (the frame's halo comes from L2);
//   * z is the contiguous axis, so consecutive threads load consecutive z;
//   * the halo-2 kernel keeps a second ring of the one-ring-wide
//     intermediate planes, so two updates cost one read and one write of
//     the field: half the sweeps of two halo-1 launches. Neighbouring tiles
//     recompute their shared intermediate border (arithmetic, not traffic).
//
// Arithmetic contract: the emission program of stencil_common.cuh, so the
// kernel equals ops.stencil_eager bitwise. The halo-2 intermediate is
// rounded through the storage type and, under Dirichlet, pinned to bc
// wherever its global index lies outside the domain.
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "stencil_common.cuh"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// Load global plane gx into a ghost-framed (TY+2H, TZ+2H) float slot.
template <class T, int H>
__device__ void load_plane(float* dst, const T* __restrict__ u, int gx,
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
    direct1_kernel(const T* __restrict__ u, T* __restrict__ out, int nx,
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
    load_plane<T, 1>(ring + (i % 3) * PS, u, xs - 1 + i, y0, z0, nx, ny,
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
    direct2_kernel(const T* __restrict__ u, T* __restrict__ out, int nx,
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
    load_plane<T, 2>(ring_a + (i % 3) * PA, u, xs - 2 + i, y0, z0, nx, ny,
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

template <class T>
void launch(int halo, const void* u, void* out, int nx, int ny, int nz,
            int xchunk, int periodic, float bc, const Program& prog,
            cudaStream_t stream) {
  const dim3 block(BZ, BY);
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY,
                  (nx + xchunk - 1) / xchunk);
  if (halo == 1) {
    direct1_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, prog);
  } else {
    direct2_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(u), static_cast<T*>(out), nx, ny, nz, xchunk,
        periodic, bc, prog);
  }
}

}  // namespace

extern "C" {

// Tile extents, so the wrapper sizes its x-chunks from the same numbers.
int heat3d_direct_tile_y() { return TY; }
int heat3d_direct_tile_z() { return TZ; }

// halo: 1 (one update) or 2 (two fused updates); dtype: 0 float, 1 bf16.
// Returns a cudaError_t (0 on success); 1000 for bad arguments.
int heat3d_direct_launch(int halo, int dtype, const void* u, void* out,
                         int nx, int ny, int nz, int xchunk, int periodic,
                         float bc, const Program* prog, void* stream) {
  if ((halo != 1 && halo != 2) || (dtype != 0 && dtype != 1) || nx < 1 ||
      ny < 1 || nz < 1 || xchunk < 1 || prog == nullptr || prog->n < 1 ||
      prog->n > MAX_TERMS) {
    return 1000;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(halo, u, out, nx, ny, nz, xchunk, periodic, bc, *prog, s);
  } else {
    launch<__nv_bfloat16>(halo, u, out, nx, ny, nz, xchunk, periodic, bc,
                          *prog, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
