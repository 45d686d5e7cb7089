// Exchange-path stencil kernels for Hopper (sm_90a): a ghost-padded field
// in (the halo exchange wrote the ghosts), its interior after one update
// (stream1_kernel) or after K = 2..4 fused updates (streamk_kernel) out.
//
// Replaces heat3d_tpu/ops/stencil_pallas.py:
//   * ::apply_taps_pallas_stream (_stream_kernel) and its dispatcher
//     ::apply_taps_pallas -> stream1_kernel. The dispatcher's windowed
//     _stencil_kernel exists because a TPU plane ring can overflow VMEM; a
//     (y, z)-tiled kernel has no such limit, so one kernel covers both;
//   * ::apply_taps_pallas_streamk (_streamk_kernel) and its two-stage form
//     ::apply_taps_pallas_stream2 (_stream2_kernel) -> streamk_kernel<T, K>.
//
// Bound: device-memory bytes. A launch reads the width-K padded field once
// and writes the interior once; the K updates cost 13 (7pt) to ~33 (27pt,
// factored) flops per cell each, plus the recompute of the shrinking ghost
// rings -- still below Hopper's fp32 balance point of ~20 flop/B. Design:
//   * as in stencil_direct.cu, each block owns a (TY, TZ) tile of (y, z)
//     and marches one x-chunk, with a 3-slot ring of framed planes in
//     shared memory, so each padded plane is read from device memory once;
//   * streamk keeps K rings: the input ring framed by K cells and, for each
//     stage j < K, a ring of its planes framed by r = K - j cells. Stage
//     j's plane at padded x p is computed from stage j-1's planes p-1, p,
//     p+1 (the slot scheme of _streamk_kernel: plane p in slot p % 3, stage
//     j emitting plane i - j at the step that loads input plane i), so the
//     K updates cost one read and one write of the field. Each block
//     recomputes its own trapezoid of ghost rings: arithmetic, not traffic.
//   * The rings need ~30.6 KB (K=2), ~49 KB (K=3) and ~70 KB (K=4) of
//     float shared memory, so streamk uses dynamic shared memory with the
//     limit raised by cudaFuncSetAttribute.
//
// Semantics: before a stage other than the last writes its plane, the
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
// so the ring cells are genuine wrapped values. The arithmetic is the emission
// program of stencil_common.cuh, so both kernels equal ops.stencil_eager
// (one apply_taps_padded per update) bitwise.
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "stencil_common.cuh"

namespace {

constexpr int MAX_K = 4;

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
    stream1_kernel(const T* __restrict__ up, T* __restrict__ out, int nx,
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
    streamk_kernel(const T* __restrict__ up, T* __restrict__ out, int nx,
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

template <class T, int K>
cudaError_t launch_k(dim3 grid, dim3 block, const void* up, void* out,
                     int nx, int ny, int nz, int xchunk, int periodic,
                     float bc, int edges, const Program& prog,
                     cudaStream_t stream) {
  constexpr int bytes = ring_offset(K, 0) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      streamk_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  streamk_kernel<T, K><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz, xchunk,
      periodic, bc, edges, prog);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch(int k, const void* up, void* out, int nx, int ny, int nz,
                   int xchunk, int periodic, float bc, int edges,
                   const Program& prog, cudaStream_t stream) {
  const dim3 block(BZ, BY);
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY,
                  (nx + xchunk - 1) / xchunk);
  switch (k) {
    case 1:
      stream1_kernel<T><<<grid, block, 0, stream>>>(
          static_cast<const T*>(up), static_cast<T*>(out), nx, ny, nz,
          xchunk, prog);
      return cudaGetLastError();
    case 2:
      return launch_k<T, 2>(grid, block, up, out, nx, ny, nz, xchunk,
                            periodic, bc, edges, prog, stream);
    case 3:
      return launch_k<T, 3>(grid, block, up, out, nx, ny, nz, xchunk,
                            periodic, bc, edges, prog, stream);
    default:
      return launch_k<T, MAX_K>(grid, block, up, out, nx, ny, nz, xchunk,
                                periodic, bc, edges, prog, stream);
  }
}

}  // namespace

extern "C" {

// Tile extents, so the wrapper sizes its x-chunks from the same numbers.
int heat3d_stream_tile_y() { return TY; }
int heat3d_stream_tile_z() { return TZ; }

// Dynamic shared memory of one streamk block (bytes), for k = 2..4.
int heat3d_streamk_smem_bytes(int k) {
  return k == 2   ? ring_offset(2, 0) * (int)sizeof(float)
         : k == 3 ? ring_offset(3, 0) * (int)sizeof(float)
         : k == 4 ? ring_offset(4, 0) * (int)sizeof(float)
                  : 0;
}

// k: 1 (stream1_kernel) or 2..4 (streamk_kernel); dtype: 0 float, 1 bf16.
// up is the (nx+2k, ny+2k, nz+2k) padded field, out the (nx, ny, nz)
// interior; periodic, bc and the domain-face mask edges (bit 0 x_lo ..
// bit 5 z_hi; 63 for a whole-domain block) are read for k >= 2 only.
// Returns a cudaError_t (0 on success); 1000 for bad arguments.
int heat3d_stream_launch(int k, int dtype, const void* up, void* out, int nx,
                         int ny, int nz, int xchunk, int periodic, float bc,
                         int edges, const Program* prog, void* stream) {
  if (k < 1 || k > MAX_K || (dtype != 0 && dtype != 1) || nx < 1 ||
      ny < 1 || nz < 1 || xchunk < 1 || prog == nullptr || prog->n < 1 ||
      prog->n > MAX_TERMS) {
    return 1000;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(k, up, out, nx, ny, nz, xchunk, periodic,
                                 bc, edges, *prog, s)
                 : launch<__nv_bfloat16>(k, up, out, nx, ny, nz, xchunk,
                                         periodic, bc, edges, *prog, s);
  return static_cast<int>(err);
}

}  // extern "C"
