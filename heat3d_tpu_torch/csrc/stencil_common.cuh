// Shared pieces of the port's stencil kernels: the tap-chain emission
// program, its evaluator, the storage <-> float conversions and the (y, z)
// tile geometry of the interpreted kernels. The program evaluator runs in
// the generic instances of stencil_direct.cu and stencil_stream.cu (chains
// outside the CHAINS table) and in stencil_fused.cu; the compile-time
// instances unroll the chain instead (stencil_chain.cuh).
//
// Arithmetic contract: the update is evaluated from an emission program
// (the wrapper records core.stencils.accumulate_taps into at most 27
// entries) with __fmul_rn/__fadd_rn in exactly that order, plane and row
// sums recomputed in the same operand order as the cached sums of the
// plain PyTorch version (ops.stencil_eager), so a kernel built on it with
// --fmad=false equals that version bitwise. Storage is float or bf16.
// Compute is float or bf16 (the JAX package's Precision.compute): under
// bf16 compute every field value is rounded to bf16 as it is read and
// every multiply and add is rounded to bf16, round to nearest even, as
// eager PyTorch rounds each bf16 operation; the values stay in float
// registers and shared memory, where bf16 values are exact. The
// compile-time instances take the rounding as a policy (F32Math,
// Bf16Math); the interpreted evaluator picks the policy per cell from
// Program::bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_TERMS = 27;

// One chain entry: src 0/1/2 = plane x-1/x/x+1, 3 = (x-1) + (x+1);
// row 0/1/2 = y-1/y/y+1 of that source, 3 = (y-1) + (y+1); dk in -1..1.
// Outside any anonymous namespace: the exported launchers take a Program,
// and a function whose type names an internal-linkage type is itself
// internal, so its symbol would not be exported.
struct Term {
  int src;
  int row;
  int dk;
  float w;
};

struct Program {
  int n;
  int bf16;  // 1: bf16 compute (the library sets it from the compute code)
  Term t[MAX_TERMS];
};

namespace {

constexpr int TY = 16;       // tile rows (y)
constexpr int TZ = 64;       // tile columns (z, contiguous)
constexpr int BZ = 64;       // blockDim.x
constexpr int BY = 4;        // blockDim.y
constexpr int NTHREADS = BZ * BY;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Arithmetic policies of the compile-time instances: the rounded add and
// multiply of the compute dtype, and a value of storage type T (a field
// value, or bc) as the update reads it. Bf16Math rounds the float result
// once more to bf16: float's 24 bits are at least 2 * 8 + 2, so rounding a
// sum or a product of two bf16 values to float and then to bf16 equals
// rounding it to bf16 once. (Never an fma: a multiply and its add are two
// roundings.)
struct F32Math {
  template <class T>
  __device__ __forceinline__ static float read(float v) {
    return v;
  }
  __device__ __forceinline__ static float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ static float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};

struct Bf16Math {
  __device__ __forceinline__ static float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
  // bf16 storage holds bf16 values already
  template <class T>
  __device__ __forceinline__ static float read(float v) {
    if constexpr (sizeof(T) == 4) {
      return round(v);
    } else {
      return v;
    }
  }
  __device__ __forceinline__ static float add(float a, float b) {
    return round(__fadd_rn(a, b));
  }
  __device__ __forceinline__ static float mul(float a, float b) {
    return round(__fmul_rn(a, b));
  }
};

// Source plane value at frame offset o, read as policy M reads a float
// field value (the interpreted kernels' planes are float copies).
template <class M>
__device__ __forceinline__ float src_at(int src, const float* pm,
                                        const float* p0, const float* pp,
                                        int o) {
  switch (src) {
    case 0:
      return M::template read<float>(pm[o]);
    case 1:
      return M::template read<float>(p0[o]);
    case 2:
      return M::template read<float>(pp[o]);
    default:
      return M::add(M::template read<float>(pm[o]),
                    M::template read<float>(pp[o]));
  }
}

template <class M>
__device__ __forceinline__ float eval_program(const Program& p,
                                              const float* pm,
                                              const float* p0,
                                              const float* pp, int cy, int cz,
                                              int stride) {
  float acc = 0.0f;
  for (int i = 0; i < p.n; ++i) {
    const Term t = p.t[i];
    const int z = cz + t.dk;
    float v;
    if (t.row == 3) {
      v = M::add(src_at<M>(t.src, pm, p0, pp, (cy - 1) * stride + z),
                 src_at<M>(t.src, pm, p0, pp, (cy + 1) * stride + z));
    } else {
      v = src_at<M>(t.src, pm, p0, pp, (cy + t.row - 1) * stride + z);
    }
    const float m = M::mul(t.w, v);
    acc = i == 0 ? m : M::add(acc, m);
  }
  return acc;
}

// The update of the cell at frame (cy, cz) of planes (pm, p0, pp), in the
// program's compute dtype (one branch a cell, uniform across the launch).
__device__ __forceinline__ float apply_program(const Program& p,
                                               const float* pm,
                                               const float* p0,
                                               const float* pp, int cy,
                                               int cz, int stride) {
  return p.bf16 ? eval_program<Bf16Math>(p, pm, p0, pp, cy, cz, stride)
                : eval_program<F32Math>(p, pm, p0, pp, cy, cz, stride);
}

__device__ __forceinline__ void copy_program(Program* dst,
                                             const Program& src) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  constexpr int WORDS = sizeof(Program) / sizeof(int);
  static_assert(WORDS <= NTHREADS, "program copy needs one word a thread");
  if (tid < WORDS) {
    reinterpret_cast<int*>(dst)[tid] =
        reinterpret_cast<const int*>(&src)[tid];
  }
}

}  // namespace
