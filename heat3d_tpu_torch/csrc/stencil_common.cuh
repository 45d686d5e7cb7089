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
// --fmad=false equals that version bitwise. Storage is float or bf16;
// compute is float.

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

// Source plane value at frame offset o.
__device__ __forceinline__ float src_at(int src, const float* pm,
                                        const float* p0, const float* pp,
                                        int o) {
  switch (src) {
    case 0:
      return pm[o];
    case 1:
      return p0[o];
    case 2:
      return pp[o];
    default:
      return __fadd_rn(pm[o], pp[o]);
  }
}

// The update of the cell at frame (cy, cz) of planes (pm, p0, pp).
__device__ __forceinline__ float apply_program(const Program& p,
                                               const float* pm,
                                               const float* p0,
                                               const float* pp, int cy,
                                               int cz, int stride) {
  float acc = 0.0f;
  for (int i = 0; i < p.n; ++i) {
    const Term t = p.t[i];
    const int z = cz + t.dk;
    float v;
    if (t.row == 3) {
      v = __fadd_rn(src_at(t.src, pm, p0, pp, (cy - 1) * stride + z),
                    src_at(t.src, pm, p0, pp, (cy + 1) * stride + z));
    } else {
      v = src_at(t.src, pm, p0, pp, (cy + t.row - 1) * stride + z);
    }
    const float m = __fmul_rn(t.w, v);
    acc = i == 0 ? m : __fadd_rn(acc, m);
  }
  return acc;
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
