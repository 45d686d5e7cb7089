// Shared pieces of the port's stencil kernels: the tap-chain emission
// program, the storage <-> float conversions and the arithmetic policies.
// The compile-time instances unroll the chain (stencil_chain.cuh); the
// generic instances of the direct, stream and fused kernels fold the
// program at launch (stencil_chain.cuh GenericArgs).
//
// Arithmetic contract: the update is evaluated from an emission program
// (the wrapper records core.stencils.accumulate_taps into at most 27
// entries) with __fmul_rn/__fadd_rn in exactly that order, plane and row
// sums recomputed in the same operand order as the cached sums of the
// plain PyTorch version (ops.stencil_eager), so a kernel built on it with
// --fmad=false equals that version bitwise. Storage is float or bf16.
// Compute is float or bf16 (the JAX package's Precision.compute): under
// bf16 compute every field value is rounded to bf16 before it is used and
// every multiply and add is rounded to bf16, round to nearest even, as
// eager PyTorch rounds each bf16 operation; the values stay in float
// registers and shared memory, where bf16 values are exact. Every instance
// takes the rounding as a template policy (F32Math, Bf16Math).

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

// Arithmetic policies of the instances: the rounded add and
// multiply of the compute dtype, and a value of storage type T (a field
// value, or bc) as the update reads it. (Never an fma: a multiply and its
// add are two roundings.)
//
// Bf16Math holds every value as a float whose low 16 bits are zero: the
// bf16 value exactly, in the high half of the word. Such a word is the
// bf16x2 pair (value, +0), so one add.rn.bf16x2 / mul.rn.bf16x2 (sm_90)
// on the two words is the bf16 add or multiply, rounded once to nearest
// even from the exact result, with subnormals kept, and leaves +0 (+0 + +0,
// +0 * +0) in the low half: the word stays a bf16-valued float. That is
// the rounding of the plain version (eager PyTorch rounds each bf16 op's
// float result): float's 24 bits are at least 2 * 8 + 2, so a sum or a
// product of two bf16 values rounded to float and then to bf16 equals it
// rounded to bf16 once. The first design computed each op in float and
// rounded it with a conversion (cvt.rn.bf16.f32), which issues at a small
// fraction of the fp32 rate and doubled every two-update instance; the
// fp32-storage field values are rounded once, as their plane lands in
// shared memory (round_landed, stencil_chain.cuh), not at every read. The
// bound is the storage dtype's bytes, as in fp32 compute. Measured
// (chip_smoke.py compute_bf16_times on "NVIDIA H100 80GB HBM3, 700.00 W",
// 1024^3 fp32 storage 7pt, ms, the fp32-compute instance of the same call
// and the first design's time in brackets; bound 2.56): direct1 5.04
// [5.13, 6.55], direct2 5.18 [5.46, 11.92] (its two columns a thread as
// one bf16x2 word, stencil_direct.cuh PAIR), stream1 5.08 [5.03, 6.90],
// streamk K=4 14.47 [11.27, 24.89], the Mehrstellen instances (27pt) 5.02
// / 7.90 [4.62 / 6.46, 9.41 / 18.10].
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
#ifndef __CUDA_ARCH__
  // the bf16x2 op off the device (a syntax check or an emulation): each
  // half's exact result rounded once, as add.rn.bf16x2 / mul.rn.bf16x2
  template <class Op>
  __device__ __forceinline__ static float halves(float a, float b, Op op) {
    constexpr unsigned kHi = 0xffff0000u;
    const unsigned x = __float_as_uint(a), y = __float_as_uint(b);
    const unsigned hi = __float_as_uint(
        round(op(__uint_as_float(x & kHi), __uint_as_float(y & kHi))));
    const unsigned lo = __float_as_uint(
        round(op(__uint_as_float(x << 16), __uint_as_float(y << 16))));
    return __uint_as_float((hi & kHi) | (lo >> 16));
  }
#endif
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
#ifdef __CUDA_ARCH__
    unsigned r;
    asm("add.rn.bf16x2 %0, %1, %2;"
        : "=r"(r)
        : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
    return __uint_as_float(r);
#else
    return halves(a, b, [](float u, float v) { return u + v; });
#endif
  }
  __device__ __forceinline__ static float mul(float a, float b) {
#ifdef __CUDA_ARCH__
    unsigned r;
    asm("mul.rn.bf16x2 %0, %1, %2;"
        : "=r"(r)
        : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
    return __uint_as_float(r);
#else
    return halves(a, b, [](float u, float v) { return u * v; });
#endif
  }
};

}  // namespace
