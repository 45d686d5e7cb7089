// The compile-time tap chains of the port's specialised stencil kernels
// (stencil_stream.cu, stencil_direct.cu) and what their sweeps share: the
// 32 x 8 thread geometry that owns a frame of positions, the shared memory
// of an instance, cp.async, the views of a slot and the unrolled chain.
//
// A chain is one of the emission programs of the wrapper's table
// (ops/stencil_stream.py CHAINS), which the build passes to nvcc as
// HEAT3D_CHAIN_7PT / HEAT3D_CHAIN_27PT: three digits a term, src, row and
// dk + 1, in emission order. A term is one or two shared loads at
// immediate offsets, a rounded multiply and a rounded add of the
// arithmetic policy M (stencil_common.cuh: F32Math, __fmul_rn and
// __fadd_rn, built with --fmad=false; Bf16Math, each rounded on to bf16),
// so an instance equals the plain version (ops.stencil_eager) bitwise.

#pragma once

#include <atomic>
#include <utility>

#include "stencil_common.cuh"

#if !defined(HEAT3D_CHAIN_7PT) || !defined(HEAT3D_CHAIN_27PT)
#error "build with the chain table of ops/stencil_stream.py (ops/_build.py passes it)"
#endif

namespace {

// ---------------------------------------------------------------------------
// Compile-time tap chains: three digits a term in emission order, src, row
// and dk + 1.

constexpr int kLen7 = (sizeof(HEAT3D_CHAIN_7PT) - 1) / 3;
constexpr int kLen27 = (sizeof(HEAT3D_CHAIN_27PT) - 1) / 3;

constexpr int SPEC_GENERIC = 0;
constexpr int SPEC_7PT = 1;
constexpr int SPEC_27PT = 2;
// The Mehrstellen q-ring route of the direct kernels (stencil_direct.cuh):
// no tap chain, the coefficients (a, b, d) of a*delta + b*S + d*F as the
// first three weights.
constexpr int SPEC_MEHR = 3;

template <int S>
__host__ __device__ constexpr int chain_len() {
  static_assert(S == SPEC_7PT || S == SPEC_27PT, "spec S has no tap chain");
  return S == SPEC_7PT ? kLen7 : kLen27;
}

// Field f (0 src, 1 row, 2 dk) of term i of chain S.
template <int S>
__host__ __device__ constexpr int tap(int i, int f) {
  static_assert(S == SPEC_7PT || S == SPEC_27PT, "spec S has no tap chain");
  return (S == SPEC_7PT ? HEAT3D_CHAIN_7PT[3 * i + f]
                        : HEAT3D_CHAIN_27PT[3 * i + f]) -
         '0' - (f == 2 ? 1 : 0);
}

template <int S>
__host__ __device__ constexpr bool uses_xsum() {
  if constexpr (S == SPEC_MEHR) {
    return false;
  } else {
    for (int i = 0; i < chain_len<S>(); ++i) {
      if (tap<S>(i, 0) == 3) return true;
    }
    return false;
  }
}

// A float slot beside the input slots: the 27pt chain's x-sum plane, the
// Mehrstellen route's z131 plane.
template <int S>
__host__ __device__ constexpr bool uses_fslot() {
  return S == SPEC_MEHR || uses_xsum<S>();
}

// The planes x-1 and x+1 are read at the cell itself only: the design
// keeps them in registers. (The Mehrstellen route reads them, and their
// q planes, at the cell only.)
template <int S>
__host__ __device__ constexpr bool centre_x_only() {
  if constexpr (S == SPEC_MEHR) {
    return true;
  } else {
    for (int i = 0; i < chain_len<S>(); ++i) {
      const int s = tap<S>(i, 0);
      if ((s == 0 || s == 2) && (tap<S>(i, 1) != 1 || tap<S>(i, 2) != 0)) {
        return false;
      }
    }
    return chain_len<S>() >= 1 && chain_len<S>() <= MAX_TERMS;
  }
}

struct Weights {
  float w[MAX_TERMS];
};

// ---------------------------------------------------------------------------
// Geometry of the specialised instances.

constexpr int SBZ = 32;  // blockDim.x: lanes along z
constexpr int SBY = 8;   // blockDim.y: warps along y
constexpr int SNT = SBZ * SBY;
constexpr int MIN_BLOCKS = 4;  // launch bounds: <= 64 registers a thread

template <int K>
struct Geom {
  static constexpr int LA = K == 1 ? 5 : 4;  // frame rows a thread owns
  static constexpr int MB = 2;               // frame columns a thread owns
  static constexpr int P = LA * MB;
  static constexpr int FH = SBY * LA;  // frame rows (y)
  static constexpr int FW = SBZ * MB;  // frame columns (z, contiguous)
  static constexpr int TY = FH - 2 * K;
  static constexpr int TZ = FW - 2 * K;
};

// Row stride of an input slot: bf16 rows hold one element more in front
// (the parity shift of the aligned pair copies) and stay an even length.
template <class T, int K>
__host__ __device__ constexpr int in_stride() {
  return Geom<K>::FW + (sizeof(T) == 2 ? 2 : 0);
}

// Float planes of shared memory beside the chain's slots: at K = 2 the
// Mehrstellen route's second z131 slot (level 1's, so its z131 never waits
// for level 0's readers) and the level-1 q planes of the two planes before
// the fresh one (level 0's ride in registers).
template <int K, int S>
__host__ __device__ constexpr int q_planes() {
  return S == SPEC_MEHR ? 3 * (K - 1) : 0;
}

// Shared memory of an instance with `slots` input slots.
template <class T, int K, int S>
__host__ __device__ constexpr int smem_with(int slots) {
  using G = Geom<K>;
  return slots * G::FH * in_stride<T, K>() * (int)sizeof(T) +
         (K - 1) * G::FH * G::FW * (int)sizeof(T) +
         (uses_fslot<S>() ? G::FH * G::FW * (int)sizeof(float) : 0) +
         q_planes<K, S>() * G::FH * G::FW * (int)sizeof(float);
}

// Input slots: planes i-1 and i under use and planes i+1 (and i+2) in
// flight. The second plane ahead is taken where four blocks still fit an
// SM (56 KB each); fp32 K=4 27pt keeps one.
template <class T, int K, int S>
__host__ __device__ constexpr int in_slots() {
  return smem_with<T, K, S>(4) <= 56 * 1024 ? 4 : 3;
}

template <class T, int K, int S>
__host__ __device__ constexpr int smem_bytes() {
  return smem_with<T, K, S>(in_slots<T, K, S>());
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async, sm_80+).

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// A plane of a slot as this thread reads it: element (ty + 8 l + da,
// tx + 32 m + db) of the frame. SHIFT: a bf16 input slot, whose rows next
// to the thread's rows sit `nb` elements further on. M: the input slots'
// field values are read as policy M reads them (rounded to bf16 from float
// storage under bf16 compute); the other slots hold values the update made.
template <class T, int SW, bool SHIFT, class M = F32Math>
struct View {
  const T* c;
  int nb;
  __device__ __forceinline__ float at(int l, int m, int da, int db) const {
    int o = (SBY * l + da) * SW + SBZ * m + db;
    if constexpr (SHIFT) {
      if (da != 0) o += nb;
    }
    return M::template read<T>(to_f(c[o]));
  }
};

// One cell of a stage: the x-neighbours pm and pp (registers), the planes
// p0 and xs (shared) around position (l, m).
template <class V0, class VX>
struct Cell {
  float pm, pp;
  V0 p0;
  VX xs;
  int l, m;
  template <int SRC>
  __device__ __forceinline__ float get(int da, int db) const {
    if constexpr (SRC == 1) {
      return p0.at(l, m, da, db);
    } else {
      return xs.at(l, m, da, db);
    }
  }
};

// Term I of chain S under the arithmetic policy M (weights already in
// the compute dtype).
template <int S, class M, int I, class C>
__device__ __forceinline__ void emit(float& acc, const Weights& w,
                                     const C& c) {
  constexpr int src = tap<S>(I, 0);
  constexpr int row = tap<S>(I, 1);
  constexpr int dk = tap<S>(I, 2);
  float v;
  if constexpr (src == 0) {
    v = c.pm;
  } else if constexpr (src == 2) {
    v = c.pp;
  } else if constexpr (row == 3) {
    v = M::add(c.template get<src>(-1, dk), c.template get<src>(1, dk));
  } else {
    v = c.template get<src>(row - 1, dk);
  }
  const float t = M::mul(w.w[I], v);
  if constexpr (I == 0) {
    acc = t;
  } else {
    acc = M::add(acc, t);
  }
}

template <int S, class M, class C, int... I>
__device__ __forceinline__ float chain_impl(const Weights& w, const C& c,
                                            std::integer_sequence<int, I...>) {
  float acc = 0.0f;
  (emit<S, M, I>(acc, w, c), ...);
  return acc;
}

template <int S, class M, class C>
__device__ __forceinline__ float chain(const Weights& w, const C& c) {
  return chain_impl<S, M>(w, c,
                          std::make_integer_sequence<int, chain_len<S>()>{});
}

// ---------------------------------------------------------------------------
// Host side.

constexpr int MAX_DEVICES = 64;

// Raise an instance's dynamic shared memory limit once per device.
template <class F>
cudaError_t set_smem_once(std::atomic<unsigned long long>& done, F* kernel,
                          int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % MAX_DEVICES);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The program's (src, row, dk) sequence is chain S's.
template <int S>
bool matches(const Program& prog) {
  if (prog.n != chain_len<S>()) return false;
  for (int i = 0; i < prog.n; ++i) {
    if (prog.t[i].src != tap<S>(i, 0) || prog.t[i].row != tap<S>(i, 1) ||
        prog.t[i].dk != tap<S>(i, 2)) {
      return false;
    }
  }
  return true;
}

}  // namespace
