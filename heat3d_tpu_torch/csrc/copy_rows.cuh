// Copies of contiguous element runs by a group of threads (a warp, a block,
// or one thread), in the widest vectors the source's and destination's
// alignment allow: the DMA halo pushes (halo_dma.cu) and the fused kernels'
// face pushes (stencil_fused.cu). B is the element's bits (uint32_t for
// float, uint16_t for bf16); a fill writes the bc bits instead of copying.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <class B>
__device__ __forceinline__ B bits_as(unsigned int b) {
  return static_cast<B>(b);
}
template <>
__device__ __forceinline__ uint2 bits_as<uint2>(unsigned int b) {
  return make_uint2(b, b);
}
template <>
__device__ __forceinline__ uint4 bits_as<uint4>(unsigned int b) {
  return make_uint4(b, b, b, b);
}

// Row [0, len) of d from s (or the bc bits), lanes lane, lane + nl, ..., in
// vectors V from the first element where d is V-aligned; s must share d's
// alignment modulo sizeof(V). `word` is the bc bits replicated to 32 bits.
template <class B, class V>
__device__ __forceinline__ void copy_as(B* d, const B* s, int len, int lane,
                                        int nl, bool fill, B bc,
                                        unsigned int word) {
  constexpr int K = sizeof(V) / sizeof(B);
  const int mis = (int)(reinterpret_cast<uintptr_t>(d) & (sizeof(V) - 1));
  const int head = min(len, (int)((sizeof(V) - mis) & (sizeof(V) - 1)) /
                                (int)sizeof(B));
  const int nv = (len - head) / K;
  const int tail = head + nv * K;
  V* dv = reinterpret_cast<V*>(d + head);
  if (fill) {
    const V bv = bits_as<V>(word);
    for (int i = lane; i < head; i += nl) d[i] = bc;
    for (int i = lane; i < nv; i += nl) dv[i] = bv;
    for (int i = tail + lane; i < len; i += nl) d[i] = bc;
  } else {
    const V* sv = reinterpret_cast<const V*>(s + head);
    for (int i = lane; i < head; i += nl) d[i] = s[i];
    for (int i = lane; i < nv; i += nl) dv[i] = sv[i];
    for (int i = tail + lane; i < len; i += nl) d[i] = s[i];
  }
}

// Run [0, len) of d from s (or the bc bits), by lanes lane, lane + nl, ...
template <class B>
__device__ __forceinline__ void copy_row(B* d, const B* s, int len, int lane,
                                         int nl, bool fill, B bc,
                                         unsigned int word) {
  // the vector width both rows allow (a fill: the destination's alone)
  const uintptr_t x = fill ? 0 : reinterpret_cast<uintptr_t>(d) ^
                                     reinterpret_cast<uintptr_t>(s);
  if ((x & 15) == 0) {
    copy_as<B, uint4>(d, s, len, lane, nl, fill, bc, word);
  } else if ((x & 7) == 0) {
    copy_as<B, uint2>(d, s, len, lane, nl, fill, bc, word);
  } else if ((x & 3) == 0) {
    copy_as<B, uint32_t>(d, s, len, lane, nl, fill, bc, word);
  } else {
    copy_as<B, B>(d, s, len, lane, nl, fill, bc, word);
  }
}

}  // namespace
