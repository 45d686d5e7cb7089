// Shared pieces of the port's in-kernel signalling (halo_dma.cu,
// stencil_fused.cu): system-scope release stores and acquire loads of
// 64-bit flag words, the globaltimer, and the bounded spin that turns a
// protocol fault into a trap instead of a hang.
//
// A flag word holds the epoch of the last exchange that signalled it; a
// waiter acquire-spins until it reaches the epoch it is owed. Past
// timeout_ns of globaltimer the waiter writes its code into the error word
// (mapped host memory, readable after the fault) and traps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= epoch; past timeout_ns (counted from t0) write code
// into *err and trap.
__device__ __forceinline__ void spin_until(const unsigned long long* flag,
                                           unsigned long long epoch,
                                           unsigned long long t0,
                                           long long timeout_ns,
                                           unsigned int code,
                                           unsigned int* err) {
  while (load_acquire_sys(flag) < epoch) {
    if ((long long)(globaltimer_ns() - t0) > timeout_ns) {
      *reinterpret_cast<volatile unsigned int*>(err) = code;
      __threadfence_system();
      __trap();
    }
    __nanosleep(128);
  }
}

}  // namespace

// The error word of one library: mapped, portable host memory, allocated
// once (each library that includes this header has its own).
static unsigned int* g_err_host = nullptr;
static unsigned int* g_err_dev = nullptr;

// Allocate the error word. Returns a cudaError_t (0 on success).
static int alloc_error_word() {
  if (g_err_host != nullptr) return 0;
  unsigned int* host = nullptr;
  cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&host),
                                  sizeof(unsigned int),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  *host = 0u;
  unsigned int* dev = nullptr;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev), host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return static_cast<int>(err);
  }
  g_err_host = host;
  g_err_dev = dev;
  return 0;
}

// 0, or the code of the first wait that timed out.
static unsigned int read_error_word() {
  return g_err_host == nullptr
             ? 0u
             : *reinterpret_cast<volatile unsigned int*>(g_err_host);
}
