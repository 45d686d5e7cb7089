// The kernel tier's seeded hazard: a one-block kernel that reads shared
// memory another warp wrote, with no __syncthreads() between the write and
// the read. racecheck must flag it; a tier that flags nothing proves
// nothing (the counterpart of the JAX kernel tier's blindness proof).
// Never launched by the solver.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void seeded_race_kernel(float* out) {
  __shared__ float ring[kThreads];
  const int i = threadIdx.x;
  ring[i] = static_cast<float>(i);
  // the seeded fault: the barrier that belongs here is missing
  out[i] = ring[(i + 32) % kThreads];
}

}  // namespace

extern "C" {

// Launch the racy kernel on `stream`; returns a cudaError_t (0 on success).
int heat3d_seeded_race_launch(float* out, void* stream) {
  seeded_race_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

int heat3d_seeded_race_threads() { return kThreads; }

}  // extern "C"
