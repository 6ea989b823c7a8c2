// An empty kernel: what one launch costs the card when the kernel does
// nothing. utils/timing.launch_floor_ms times it under the timer that the
// hand-written kernels are timed with, so that a kernel whose bound is
// shorter than a launch can be judged against the launch instead.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Enqueues one block of one thread on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
