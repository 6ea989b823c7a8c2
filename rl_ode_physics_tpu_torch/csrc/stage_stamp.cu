// The kernels of utils/tracing.py: a stage stamp and a device counter.
//
// Both write one int64 accumulator array, laid out by utils/tracing.py:
//   acc[0]                     the previous stamp's %globaltimer (0: none yet)
//   acc[1]                     the clock probe (a stamp of stage -1)
//   acc[2 + s]                 nanoseconds of stage s (stage 0: outside)
//   acc[2 + n_stages + s]      stamps of stage s
//   acc[gap_slot]              outside gaps seen; then a ring of `ring`
//                              (start, end) pairs of the latest ones
// and the counters at the slots the caller names. Each launches on the
// caller's stream, so a CUDA graph captured there holds it; a stamp is one
// thread and orders after the kernel before it on the stream.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// Ends stage `stage`: adds the time since the previous stamp to it and 1
// to its count. Stage 0 (outside) also keeps the gap in the ring. Stage -1
// only writes the clock into acc[1].
__global__ void stage_stamp(long long* acc, int stage, int n_stages,
                            int gap_slot, int ring) {
  long long now = global_ns();
  if (stage < 0) {
    acc[1] = now;
    return;
  }
  long long prev = acc[0];
  if (prev != 0) {
    acc[2 + stage] += now - prev;
    if (stage == 0 && ring > 0) {
      long long seen = acc[gap_slot];
      long long i = seen % ring;
      acc[gap_slot + 1 + 2 * i] = prev;
      acc[gap_slot + 2 + 2 * i] = now;
      acc[gap_slot] = seen + 1;
    }
  }
  acc[2 + n_stages + stage] += 1;
  acc[0] = now;
}

// kinds of stage_count's source
constexpr int kConst = 0;   // no source: adds n
constexpr int kInt32 = 1;   // the sum of n int32 values
constexpr int kGroups = 2;  // n groups of `group` bytes: those with one set

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds the source's count to acc[slot] (one atomic a warp), and `add2` to
// acc[slot2] where slot2 >= 0.
__global__ void stage_count(long long* acc, int slot, const void* src,
                            long long n, int kind, int group, int slot2,
                            long long add2) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  if (tid == 0 && slot2 >= 0) atomicAdd((unsigned long long*)&acc[slot2], (unsigned long long)add2);
  if (kind == kConst) {
    if (tid == 0) atomicAdd((unsigned long long*)&acc[slot], (unsigned long long)n);
    return;
  }
  long long sum = 0;
  if (kind == kInt32) {
    const int* p = (const int*)src;
    for (long long i = tid; i < n; i += stride) sum += p[i];
  } else {
    const unsigned char* p = (const unsigned char*)src;
    for (long long i = tid; i < n; i += stride) {
      const unsigned char* g = p + i * group;
      int any = 0;
      for (int j = 0; j < group; ++j) any |= g[j];
      sum += any != 0;
    }
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0 && sum != 0)
    atomicAdd((unsigned long long*)&acc[slot], (unsigned long long)sum);
}

}  // namespace

// Each launcher enqueues on `stream` and returns the launch's cudaError_t
// (0 on success).
extern "C" int stamp_launch(void* acc, int stage, int n_stages, int gap_slot,
                            int ring, void* stream) {
  stage_stamp<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)acc, stage,
                                                 n_stages, gap_slot, ring);
  return (int)cudaGetLastError();
}

extern "C" int count_launch(void* acc, int slot, const void* src, long long n,
                            int kind, int group, int slot2, long long add2,
                            void* stream) {
  const int threads = 256;
  long long work = kind == kConst ? 1 : n;
  long long blocks = (work + threads * 8 - 1) / (threads * 8);
  if (blocks < 1) blocks = 1;
  if (blocks > 264) blocks = 264;
  stage_count<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (long long*)acc, slot, src, n, kind, group, slot2, add2);
  return (int)cudaGetLastError();
}
