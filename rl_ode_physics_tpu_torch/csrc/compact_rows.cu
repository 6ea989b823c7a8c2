// Contact-payload compaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rl_ode_physics_tpu/ops/compaction_pallas.py
// (compact_rows_t_pallas / _compact_kernel). Per world: rank = exclusive
// cumsum of the validity mask; rows_t[d, j] = payload_t[d, m] for the valid
// m whose rank is j < k; every other column of rows_t is 0. With
// round_bf16 the payload is rounded to bf16 (round to nearest even) and
// widened back, as the bf16 selection matmul of the JAX package does.
// The kernel also writes valid[j] = j < total, count = min(total, k) and
// overflow = max(total - k, 0).
//
// Bound: pure data movement. Per world it must read the mask (M bytes) and
// the D floats of each kept column, and write D*k floats plus k + 8 bytes,
// so device-memory bandwidth bounds it. The TPU kernel built a (k, M)
// one-hot in VMEM because the MXU was its fastest data mover; here the
// selection is a rank-scatter instead: one CTA per world, a block-wide
// ballot scan of the mask in tiles of blockDim.x, and each kept column's
// D values stored straight into a (D, k) tile in shared memory, which is
// zero-filled first and written out coalesced. No one-hot, no tensor
// cores, no atomics: the result is deterministic and exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const uint8_t* __restrict__ mask,      // (B, M)
                    const float* __restrict__ payload,     // (B, D, M)
                    float* __restrict__ rows,              // (B, D, k)
                    uint8_t* __restrict__ valid,           // (B, k)
                    int32_t* __restrict__ count,           // (B,)
                    int32_t* __restrict__ overflow,        // (B,)
                    int D, int M, int k, int round_bf16) {
  extern __shared__ float tile[];                          // (D, k)
  __shared__ int warp_tot[kWarps];

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* mask_w = mask + (size_t)w * M;
  const float* pay_w = payload + (size_t)w * D * M;

  for (int i = tid; i < D * k; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  int carry = 0;                       // kept columns before this tile
  for (int base = 0; base < M; base += kThreads) {
    const int m = base + tid;
    const bool keep = (m < M) && (mask_w[m] != 0);
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    const int lane_rank = __popc(bits & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(bits);
    __syncthreads();
    int warp_off = 0;
    int tile_tot = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int t = warp_tot[i];
      warp_off += (i < warp) ? t : 0;
      tile_tot += t;
    }
    const int rank = carry + warp_off + lane_rank;
    if (keep && rank < k) {
      for (int d = 0; d < D; ++d) {
        float v = pay_w[(size_t)d * M + m];
        if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        tile[d * k + rank] = v;
      }
    }
    carry += tile_tot;
    __syncthreads();                   // warp_tot is rewritten next tile
  }

  float* rows_w = rows + (size_t)w * D * k;
  for (int i = tid; i < D * k; i += kThreads) rows_w[i] = tile[i];
  for (int j = tid; j < k; j += kThreads)
    valid[(size_t)w * k + j] = (j < carry) ? 1 : 0;
  if (tid == 0) {
    count[w] = carry < k ? carry : k;
    overflow[w] = carry > k ? carry - k : 0;
  }
}

}  // namespace

// Launches the kernel on `stream` for B worlds and returns the launch's
// cudaError_t (0 on success). Pointers are device pointers.
extern "C" int compact_rows_launch(const void* mask, const void* payload,
                                   void* rows, void* valid, void* count,
                                   void* overflow, int B, int D, int M, int k,
                                   int round_bf16, void* stream) {
  const size_t smem = (size_t)D * k * sizeof(float);
  compact_rows_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const float*)payload, (float*)rows,
      (uint8_t*)valid, (int32_t*)count, (int32_t*)overflow, D, M, k,
      round_bf16);
  return (int)cudaGetLastError();
}
