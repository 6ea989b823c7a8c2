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
// so device-memory bandwidth bounds it. A kept column's D values lie M
// floats apart, so each arrives in a 32-byte sector of its own: what the
// memory really serves is 32 bytes per (row, group of 8 columns that holds
// a kept one), more than the 4 bytes per kept value the bound counts.
//
// Design: what the kernel waits for is latency, not bandwidth, so the work
// of one world is a short chain with many independent loads at its end,
// and many worlds are in flight. One warp per world, kWarps worlds per
// block, and no block-wide barrier:
//   1. each lane reads 16 mask bytes with one load (M = 384 is 24 lanes),
//      counts them with popc, and a shuffle scan gives the lane its rank;
//      rows longer than 512 loop with a carry;
//   2. each lane writes the positions of its kept bytes of rank < k into
//      the warp's index list in shared memory (k ints), then __syncwarp();
//   3. every lane gathers: for each payload row d and j = lane, lane + 32,
//      ... < k it stores payload[d, idx[j]] (or 0 past the count) straight
//      to rows[d, j], coalesced. With D a template parameter (10 on the
//      main paths) a lane's D loads are independent and in flight together.
//      The payload is read once, so its loads are streaming loads
//      (__ldcs, evict first); the rows, which the next kernel reads, are
//      stored as usual.
// No (D, k) tile, no zero-fill pass, no one-hot, no atomics: the result is
// deterministic and exact. Considered and not taken: a one-hot wgmma
// product, which reads the whole payload (D*M*4 bytes per world, more than
// the sectors of the kept columns), and TMA, which moves tiles, not
// scattered 4-byte columns.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W with utils/kernel_ab.py
// (this file and copies of it with one constant changed, timed in turns in
// one process), B=8192, D=10, M=384, k=64, a random mask of density 0.15,
// bf16 rounding: 0.049 ms (the one-block-per-world kernel before it:
// 0.065 ms), 64 registers for D=10, no spills, 8*k*4 bytes of shared memory
// a block (2 KB at k=64), no barrier. The streaming loads are worth 6%
// (__ldg and __ldcg: 0.052 ms); the run-time loop over D at D=10 takes
// 0.054 ms, and 0.0139 against 0.0086 ms at B=1024, which is what the D=10
// instance is for; 2 or 4 worlds a block change nothing; 16 worlds a block,
// or a register limit for 6 or 8 blocks an SM, spill and cost 28-45%. The
// time is 1.18 times what 64 bytes per (row, group of 16 columns that holds
// a kept one) take at the data sheet's 3.35 TB/s, and 1.4 times what 32
// bytes per group of 8 take (chip_smoke.py prints both, floor_64b_ms and
// sector_floor_ms, beside the bound).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // worlds per block (the wrapper's
                                           // limit on k counts on it)
constexpr int kMinBlocks = 4;              // blocks an SM: 64 registers a thread
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32 * 16;            // mask bytes a warp scans at once

// The lane's 16 mask bytes from `off` as four words of 0/1 bytes; bytes at
// or beyond M read as 0. `vec`: the row is 16-byte aligned and M % 16 == 0.
__device__ __forceinline__ uint4 load_mask16(const uint8_t* __restrict__ row,
                                             int off, int M, bool vec) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (off < M) w = *reinterpret_cast<const uint4*>(row + off);
  } else {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (off + i < M) ? row[off + i] : 0u;
      words[i >> 2] |= byte << (8 * (i & 3));
    }
    w = make_uint4(words[0], words[1], words[2], words[3]);
  }
  // any non-zero byte counts as true
  w.x = __vsetne4(w.x, 0u);
  w.y = __vsetne4(w.y, 0u);
  w.z = __vsetne4(w.z, 0u);
  w.w = __vsetne4(w.w, 0u);
  return w;
}

// kD > 0: the payload has kD rows (unrolled); kD == 0: D rows, a run-time
// loop.
template <int kD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_rows_kernel(const uint8_t* __restrict__ mask,      // (B, M)
                    const float* __restrict__ payload,     // (B, D, M)
                    float* __restrict__ rows,              // (B, D, k)
                    uint8_t* __restrict__ valid,           // (B, k)
                    int32_t* __restrict__ count,           // (B,)
                    int32_t* __restrict__ overflow,        // (B,)
                    int B, int D, int M, int k, int round_bf16, int vec) {
  extern __shared__ int index_lists[];                     // (kWarps, k)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;                  // whole warps leave; no block barrier
  const int rows_d = kD > 0 ? kD : D;
  int* idx = index_lists + warp * k;
  const uint8_t* mask_w = mask + (size_t)w * M;
  const float* pay_w = payload + (size_t)w * rows_d * M;

  int total = 0;                       // kept columns before this chunk
  for (int base = 0; base < M; base += kChunk) {
    const int off = base + lane * 16;
    const uint4 bits = load_mask16(mask_w, off, M, vec != 0);
    const int mine = __popc(bits.x) + __popc(bits.y) + __popc(bits.z) +
                     __popc(bits.w);
    int incl = mine;                   // inclusive scan over the lanes
#pragma unroll
    for (int step = 1; step < 32; step <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, step);
      if (lane >= step) incl += up;
    }
    int rank = total + incl - mine;
    const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = words[q];
      while (word != 0u && rank < k) {
        const int bit = __ffs(word) - 1;           // 0, 8, 16 or 24
        idx[rank++] = off + 4 * q + (bit >> 3);
        word &= word - 1u;
      }
    }
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();

  const int kept = total < k ? total : k;
  float* rows_w = rows + (size_t)w * rows_d * k;
#pragma unroll 2
  for (int j = lane; j < k; j += 32) {
    const bool live = j < kept;
    const int m = live ? idx[j] : 0;
    if constexpr (kD > 0) {
      float v[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d)
        v[d] = live ? __ldcs(pay_w + (size_t)d * M + m) : 0.0f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (round_bf16) v[d] = __bfloat162float(__float2bfloat16_rn(v[d]));
        rows_w[(size_t)d * k + j] = v[d];
      }
    } else {
      for (int d = 0; d < D; ++d) {
        float v = live ? __ldcs(pay_w + (size_t)d * M + m) : 0.0f;
        if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        rows_w[(size_t)d * k + j] = v;
      }
    }
    valid[(size_t)w * k + j] = (j < total) ? 1 : 0;
  }
  if (lane == 0) {
    count[w] = kept;
    overflow[w] = total > k ? total - k : 0;
  }
}

}  // namespace

// Launches the kernel on `stream` for B worlds and returns the launch's
// cudaError_t (0 on success). Pointers are device pointers; k ints per
// warp must fit in 48 KB of shared memory (k <= 1536).
extern "C" int compact_rows_launch(const void* mask, const void* payload,
                                   void* rows, void* valid, void* count,
                                   void* overflow, int B, int D, int M, int k,
                                   int round_bf16, void* stream) {
  const size_t smem = (size_t)kWarps * k * sizeof(int);
  const int vec = (M % 16 == 0) && ((uintptr_t)mask % 16 == 0);
  const int blocks = (B + kWarps - 1) / kWarps;
  auto kernel = D == 10 ? compact_rows_kernel<10> : compact_rows_kernel<0>;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const float*)payload, (float*)rows,
      (uint8_t*)valid, (int32_t*)count, (int32_t*)overflow, B, D, M, k,
      round_bf16, vec);
  return (int)cudaGetLastError();
}
