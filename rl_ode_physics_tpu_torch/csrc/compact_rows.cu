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
//
// Any k, and float64. The index list costs k ints a warp of shared
// memory, which caps it at k <= kMaxListK = 1,536 (48 KB a block without
// an opt-in). Past that the warp's list holds one chunk's kept columns
// (at most kChunk = 512 ints): after each chunk's scan the warp gathers
// that chunk's columns to their ranks, coalesced as in step 3, before the
// next chunk overwrites the list; a last loop writes the zero columns from
// the count to k and the valid flags. The k <= 1,536 instances stay the
// code measured above. Every k >= 1 is taken, k > M included. At k = 2,048
// (B = 1,024, M = 4,096, density 0.5) it takes 0.134 ms, 2.6 times its
// bound; storing each kept column at its rank during the scan, one lane
// at a time, took 0.814 ms (scattered 4-byte stores). The element type is a template
// parameter: float and double, each with the D = 10 and run-time-D
// instances. The selector rounding is done in the kernel, as the plain
// version does it: to bf16 through float (PyTorch converts a double to
// bf16 by way of float, so __float2bfloat16_rn((float)x) and not
// __double2bfloat16), or, for a double payload and float32 selectors, to
// float and back.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // worlds per block
constexpr int kMinBlocks = 4;              // blocks an SM: 64 registers a thread
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32 * 16;            // mask bytes a warp scans at once
// the largest k whose index lists fit in the 48 KB of shared memory a
// block gets without an opt-in
constexpr int kMaxListK = 48 * 1024 / (kWarps * 4);

// the selector rounding: 0 none, 1 bf16 (through float), 2 float
enum Round { kNone = 0, kBf16 = 1, kFloat = 2 };

template <typename T>
__device__ __forceinline__ T round_sel(T v, int mode) {
  if (mode == kBf16) return (T)__bfloat162float(__float2bfloat16_rn((float)v));
  if (mode == kFloat) return (T)(float)v;
  return v;
}

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

// rows[d, j] = payload[d, m] for every payload row d, rounded as asked.
template <typename T, int kD>
__device__ __forceinline__ void copy_column(const T* __restrict__ pay_w,
                                            T* __restrict__ rows_w, int D,
                                            int M, int k, int m, int j,
                                            int round_mode) {
  if constexpr (kD > 0) {
    T v[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) v[d] = __ldcs(pay_w + (size_t)d * M + m);
#pragma unroll
    for (int d = 0; d < kD; ++d)
      rows_w[(size_t)d * k + j] = round_sel(v[d], round_mode);
  } else {
    for (int d = 0; d < D; ++d)
      rows_w[(size_t)d * k + j] =
          round_sel(__ldcs(pay_w + (size_t)d * M + m), round_mode);
  }
}

// kD > 0: the payload has kD rows (unrolled); kD == 0: D rows, a run-time
// loop. kList: the warp's index list in shared memory holds all k kept
// columns (k <= kMaxListK); otherwise it holds one chunk's, gathered
// before the next chunk is scanned.
template <typename T, int kD, bool kList>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kMinBlocks : 2)
compact_rows_kernel(const uint8_t* __restrict__ mask,      // (B, M)
                    const T* __restrict__ payload,         // (B, D, M)
                    T* __restrict__ rows,                  // (B, D, k)
                    uint8_t* __restrict__ valid,           // (B, k)
                    int32_t* __restrict__ count,           // (B,)
                    int32_t* __restrict__ overflow,        // (B,)
                    int B, int D, int M, int k, int round_mode, int vec) {
  extern __shared__ int index_lists[];       // (kWarps, k) or (kWarps, kChunk)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;                  // whole warps leave; no block barrier
  const int rows_d = kD > 0 ? kD : D;
  int* idx = index_lists + warp * (kList ? k : kChunk);
  const uint8_t* mask_w = mask + (size_t)w * M;
  const T* pay_w = payload + (size_t)w * rows_d * M;
  T* rows_w = rows + (size_t)w * rows_d * k;

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
    int slot = kList ? rank : incl - mine;     // the lane's first list slot
    const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = words[q];
      while (word != 0u && rank < k) {
        const int bit = __ffs(word) - 1;           // 0, 8, 16 or 24
        idx[slot++] = off + 4 * q + (bit >> 3);
        ++rank;
        word &= word - 1u;
      }
    }
    const int in_chunk = __shfl_sync(0xffffffffu, incl, 31);
    if constexpr (!kList) {
      __syncwarp();
      const int n = min(in_chunk, k - total);      // this chunk's kept columns
      for (int j = lane; j < n; j += 32)
        copy_column<T, kD>(pay_w, rows_w, D, M, k, idx[j], total + j,
                           round_mode);
      __syncwarp();                    // the list is the next chunk's
    }
    total += in_chunk;
  }
  __syncwarp();

  const int kept = total < k ? total : k;
  if constexpr (kList) {
#pragma unroll 2
    for (int j = lane; j < k; j += 32) {
      const bool live = j < kept;
      const int m = live ? idx[j] : 0;
      if constexpr (kD > 0) {
        T v[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d)
          v[d] = live ? __ldcs(pay_w + (size_t)d * M + m) : T(0);
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          if (round_mode) v[d] = round_sel(v[d], round_mode);
          rows_w[(size_t)d * k + j] = v[d];
        }
      } else {
        for (int d = 0; d < D; ++d) {
          T v = live ? __ldcs(pay_w + (size_t)d * M + m) : T(0);
          if (round_mode) v = round_sel(v, round_mode);
          rows_w[(size_t)d * k + j] = v;
        }
      }
      valid[(size_t)w * k + j] = (j < total) ? 1 : 0;
    }
  } else {
    // the kept columns are stored; zero the rest and write the flags
    for (int j = kept + lane; j < k; j += 32)
      for (int d = 0; d < rows_d; ++d) rows_w[(size_t)d * k + j] = T(0);
    for (int j = lane; j < k; j += 32)
      valid[(size_t)w * k + j] = (j < total) ? 1 : 0;
  }
  if (lane == 0) {
    count[w] = kept;
    overflow[w] = total > k ? total - k : 0;
  }
}

template <typename T>
int launch(const void* mask, const void* payload, void* rows, void* valid,
           void* count, void* overflow, int B, int D, int M, int k,
           int round_mode, void* stream) {
  const int vec = (M % 16 == 0) && ((uintptr_t)mask % 16 == 0);
  const int blocks = (B + kWarps - 1) / kWarps;
  const bool list = k <= kMaxListK;
  auto kernel = list ? (D == 10 ? compact_rows_kernel<T, 10, true>
                                : compact_rows_kernel<T, 0, true>)
                     : (D == 10 ? compact_rows_kernel<T, 10, false>
                                : compact_rows_kernel<T, 0, false>);
  const size_t smem = (size_t)kWarps * (list ? k : kChunk) * sizeof(int);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const T*)payload, (T*)rows, (uint8_t*)valid,
      (int32_t*)count, (int32_t*)overflow, B, D, M, k, round_mode, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher enqueues the kernel on `stream` for B worlds and returns the
// launch's cudaError_t (0 on success). Pointers are device pointers, the
// payload and rows float (compact_rows_launch) or double
// (compact_rows_launch_f64); k >= 1; round_mode: 0 none, 1 bf16, 2 float.
extern "C" int compact_rows_launch(const void* mask, const void* payload,
                                   void* rows, void* valid, void* count,
                                   void* overflow, int B, int D, int M, int k,
                                   int round_mode, void* stream) {
  return launch<float>(mask, payload, rows, valid, count, overflow, B, D, M,
                       k, round_mode, stream);
}

extern "C" int compact_rows_launch_f64(const void* mask, const void* payload,
                                       void* rows, void* valid, void* count,
                                       void* overflow, int B, int D, int M,
                                       int k, int round_mode, void* stream) {
  return launch<double>(mask, payload, rows, valid, count, overflow, B, D, M,
                        k, round_mode, stream);
}
