// Device probes for Hopper (sm_90a): what the card's FP32 units and a
// world's solver-shaped product take on this card.
//
// Replaces the three Pallas TPU kernels of benchmarks/device_probe.py:
//   probe_kernel_matmuls (:94): 8 worlds' (8, 64) blocks, each through 16
//     dependent steps acc += (acc S_w)[:, :64] 1e-6 a trip, k trips;
//   probe_kernel_vpu (:131): 16 chained acc 1.0000001 + 1e-9 a trip over a
//     whole (8, 384) or (32, 384) array, k trips;
//   probe_mxu_peak (:157): a chain of k products acc <- (acc B) 0.0625 of
//     (256, 256) f32 matrices.
// On the TPU each ran inside one core's VMEM; the times they give are the
// latencies and rates of that core's matrix and vector units. Here what
// the TPU held in VMEM is held in shared memory or registers: probe_vpu is
// one block on one SM, probe_matmuls one block a world (8 SMs), probe_mxu
// one cluster of 16 blocks on 16 SMs, so they measure FP32 FMA latency and
// throughput of an SM and a 16-SM share of the card's FP32 rate. All three
// are bound by FP32 operations on the SMs they run on: their bound is
// their operations at 67 TFLOP/s (the H100 SXM data sheet's FP32 rate
// outside the tensor cores) times the share of the 132 SMs they use; the
// unfused multiply-then-add chain at half that rate, since the data sheet
// counts a fused multiply-add as 2 operations of one instruction. No
// tensor cores and no TF32: the port keeps its float32 products in full
// float32.
//
// probe_matmuls: one block of 384 threads a world, so the chain of a world
// stays on one SM (8 SMs for the probe's 8 worlds). S_w (64 x 384 floats)
// lives in registers, 64 a thread, and acc (8 x 64) is double-buffered in
// shared memory, so a step ends with one barrier. Two kinds of lanes:
//   - threads 0-63 own the 64 columns of acc, one each, with all of k:
//     each computes its column's 8 values as sequential FMA chains over k
//     (the plain product's order, so acc stays the plain version's bit for
//     bit), reading acc as 16-byte broadcasts, and writes acc + vh * 1e-6
//     (rounded as the plain version rounds: multiply, then add; acc's old
//     values read at the start of the step) into the other buffer;
//   - the other 320 own the last 320 columns in quads: the 4 lanes of a
//     quad share 4 columns and split k (lane g takes k = 16m + 4g + e,
//     m, e < 4), each acc float4 read feeding 16 FMAs; the partial sums
//     meet in two rounds of shuffles that halve what each lane holds
//     (reduce-scatter), summed as (p0 + p1) + (p2 + p3). Each lane computes
//     its rows in an order rotated by the rows it ends with, so that it
//     always keeps its first half and sends the second (no selects).
// Every lane sums its 8 values of the product in float32 and adds that to
// a running double after the barrier, so the 320 columns that do not feed
// acc are computed and kept: the sum of all 384 is the block's checksum
// output, which the plain version computes too (every value in double),
// and an error in any column shows there. A lane does 512 FMAs a step:
// FP32 FMAs bound it (1,536 issue cycles of the SM's 128 FMA lanes). The
// earlier design (S_w in shared memory, 12 shared loads for every 4
// values of k, two barriers a step) was bound by its shared-memory loads.
// Quads on all 384 columns were 11% faster (5.00 ms against 5.65 at 256
// trips, utils/kernel_ab.py --probe, NVIDIA H100 80GB HBM3 at 700 W), but
// their acc left the plain product's order, and on random inputs an acc
// value near 0 moved by 10 float32 spacings, past MATMUL_ULPS.
//
// probe_vpu: one block of 1024 threads on one SM; thread t keeps elements
// t, t + 1024, ... in registers, kPer independent chains (3 at 8 x 384, 12
// at 32 x 384). mode 0 computes __fadd_rn(__fmul_rn(acc, 1.0000001f),
// 1e-9f), the TPU's multiply then add, bitwise the plain version's
// acc * 1.0000001 + 1e-9 in float32; mode 1 the fused fmaf, another
// rounding, timed only.
//
// probe_mxu: one thread-block cluster of 16 blocks, one an SM, the (256,
// 256) output cut into a 4 x 4 grid of 64 x 64 tiles. Block (i, j) (its
// rank in the cluster is 4i + j) holds in shared memory B's column slab
// B[:, 64j : 64j + 64] (64 KB, loaded once) and acc's row band
// acc[64i : 64i + 64, :], transposed (k-major) and double-buffered
// (2 x 64 KB): 192 KB of the SM's 227 KB. A step, from shared memory
// alone:
//   1. the block's 8 warps split k in quarters, two warps a quarter; each
//      thread sums its quarter for an 8 x 8 register tile of the block's
//      tile (sequential fmaf chains of 64, the loop unrolled whole),
//      reading 8 + 8 floats of shared memory for 64 FMAs (a 4 x 4 tile
//      reads 8 for 16, and its reads, not its FMAs, bound it: 7.2 us a
//      product without the stores and barriers, against 4.1 us of FMAs,
//      on an NVIDIA H100 80GB HBM3 at 700 W);
//   2. the 4 partial tiles go, column-major, into the band just read (64
//      KB: it is free until the peers write it in the next step);
//   3. each thread sums 4 x 4 outputs as (p0 + p1) + (p2 + p3), scales
//      them by 0.0625 (exact) and writes them, as 4 float4 columns of the
//      transposed band, into the next buffer of the 4 blocks of its row
//      band (its own and three peers', through distributed shared memory);
//   4. one cluster barrier (arrive.release, wait.acquire) ends the step.
// The double buffer makes one barrier a step enough: a block writes buffer
// (s+1) % 2 in step s while its peers read buffer s % 2, and none reads or
// reuses buffer (s+1) % 2 before every block has passed the barrier of
// step s. The last step writes its tile to buf[(steps - 1) % 2] in device
// memory. Every warp's shared reads and stores are runs of 64 or 128
// contiguous bytes. A cluster of 16 is larger than the portable 8
// (cudaFuncAttributeNonPortableClusterSizeAllowed); the launcher asks
// cudaOccupancyMaxActiveClusters whether one can be placed (7 on the
// H100, NVIDIA H100 80GB HBM3 at 700 W) and returns an error if not. A
// product is 2 * 256^3 = 33.6 MFLOP, 2.1 MFLOP an SM: 8,192 cycles of the
// SM's 128 FMA lanes, about 4.1 us at 1.98 GHz, against 48 KB of
// distributed shared-memory stores and a cluster barrier. With A = 1 and
// B = 1/16 every partial and every entry of every step is exact, so the
// chain gives 1 in any order of summation. The earlier design ran one
// block on one SM, with acc ping-ponging through L2 and both operands
// re-staged through shared tiles 16 times a product.
//
// Syncing only a row band's 4 blocks (the only ones whose data meet) with
// mbarriers in place of the cluster barrier was slower: 49.9 ms at 4,096
// products against 34.1 ms (utils/kernel_ab.py --probe, NVIDIA H100 80GB
// HBM3 at 700 W). So was a 4-warp block with 8 x 16 tiles (35.4 ms).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (utils/kernel_ab.py
// --probe, this source against the earlier one in one process): probe_mxu
// 31.6-31.9 ms at 4,096 products, 7.7 us a product (the one-SM design 456.7
// ms); probe_matmuls 5.65 ms at 256 trips, 1.38 us a dependent step (the
// earlier design 9.30 ms); probe_vpu 0.41 ms at (8, 384) and 1,024 trips,
// 25 ns a multiply-then-add step, the fused chain at 0.50 TFLOP/s, 98% of
// one SM's peak. PERF.md section 6 has them beside their bounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// probe_matmuls
constexpr int kRows = 8;          // rows of acc
constexpr int kInner = 64;        // columns of acc, rows of S
constexpr int kCols = 384;        // columns of S
constexpr int kChain = 16;        // dependent steps a trip
constexpr int kQuad = 4;          // lanes that split k for 4 columns
constexpr int kSlices = kInner / (4 * kQuad);   // float4s of k a lane: 4

__global__ void __launch_bounds__(kCols, 1)
probe_matmuls_kernel(const float* __restrict__ vel,   // (W, 8, 64)
                     const float* __restrict__ s,     // (W, 64, 384)
                     float* __restrict__ out,         // (W, 8, 64)
                     double* __restrict__ checksum,   // (W,)
                     int trips) {
  __shared__ __align__(16) float acc[2][kRows * kInner];
  __shared__ double partial[kCols / 32];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* s_w = s + (size_t)w * kInner * kCols;
  // threads 0-63 (warps 0, 1): column tid of acc, all of k. The others, in
  // quads: 4 of the last 320 columns, k split over the quad's lanes
  const bool column = tid < kInner;
  const int g = lane & (kQuad - 1);               // k quarter of the quad
  const int c0 = kInner + 4 * ((tid - kInner) >> 2);   // first column
  // rows of the product a quad lane holds after the reduce-scatter; its
  // partial row r is row r ^ r0, so that it always keeps its rows 0-3,
  // then 0-1, and sends the others: no selects
  const int r0 = (g & 1) * 4 + (g & 2);

  // S_w in registers: sw[k] = S_w[k][tid] for a column lane;
  // sw[16m + 4e + j] = S_w[16m + 4g + e][c0 + j] for a quad lane
  float sw[kInner];
  if (column) {
#pragma unroll
    for (int k = 0; k < kInner; ++k) sw[k] = __ldg(s_w + k * kCols + tid);
  } else {
#pragma unroll
    for (int m = 0; m < kSlices; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            s_w + (size_t)(16 * m + 4 * g + e) * kCols + c0));
        sw[16 * m + 4 * e] = v.x; sw[16 * m + 4 * e + 1] = v.y;
        sw[16 * m + 4 * e + 2] = v.z; sw[16 * m + 4 * e + 3] = v.w;
      }
  }
  for (int i = tid; i < kRows * kInner; i += kCols)
    acc[0][i] = vel[(size_t)w * kRows * kInner + i];
  __syncthreads();

  double sum = 0.0;                    // this lane's share of the checksum
  float eight = 0.0f;                  // the last step's share, not yet in
  int cur = 0;
  for (int trip = 0; trip < trips; ++trip) {
    for (int step = 0; step < kChain; ++step) {
      const float* a = acc[cur];
      sum += (double)eight;
      if (column) {
        // acc[r][tid], read early; each row one sequential FMA chain over
        // k, the plain product's order
        float old[kRows], v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          old[r] = a[r * kInner + tid];
          v[r] = 0.0f;
        }
#pragma unroll
        for (int k4 = 0; k4 < kInner / 4; ++k4) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 a4 = reinterpret_cast<const float4*>(
                a + r * kInner + 4 * k4)[0];
            v[r] = fmaf(a4.x, sw[4 * k4], v[r]);
            v[r] = fmaf(a4.y, sw[4 * k4 + 1], v[r]);
            v[r] = fmaf(a4.z, sw[4 * k4 + 2], v[r]);
            v[r] = fmaf(a4.w, sw[4 * k4 + 3], v[r]);
          }
        }
        eight = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[cur ^ 1][r * kInner + tid] =
              __fadd_rn(old[r], __fmul_rn(v[r], 1e-6f));
          eight += v[r];
        }
      } else {
        float p[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[r][j] = 0.0f;
#pragma unroll
        for (int m = 0; m < kSlices; ++m) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 a4 = reinterpret_cast<const float4*>(
                a + (r ^ r0) * kInner + 16 * m + 4 * g)[0];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              p[r][j] = fmaf(a4.x, sw[16 * m + j], p[r][j]);
              p[r][j] = fmaf(a4.y, sw[16 * m + 4 + j], p[r][j]);
              p[r][j] = fmaf(a4.z, sw[16 * m + 8 + j], p[r][j]);
              p[r][j] = fmaf(a4.w, sw[16 * m + 12 + j], p[r][j]);
            }
          }
        }
        // reduce-scatter over the quad: the partner's partial row 4 + r
        // (or 2 + r) is this lane's row r
        float h[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            h[r][j] = p[r][j] + __shfl_xor_sync(0xffffffffu, p[4 + r][j], 1);
        eight = 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            eight += h[r][j] + __shfl_xor_sync(0xffffffffu, h[2 + r][j], 2);
      }
      cur ^= 1;
      __syncthreads();                 // the next buffer is written
    }
  }
  sum += (double)eight;
  for (int i = tid; i < kRows * kInner; i += kCols)
    out[(size_t)w * kRows * kInner + i] = acc[cur][i];
  double total = sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  if (lane == 0) partial[tid >> 5] = total;
  __syncthreads();
  if (tid == 0) {
    double all = 0.0;
    for (int i = 0; i < kCols / 32; ++i) all += partial[i];
    checksum[w] = all;
  }
}

// probe_vpu
constexpr int kVpuThreads = 1024;

template <int kPer, int kMode>
__device__ __forceinline__ void vpu_chain(float (&v)[kPer], int trips) {
  for (int trip = 0; trip < trips; ++trip) {
#pragma unroll
    for (int step = 0; step < kChain; ++step) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (kMode == 0)
          v[j] = __fadd_rn(__fmul_rn(v[j], 1.0000001f), 1e-9f);
        else
          v[j] = fmaf(v[j], 1.0000001f, 1e-9f);
      }
    }
  }
}

template <int kPer, int kMode>
__global__ void __launch_bounds__(kVpuThreads, 1)
probe_vpu_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int trips) {
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = x[threadIdx.x + j * kVpuThreads];
  vpu_chain<kPer, kMode>(v, trips);
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kVpuThreads] = v[j];
}

template <int kPer>
int vpu_launch(const float* x, float* out, int trips, int mode,
               cudaStream_t stream) {
  if (mode == 0)
    probe_vpu_kernel<kPer, 0><<<1, kVpuThreads, 0, stream>>>(x, out, trips);
  else
    probe_vpu_kernel<kPer, 1><<<1, kVpuThreads, 0, stream>>>(x, out, trips);
  return (int)cudaGetLastError();
}

// probe_mxu
constexpr int kN = 256;           // the matrices' side
constexpr int kGrid = 4;          // the output's tiles a side
constexpr int kCluster = kGrid * kGrid;           // blocks, one an SM
constexpr int kTile = kN / kGrid;                 // 64
constexpr int kMxuThreads = 256;  // 4 quarters of k x 64 threads, 8 x 8 each
constexpr int kKQuarter = kN / 4;                 // 64
constexpr int kBand = kN * kTile;                 // floats of a band: 64 KB
constexpr int kMxuSmem = 3 * kBand * 4;           // slab + 2 bands: 192 KB

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMxuThreads, 1)
probe_mxu_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ buf,             // (2, 256, 256)
                 int steps) {
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;                 // (256, 64): B[k][64j + c]
  float* bands = smem + kBand;        // 2 x (256, 64): acc[64i + r][k] at
                                      // [k * 64 + r]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bi = rank / kGrid, bj = rank % kGrid;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the sum and the stores: 4 x 4 outputs a thread, a warp 8 row groups x
  // 4 column groups
  const int ty = (warp & 1) * 8 + (lane & 7);        // rows 4ty .. 4ty + 3
  const int tx = (warp >> 1) * 4 + (lane >> 3);      // columns 4tx .. 4tx + 3

  // B's slab, once; acc's band from A, transposed, into buffer 0
  for (int q = tid; q < kN * kTile / 4; q += kMxuThreads) {
    const int k = q / (kTile / 4), c4 = q % (kTile / 4);
    reinterpret_cast<float4*>(slab)[q] = __ldg(reinterpret_cast<const float4*>(
        b + (size_t)k * kN + bj * kTile + c4 * 4));
  }
  for (int q = tid; q < kTile * kN / 4; q += kMxuThreads) {
    const int r = q % kTile, k4 = q / kTile;         // conflict-free stores
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        a + (size_t)(bi * kTile + r) * kN + k4 * 4));
    bands[(k4 * 4 + 0) * kTile + r] = v.x;
    bands[(k4 * 4 + 1) * kTile + r] = v.y;
    bands[(k4 * 4 + 2) * kTile + r] = v.z;
    bands[(k4 * 4 + 3) * kTile + r] = v.w;
  }
  cluster_barrier();                  // every block resident, bands loaded

  // the product: warps 2q, 2q + 1 sum k in [64q, 64q + 64) for the whole
  // tile, each thread an 8 x 8 register tile (rows 4py .. and 32 + 4py ..,
  // columns 4px .. and 32 + 4px ..); a warp is 8 py x 4 px
  const int kq = warp >> 1;
  const int py = lane & 7;
  const int px = (warp & 1) * 4 + (lane >> 3);
  for (int step = 0; step < steps; ++step) {
    float* band = bands + (step & 1) * kBand;
    float p[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[i][j] = 0.0f;
    const float* a_k = band + kq * kKQuarter * kTile;
    const float* b_k = slab + kq * kKQuarter * kTile;
#pragma unroll
    for (int k = 0; k < kKQuarter; ++k) {
      const float4 a0 = reinterpret_cast<const float4*>(a_k + k * kTile)[py];
      const float4 a1 =
          reinterpret_cast<const float4*>(a_k + k * kTile + 32)[py];
      const float4 b0 = reinterpret_cast<const float4*>(b_k + k * kTile)[px];
      const float4 b1 =
          reinterpret_cast<const float4*>(b_k + k * kTile + 32)[px];
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = fmaf(ar[i], br[j], p[i][j]);
    }
    __syncthreads();                  // the band is read: it is scratch now
    // the quarter's partial tile, column-major: part[kq][c][r]
    float* part = band + kq * kTile * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 32) + px * 4 + (j & 3);
      reinterpret_cast<float4*>(part + c * kTile)[py] =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      reinterpret_cast<float4*>(part + c * kTile + 32)[py] =
          make_float4(p[4][j], p[5][j], p[6][j], p[7][j]);
    }
    __syncthreads();
    // the sum, (p0 + p1) + (p2 + p3) of rows 4ty .. 4ty + 3, column
    // 4tx + j, scaled
    float4 t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* col = band + (tx * 4 + j) * kTile;
      float4 q[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        q[h] = reinterpret_cast<const float4*>(col + h * kTile * kTile)[ty];
      t[j].x = ((q[0].x + q[1].x) + (q[2].x + q[3].x)) * 0.0625f;
      t[j].y = ((q[0].y + q[1].y) + (q[2].y + q[3].y)) * 0.0625f;
      t[j].z = ((q[0].z + q[1].z) + (q[2].z + q[3].z)) * 0.0625f;
      t[j].w = ((q[0].w + q[1].w) + (q[2].w + q[3].w)) * 0.0625f;
    }
    if (step + 1 < steps) {
      // column 64bj + 4tx + j of the tile is row k of the next band
      float* next = bands + ((step + 1) & 1) * kBand;
#pragma unroll
      for (int n = 0; n < kGrid; ++n) {
        float* peer = cluster.map_shared_rank(
            next, bi * kGrid + (bj + n) % kGrid);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          reinterpret_cast<float4*>(
              peer + (bj * kTile + tx * 4 + j) * kTile)[ty] = t[j];
      }
      cluster_barrier();              // the next band is written everywhere
    } else {
      float* dst = buf + (size_t)(step & 1) * kN * kN;
      const float rows[4][4] = {{t[0].x, t[1].x, t[2].x, t[3].x},
                                {t[0].y, t[1].y, t[2].y, t[3].y},
                                {t[0].z, t[1].z, t[2].z, t[3].z},
                                {t[0].w, t[1].w, t[2].w, t[3].w}};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        reinterpret_cast<float4*>(
            dst + (size_t)(bi * kTile + ty * 4 + i) * kN + bj * kTile)[tx] =
            make_float4(rows[i][0], rows[i][1], rows[i][2], rows[i][3]);
    }
  }
  cluster_barrier();                  // no block leaves before its peers
}

// The cluster's launch configuration on `stream`, with its attribute.
struct MxuLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  explicit MxuLaunch(cudaStream_t stream) {
    config.gridDim = dim3(kCluster);
    config.blockDim = dim3(kMxuThreads);
    config.dynamicSmemBytes = kMxuSmem;
    config.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

// Opt the kernel into 192 KB of shared memory and a cluster of 16, then
// ask how many such clusters the card can hold at once.
cudaError_t mxu_prepare(int* max_clusters, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMxuSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      probe_mxu_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  MxuLaunch launch(stream);
  return cudaOccupancyMaxActiveClusters(max_clusters, probe_mxu_kernel,
                                        &launch.config);
}

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns the launch's
// cudaError_t (0 on success); pointers are device pointers, float unless
// named otherwise.

// vel (W, 8, 64), s (W, 64, 384) -> out (W, 8, 64), checksum (W,) double;
// one block a world.
extern "C" int probe_matmuls_launch(const void* vel, const void* s, void* out,
                                    void* checksum, int worlds, int trips,
                                    void* stream) {
  probe_matmuls_kernel<<<worlds, kCols, 0, (cudaStream_t)stream>>>(
      (const float*)vel, (const float*)s, (float*)out, (double*)checksum,
      trips);
  return (int)cudaGetLastError();
}

// x, out: n = 1024 * per floats, per 3 or 12; mode 0 multiply then add,
// 1 fused; one block.
extern "C" int probe_vpu_launch(const void* x, void* out, int per, int trips,
                                int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (per == 3) return vpu_launch<3>((const float*)x, (float*)out, trips, mode,
                                     st);
  if (per == 12) return vpu_launch<12>((const float*)x, (float*)out, trips,
                                       mode, st);
  return (int)cudaErrorInvalidValue;
}

// a, b (256, 256), buf (2, 256, 256): the result of step i is buf[i % 2];
// steps >= 1; one cluster of 16 blocks. Returns cudaErrorLaunchOutOfResources
// (701) when the card cannot place one such cluster: there is no other design
// to fall back to.
extern "C" int probe_mxu_launch(const void* a, const void* b, void* buf,
                                int steps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int clusters = 0;
  cudaError_t err = mxu_prepare(&clusters, st);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  MxuLaunch launch(st);
  err = cudaLaunchKernelEx(&launch.config, probe_mxu_kernel, (const float*)a,
                           (const float*)b, (float*)buf, steps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// probe_mxu's cluster: info[0] its blocks, info[1] how many such clusters
// the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int probe_mxu_cluster_info(void* info) {
  int* out = (int*)info;
  out[0] = kCluster;
  return (int)mxu_prepare(out + 1, 0);
}
