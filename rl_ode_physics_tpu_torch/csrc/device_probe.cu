// Device probes for Hopper (sm_90a): what one SM's FP32 units and a world's
// solver-shaped product take on this card.
//
// Replaces the three Pallas TPU kernels of benchmarks/device_probe.py:
//   probe_kernel_matmuls (:94): 8 worlds' (8, 64) blocks, each through 16
//     dependent steps acc += (acc S_w)[:, :64] 1e-6 a trip, k trips;
//   probe_kernel_vpu (:131): 16 chained acc 1.0000001 + 1e-9 a trip over a
//     whole (8, 384) or (32, 384) array, k trips;
//   probe_mxu_peak (:157): a chain of k products acc <- (acc B) 0.0625 of
//     (256, 256) f32 matrices.
// On the TPU each ran inside one core's VMEM; the times they give are the
// latencies and rates of that core's matrix and vector units. Here each is
// one block (or one block a world) on as many SMs, with what the TPU held
// in VMEM held in shared memory or registers, so each measures the same
// thing of one SM: FP32 FMA latency and throughput, and one SM's share of
// the card's FP32 rate. All three are bound by FP32 operations on the SMs
// they run on: their bound is their operations at 67 TFLOP/s (the H100 SXM
// data sheet's FP32 rate outside the tensor cores) times the share of the
// 132 SMs they use; the unfused multiply-then-add chain at half that rate,
// since the data sheet counts a fused multiply-add as 2 operations of one
// instruction. No tensor cores and no TF32: the port keeps its float32
// products in full float32.
//
// probe_matmuls: one block per world, 384 threads, thread c owns column c
// of the (8, 384) product. S_w (64 x 384 floats, 96 KB) is staged once in
// dynamic shared memory, above the 48 KB that a block gets without the
// opt-in, and acc (8 x 64) beside it. A step: each thread runs 8 chains of
// 64 FMAs (acc[r][k..k+3] read as a 16-byte broadcast, S_w[k][c]
// conflict-free), a barrier, the 64 threads of the first columns add
// vh * 1e-6 into acc, every thread folds its 8 values into a running double
// sum, a barrier. The 320 columns that do not feed acc are thus computed
// and kept: the sum of all 384 is the block's checksum output, which the
// plain version computes too, so an error in any column of the product
// shows there.
//
// probe_vpu: one block of 1024 threads on one SM; thread t keeps elements
// t, t + 1024, ... in registers, kPer independent chains (3 at 8 x 384, 12
// at 32 x 384). mode 0 computes __fadd_rn(__fmul_rn(acc, 1.0000001f),
// 1e-9f), the TPU's multiply then add, bitwise the plain version's
// acc * 1.0000001 + 1e-9 in float32; mode 1 the fused fmaf, another
// rounding, timed only.
//
// probe_mxu: one block of 512 threads on one SM. The two (256, 256)
// matrices are 512 KB, more than an SM's 227 KB of shared memory, so acc
// ping-pongs between two global buffers (in L2), B is read through shared
// memory tiles, and __syncthreads() separates the steps: within one block
// that makes the previous step's global stores visible to its loads, which
// go through L2 (__ldcg). Each thread computes an 8 x 8 register tile of a
// 128-row half of the output (rows ty*8.., columns tx*4.. and 128 + tx*4..),
// from tiles of 32 along the inner dimension: A's 128 x 32 stored
// transposed and B's 32 x 256, 48 KB of dynamic shared memory. A product is
// 2 * 256^3 = 33.6 MFLOP; at one SM's 128 FMA lanes that is 131,072 clocks,
// about 66 us at 1.98 GHz, against about 9 us of L2 reads: the probe
// measures one SM's FP32 rate. With A = 1 and B = 1/16 every entry of every
// step is exactly 1, in any order of summation. A cluster of 16 blocks
// sharing acc through distributed shared memory is the Hopper design that
// would hold the chain on chip; it is queued, not built.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// utils/device_probe.py): probe_mxu 112 us a product, 0.30 TFLOP/s, 59% of
// one SM's FP32 peak (its shared-memory loads share the issue slots with
// the FMAs); probe_vpu 25 ns a multiply-then-add step and 12.8 ns a fused
// step, the fused chain at 0.50 TFLOP/s, 98% of one SM's peak;
// probe_matmuls 2.27 us a dependent step of one world, 0.17 TFLOP/s a SM
// (two block barriers a step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// probe_matmuls
constexpr int kRows = 8;          // rows of acc
constexpr int kInner = 64;        // columns of acc, rows of S
constexpr int kCols = 384;        // columns of S
constexpr int kChain = 16;        // dependent steps a trip
constexpr int kMatmulSmem = (kInner * kCols + kRows * kInner) * 4;

__global__ void __launch_bounds__(kCols, 1)
probe_matmuls_kernel(const float* __restrict__ vel,   // (W, 8, 64)
                     const float* __restrict__ s,     // (W, 64, 384)
                     float* __restrict__ out,         // (W, 8, 64)
                     double* __restrict__ checksum,   // (W,)
                     int trips) {
  extern __shared__ float smem[];
  float* s_w = smem;                                  // (64, 384)
  float* acc = smem + kInner * kCols;                 // (8, 64)
  __shared__ double partial[kCols / 32];
  const int w = blockIdx.x;
  const int c = threadIdx.x;
  const float* s_src = s + (size_t)w * kInner * kCols;
  for (int i = c; i < kInner * kCols; i += kCols) s_w[i] = s_src[i];
  for (int i = c; i < kRows * kInner; i += kCols)
    acc[i] = vel[(size_t)w * kRows * kInner + i];
  __syncthreads();

  double sum = 0.0;                    // this column's share of the checksum
  for (int trip = 0; trip < trips; ++trip) {
    for (int step = 0; step < kChain; ++step) {
      float vh[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) vh[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kInner; k += 4) {
        const float s0 = s_w[(k + 0) * kCols + c];
        const float s1 = s_w[(k + 1) * kCols + c];
        const float s2 = s_w[(k + 2) * kCols + c];
        const float s3 = s_w[(k + 3) * kCols + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 a4 =
              reinterpret_cast<const float4*>(acc + r * kInner + k)[0];
          vh[r] = fmaf(a4.x, s0, vh[r]);
          vh[r] = fmaf(a4.y, s1, vh[r]);
          vh[r] = fmaf(a4.z, s2, vh[r]);
          vh[r] = fmaf(a4.w, s3, vh[r]);
        }
      }
      __syncthreads();                 // every read of acc is done
      if (c < kInner) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r * kInner + c] =
              __fadd_rn(acc[r * kInner + c], __fmul_rn(vh[r], 1e-6f));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum += (double)vh[r];
      __syncthreads();                 // acc is the next step's
    }
  }
  for (int i = c; i < kRows * kInner; i += kCols)
    out[(size_t)w * kRows * kInner + i] = acc[i];
  double total = sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  if ((c & 31) == 0) partial[c >> 5] = total;
  __syncthreads();
  if (c == 0) {
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
constexpr int kHalf = 128;        // output rows a pass
constexpr int kK = 32;            // inner tile
constexpr int kMxuThreads = 512;  // 16 x 32 threads, 8 x 8 outputs each
constexpr int kMxuSmem = (kK * kHalf + kK * kN) * 4;

__global__ void __launch_bounds__(kMxuThreads, 1)
probe_mxu_kernel(const float* a, const float* __restrict__ b,
                 float* buf,                          // (2, 256, 256)
                 int steps) {
  extern __shared__ float smem[];
  float* as = smem;                                   // (32, 128): A^T tile
  float* bs = smem + kK * kHalf;                      // (32, 256)
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;
  for (int step = 0; step < steps; ++step) {
    const float* src = step == 0 ? a : buf + (size_t)((step - 1) & 1) * kN * kN;
    float* dst = buf + (size_t)(step & 1) * kN * kN;
    for (int half = 0; half < 2; ++half) {
      float accum[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) accum[i][j] = 0.0f;
      for (int k0 = 0; k0 < kN; k0 += kK) {
        // A's rows half*128.. x columns k0..k0+31, transposed: 1024 float4
        for (int q = tid; q < kHalf * kK / 4; q += kMxuThreads) {
          const int r = q % kHalf, c4 = q / kHalf;    // conflict-free stores
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              src + (size_t)(half * kHalf + r) * kN + k0 + c4 * 4));
          as[(c4 * 4 + 0) * kHalf + r] = v.x;
          as[(c4 * 4 + 1) * kHalf + r] = v.y;
          as[(c4 * 4 + 2) * kHalf + r] = v.z;
          as[(c4 * 4 + 3) * kHalf + r] = v.w;
        }
        // B's rows k0..k0+31: 2048 float4
        for (int q = tid; q < kK * kN / 4; q += kMxuThreads)
          reinterpret_cast<float4*>(bs)[q] = __ldg(
              reinterpret_cast<const float4*>(b + (size_t)k0 * kN) + q);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kK; ++kk) {
          const float4 a0 = reinterpret_cast<const float4*>(
              as + kk * kHalf + ty * 8)[0];
          const float4 a1 = reinterpret_cast<const float4*>(
              as + kk * kHalf + ty * 8)[1];
          const float4 b0 = reinterpret_cast<const float4*>(
              bs + kk * kN + tx * 4)[0];
          const float4 b1 = reinterpret_cast<const float4*>(
              bs + kk * kN + kHalf + tx * 4)[0];
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              accum[i][j] = fmaf(av[i], bv[j], accum[i][j]);
        }
        __syncthreads();               // the tiles are the next k0's
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = dst + (size_t)(half * kHalf + ty * 8 + i) * kN;
        float4 lo, hi;
        lo.x = accum[i][0] * 0.0625f; lo.y = accum[i][1] * 0.0625f;
        lo.z = accum[i][2] * 0.0625f; lo.w = accum[i][3] * 0.0625f;
        hi.x = accum[i][4] * 0.0625f; hi.y = accum[i][5] * 0.0625f;
        hi.z = accum[i][6] * 0.0625f; hi.w = accum[i][7] * 0.0625f;
        reinterpret_cast<float4*>(row + tx * 4)[0] = lo;
        reinterpret_cast<float4*>(row + kHalf + tx * 4)[0] = hi;
      }
    }
    __syncthreads();                   // dst is the next step's source
  }
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
  cudaError_t err = cudaFuncSetAttribute(
      probe_matmuls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMatmulSmem);
  if (err != cudaSuccess) return (int)err;
  probe_matmuls_kernel<<<worlds, kCols, kMatmulSmem, (cudaStream_t)stream>>>(
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
// steps >= 1; one block.
extern "C" int probe_mxu_launch(const void* a, const void* b, void* buf,
                                int steps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMxuSmem);
  if (err != cudaSuccess) return (int)err;
  probe_mxu_kernel<<<1, kMxuThreads, kMxuSmem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)buf, steps);
  return (int)cudaGetLastError();
}
