// Squared sphere-to-triangle distances for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of rl_ode_physics_tpu/ops/pallas_kernels.py:
//   sphere_mesh_d2_tiles (_d2_tiles_kernel): P probes against all T
//     triangles; per pair the squared distance to Ericson's closest point
//     on the triangle, reduced to its minimum over each 128-triangle tile:
//     out (P, T/128);
//   sphere_mesh_d2 (_d2_kernel): one probe against T triangles, the squared
//     distance per triangle: out (T/128, 128).
// Triangle data comes component-major, v0/e1/e2 each (3, T), as on the TPU.
//
// Bound: arithmetic. The reference arithmetic (pallas_kernels.py:89-105
// with the region logic of ops/trimesh.py:_tri_vw) does 78 FP32 operations
// per pair (add, sub, mul, div; comparisons, selects and clamps are not
// counted): 3 for ap, 6 for bp and cp, 30 for the six dot products, 9 for
// va/vb/vc, 5 divisions and 8 adds and subs for the barycentric candidates,
// 12 for the offset and 5 for its squared length; the tile minimum adds 1
// (79). The bound counts those 79, whatever this file executes, so that the
// yardstick does not shrink with the implementation: at the trimesh main
// path's shape (1,024 worlds x 16 slots x 3 probes = 49,152 probes against
// 9,216 triangles, 453M pairs) 35.8 GFLOP, 0.53 ms at the data sheet's
// 67 TFLOP/s FP32 of the H100 SXM. The bytes are few: probes, the mesh and
// 4 bytes of output per probe and tile.
//
// Design. The kernel is bound by the count of machine operations it
// executes, so the design executes fewer for the same function:
//   * What belongs to the triangle alone is computed once per triangle
//     while its tile is staged in shared memory: a = e1.e1, b = e1.e2,
//     c = e2.e2. With s = e1.ap and t = e2.ap the other four dot products
//     are subtractions (d3 = s - a, d4 = t - b, d5 = s - b, d6 = t - c),
//     vb = c s - b t, vc = a t - b s, and every denominator of _tri_vw is a
//     constant of the triangle (d1 - d3 = a, d2 - d6 = c,
//     (d4 - d3) + (d5 - d6) = (a - b) + (c - b),
//     va + vb + vc = a c - b^2 = det). Their guarded reciprocals (the 1e-9
//     guards of trimesh._EPS, which the padded triangles with zero edges go
//     through) are staged too: a pair divides nowhere. The interior's
//     v = vb/det and w = vc/det come straight from the staged a/det, b/det
//     and c/det; they carry the signs of vb and vc for the region tests,
//     and va <= 0 is v + w >= 1 (>= det where the guard replaced 1/det by 1).
//   * A vertex region's (v, w) is what the clipped formula of an edge
//     through that vertex gives, so the six region selections fold into
//     three, in _tri_vw's priority; the clip is the multiply's saturation.
//     What is left outside the triangle after the two edges through A is
//     the region of edge BC, so va <= 0 alone selects it.
//   * Multiply-adds are fused (fmaf, written out so the order is fixed).
//   * A staged triangle is 20 floats, five 16-byte shared loads that every
//     thread of a warp reads as a broadcast, and each thread carries
//     kPerThread probes with their running minima in registers through the
//     triangle loop, so one shared load serves several pairs.
// One block per (128-triangle tile, kThreads x kPerThread probes). The mesh
// is one table shared by every world, so the world batch is folded into
// the probes; the probe count needs no padding. A NaN coordinate makes
// every comparison false, takes the interior formula and comes out as NaN
// through a minimum that keeps it, as in the plain version. Tensor cores,
// TMA and clusters have no use here: there is no matrix product, and a
// block's whole input is a 10 KB tile that it computes from 4.6 KB.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W with utils/kernel_ab.py
// (this file and copies of it with one constant changed, timed in turns in
// one process), 49,152 probes x 9,216 triangles: 56 SASS operations per
// pair in the loop (cuobjdump -sass: 14 FFMA, 13 FSETP, 11 FADD, 8 FMUL,
// 3 PLOP3, 3 FSEL, 1 FMNMX, and the loads and the loop shared by 6 pairs),
// 56 registers, no spills, 10 KB of shared memory, 0.91-0.92 ms with 6
// probes a thread (0.98 ms with 1, 0.94 with 2, 0.95 with 4, 0.93 with 8
// and 64 registers; 64 or 256 threads a block: 0.91-0.92), against
// 2.82-2.84 ms and 211 SASS operations per pair for the kernel before it.
// The kernel retires nearly one operation per scheduler and clock, so only
// a shorter sequence would make it faster.
//
// The kernels match their plain versions (ops/trimesh.py) within rtol 1e-5,
// atol 1e-6, not bit for bit: fused multiply-adds, d1 - e1.e1 and the
// reciprocals round differently, and a probe on a region border may take
// the neighbouring region's formula. The squared distance is continuous
// across the borders and stationary in (v, w) at the closest point, so
// either moves it only at roundoff. ops/trimesh.py:_d2_kernel_order is this
// file's arithmetic in PyTorch, for the tests.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;            // triangles per tile (MESH_TILE)
constexpr int kThreads = 128;         // threads per block of the tile kernel
constexpr int kPerThread = 6;         // probes a thread carries
constexpr int kProbes = kThreads * kPerThread;   // probes per block
constexpr float kEps = 1e-9f;         // ops/trimesh.py _EPS

// A triangle as the pair function reads it, five 16-byte words, with
// det = a c - b^2 and every reciprocal guarded:
//   q0 = (v0, a), q1 = (e1, b), q2 = (e2, c),
//   q3 = (1/a, 1/c, 1/((a - b) + (c - b)), det/det),
//   q4 = (a/det, b/det, c/det, unused).
struct Tri {
  float4 q0, q1, q2, q3, q4;
};

__device__ __forceinline__ float guarded_reciprocal(float x, float otherwise) {
  return fabsf(x) > kEps ? 1.0f / x : otherwise;
}

__device__ __forceinline__ Tri make_tri(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z) {
  const float a = fmaf(e1z, e1z, fmaf(e1y, e1y, e1x * e1x));
  const float b = fmaf(e1z, e2z, fmaf(e1y, e2y, e1x * e2x));
  const float c = fmaf(e2z, e2z, fmaf(e2y, e2y, e2x * e2x));
  const float det = fmaf(a, c, -(b * b));
  const float inv_det = guarded_reciprocal(det, 1.0f);
  Tri tri;
  tri.q0 = make_float4(v0x, v0y, v0z, a);
  tri.q1 = make_float4(e1x, e1y, e1z, b);
  tri.q2 = make_float4(e2x, e2y, e2z, c);
  tri.q3 = make_float4(guarded_reciprocal(a, 0.0f),
                       guarded_reciprocal(c, 0.0f),
                       guarded_reciprocal((a - b) + (c - b), 1.0f),
                       det * inv_det);
  tri.q4 = make_float4(a * inv_det, b * inv_det, c * inv_det, 0.0f);
  return tri;
}

// a minimum that keeps a NaN, as torch.amin and jnp.min do
__device__ __forceinline__ float min_keep_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// Squared distance from p to its closest point on the triangle. The CPU
// tests hold ops/trimesh.py:_d2_kernel_order, this function and make_tri
// in PyTorch, to the plain version: edit that function with these two.
__device__ __forceinline__ float pair_d2(float px, float py, float pz,
                                         const Tri& tri) {
  const float apx = px - tri.q0.x, apy = py - tri.q0.y, apz = pz - tri.q0.z;
  const float e1x = tri.q1.x, e1y = tri.q1.y, e1z = tri.q1.z;
  const float e2x = tri.q2.x, e2y = tri.q2.y, e2z = tri.q2.z;
  const float a = tri.q0.w, b = tri.q1.w, c = tri.q2.w;
  const float s = fmaf(e1z, apz, fmaf(e1y, apy, e1x * apx));
  const float t = fmaf(e2z, apz, fmaf(e2y, apy, e2x * apx));
  const float d3 = s - a, d4 = t - b, d5 = s - b, d6 = t - c;
  const float d43 = d4 - d3;
  // the interior's barycentrics vb/det and vc/det, with the signs of vb, vc
  const float v_in = fmaf(tri.q4.z, s, -(tri.q4.y * t));
  const float w_in = fmaf(tri.q4.x, t, -(tri.q4.y * s));

  const bool in_a = (s <= 0.0f) & (t <= 0.0f);
  const bool in_b = (d3 >= 0.0f) & (d43 <= 0.0f);
  const bool in_c = (d6 >= 0.0f) & (d5 <= d6);
  const bool on_ab = (w_in <= 0.0f) & (s >= 0.0f) & (d3 <= 0.0f);
  const bool on_ac = (v_in <= 0.0f) & (t >= 0.0f) & (d6 <= 0.0f);
  const bool on_bc = (v_in + w_in) >= tri.q3.w;          // va <= 0
  const bool use_ab = in_a | in_b | (on_ab & !in_c);
  const bool use_ac = in_c | on_ac;

  const float u = __saturatef(d43 * tri.q3.z);
  float v = on_bc ? 1.0f - u : v_in;
  float w = on_bc ? u : w_in;
  v = use_ac ? 0.0f : v;
  w = use_ac ? __saturatef(t * tri.q3.y) : w;
  v = use_ab ? __saturatef(s * tri.q3.x) : v;
  w = use_ab ? 0.0f : w;

  const float dx = fmaf(-w, e2x, fmaf(-v, e1x, apx));
  const float dy = fmaf(-w, e2y, fmaf(-v, e1y, apy));
  const float dz = fmaf(-w, e2z, fmaf(-v, e1z, apz));
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

__global__ void __launch_bounds__(kThreads)
d2_tiles_kernel(const float* __restrict__ probes,    // (P, 3)
                const float* __restrict__ v0t,       // (3, T)
                const float* __restrict__ e1t,       // (3, T)
                const float* __restrict__ e2t,       // (3, T)
                float* __restrict__ out,             // (P, T / kTile)
                int P, int T) {
  __shared__ Tri tris[kTile];
  const int tile = blockIdx.y;
  const int nt = T / kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t t = (size_t)tile * kTile + i;
    tris[i] = make_tri(v0t[t], v0t[T + t], v0t[2 * (size_t)T + t],
                       e1t[t], e1t[T + t], e1t[2 * (size_t)T + t],
                       e2t[t], e2t[T + t], e2t[2 * (size_t)T + t]);
  }
  __syncthreads();

  // probe j of this thread; past the end it repeats the last probe and is
  // not stored
  const int first = blockIdx.x * kProbes + threadIdx.x;
  float px[kPerThread], py[kPerThread], pz[kPerThread], best[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = min(first + j * kThreads, P - 1);
    px[j] = probes[(size_t)p * 3 + 0];
    py[j] = probes[(size_t)p * 3 + 1];
    pz[j] = probes[(size_t)p * 3 + 2];
    best[j] = INFINITY;
  }
  for (int i = 0; i < kTile; ++i) {
    const Tri tri = tris[i];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      best[j] = min_keep_nan(best[j], pair_d2(px[j], py[j], pz[j], tri));
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = first + j * kThreads;
    if (p < P) out[(size_t)p * nt + tile] = best[j];
  }
}

__global__ void __launch_bounds__(kTile)
d2_kernel(const float* __restrict__ center,          // (3,)
          const float* __restrict__ v0t,             // (3, T)
          const float* __restrict__ e1t,
          const float* __restrict__ e2t,
          float* __restrict__ out,                   // (T / kTile, kTile)
          int T) {
  const int t = blockIdx.x * kTile + threadIdx.x;
  if (t >= T) return;
  const Tri tri = make_tri(v0t[t], v0t[T + t], v0t[2 * (size_t)T + t],
                           e1t[t], e1t[T + t], e1t[2 * (size_t)T + t],
                           e2t[t], e2t[T + t], e2t[2 * (size_t)T + t]);
  out[t] = pair_d2(center[0], center[1], center[2], tri);
}

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns the launch's
// cudaError_t (0 on success). Pointers are device pointers; T is a
// multiple of 128 and P >= 1.
extern "C" int sphere_mesh_d2_tiles_launch(const void* probes, const void* v0t,
                                           const void* e1t, const void* e2t,
                                           void* out, int P, int T,
                                           void* stream) {
  const dim3 grid((P + kProbes - 1) / kProbes, T / kTile);
  d2_tiles_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)probes, (const float*)v0t, (const float*)e1t,
      (const float*)e2t, (float*)out, P, T);
  return (int)cudaGetLastError();
}

extern "C" int sphere_mesh_d2_launch(const void* center, const void* v0t,
                                     const void* e1t, const void* e2t,
                                     void* out, int T, void* stream) {
  d2_kernel<<<T / kTile, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)center, (const float*)v0t, (const float*)e1t,
      (const float*)e2t, (float*)out, T);
  return (int)cudaGetLastError();
}
