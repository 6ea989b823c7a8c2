// Squared sphere-to-triangle distances for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of rl_ode_physics_tpu/ops/pallas_kernels.py:
//   sphere_mesh_d2_tiles (_d2_tiles_kernel): P probes against all T
//     triangles; per pair the squared distance to Ericson's closest point
//     on the triangle, reduced to its minimum over each 128-triangle tile:
//     out (P, T/128);
//   sphere_mesh_d2 (_d2_kernel): one centre against T triangles, the squared
//     distance per triangle: out (T/128, 128). Here C centres go in one
//     launch, out (C, T/128, 128): the explicit batch axis that jax.vmap
//     over the Pallas call adds as a grid axis.
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
// The per-triangle kernel (d2_kernel) writes 4 bytes per pair, so at a wide
// query its bound is the output: C = 15,360 centres (1,024 worlds x 15
// spheres) x 9,216 triangles is 566 MB, 0.169 ms at 3.35 TB/s, beside
// 0.165 ms for its 78 operations per pair. At a narrow query (C = 1, 15)
// both bounds are far shorter than a launch takes to start and retire, so
// all a design can do there is to be one launch. One thread per triangle
// stages its Tri in registers (the reciprocals are paid once per triangle
// and group, not per pair) and loops over a group of centres, which the
// block holds in shared memory and every thread reads as a broadcast; each
// store is a warp's 32 consecutive floats of one centre's row, so the
// output goes out in full lines, with a streaming store (__stcs): nothing
// of a wide query's output is read before it has left L2. One block per
// (group of centres, 128-triangle tile). The launcher sizes the group from
// C: a narrow query gives every centre its own blocks (72 tiles alone
// cannot fill 132 SMs), a wide one grows the group up to kMaxGroup so that
// staging the triangle is amortised. As for the tile kernel, tensor cores,
// TMA and clusters have no use: no matrix product, and a block reads 4.6 KB.
//
// Measured like the tile kernel (utils/kernel_ab.py, NVIDIA H100 80GB HBM3 at
// 700 W, T = 9,216, old and new in one process; an empty kernel reads
// 0.0017 ms under the same timer). One query of C = 1: 0.0027 ms (the
// kernel before it: 0.0027); C = 15: 0.0034 ms in one launch against
// 0.037 ms in fifteen; C = 15,360: 0.298 ms, 1.8x the 0.169 ms bound,
// against 60-116 ms in 15,360 launches (two runs), the host's launch rate. At
// that width the kernel issues like the tile kernel (which takes 0.285 ms
// for as many pairs), so what was left to tune was the loop: groups of at
// most 8, 16, 32, 64, 128 centres read 0.416, 0.369, 0.346, 0.335, 0.332 ms
// with the loop unrolled 4 times; unrolled 1, 4, 8, 16 times at 64 and 128
// centres 0.334, 0.335, 0.322, 0.298 ms (48 registers, no spills). A plain
// store in place of __stcs read the same (0.335). Blocks of 32, 64 or 256
// threads, or a group that grows four times sooner, moved C = 1, 15 and 64
// by less than 0.0004 ms: the narrow queries are the launch and one
// dependent chain of loads, reciprocals and a store, whatever the grid.
//
// The kernels match their plain versions (ops/trimesh.py) within rtol 1e-5,
// atol 1e-6, not bit for bit: fused multiply-adds, d1 - e1.e1 and the
// reciprocals round differently, and a probe on a region border may take
// the neighbouring region's formula. The squared distance is continuous
// across the borders and stationary in (v, w) at the closest point, so
// either moves it only at roundoff. ops/trimesh.py:_d2_kernel_order is this
// file's arithmetic in PyTorch, for the tests.
//
// float64. Both kernels are templates on the element type, so a float64
// step (the conformance configuration) runs the same arithmetic in double:
// fma for fmaf, a clamp for __saturatef, a NaN-keeping minimum written out
// (min.NaN has no f64 form), and the 1e-9 guards in double, as the plain
// version's comparisons are. The staged triangle is then 160 bytes, 20 KB
// a tile. The H100 SXM's FP64 rate outside the tensor cores is 34 TFLOP/s
// on the data sheet, half the FP32 rate, so the f64 bound is twice the
// f32 one; chip_smoke.py prints both, and the f64 instances' errors
// against the plain version in double. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W: the tile kernel 2.07 ms at 49,152 probes x 9,216
// triangles (1.96 times its FP64 bound; float32 0.91 ms), the per-triangle
// kernel 0.59 ms at 15,360 centres (float32 0.30 ms).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;            // triangles per tile (MESH_TILE)
constexpr int kThreads = 128;         // threads per block of the tile kernel
constexpr int kPerThread = 6;         // probes a thread carries
constexpr int kProbes = kThreads * kPerThread;   // probes per block
constexpr double kEps = 1e-9;         // ops/trimesh.py _EPS
constexpr int kMaxGroup = 128;        // centres a block of d2_kernel loops over
static_assert(kMaxGroup <= kTile, "one thread stages one centre");
// d2_kernel's launcher grows the group only once the grid has this many
// blocks: 132 SMs x 16 resident blocks of 128 threads
constexpr int kFillBlocks = 132 * 16;

// four values of T in one aligned word: float4's layout for float
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T x, y, z, w;
};

template <typename T>
__device__ __forceinline__ Quad<T> quad(T x, T y, T z, T w) {
  Quad<T> q;
  q.x = x; q.y = y; q.z = z; q.w = w;
  return q;
}

// A triangle as the pair function reads it, five aligned words, with
// det = a c - b^2 and every reciprocal guarded:
//   q0 = (v0, a), q1 = (e1, b), q2 = (e2, c),
//   q3 = (1/a, 1/c, 1/((a - b) + (c - b)), det/det),
//   q4 = (a/det, b/det, c/det, unused).
template <typename T>
struct Tri {
  Quad<T> q0, q1, q2, q3, q4;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float saturate(float x) { return __saturatef(x); }
__device__ __forceinline__ double saturate(double x) {
  // __saturatef's contract: NaN gives 0
  return x > 0.0 ? (x < 1.0 ? x : 1.0) : 0.0;
}

// a minimum that keeps a NaN, as torch.amin and jnp.min do
__device__ __forceinline__ float min_keep_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ double min_keep_nan(double x, double y) {
  return (x != x) ? x : ((y != y) ? y : fmin(x, y));
}

template <typename T>
__device__ __forceinline__ T guarded_reciprocal(T x, T otherwise) {
  return fabs(x) > T(kEps) ? T(1) / x : otherwise;
}

template <typename T>
__device__ __forceinline__ Tri<T> make_tri(
    T v0x, T v0y, T v0z, T e1x, T e1y, T e1z, T e2x, T e2y, T e2z) {
  const T a = fma_t(e1z, e1z, fma_t(e1y, e1y, e1x * e1x));
  const T b = fma_t(e1z, e2z, fma_t(e1y, e2y, e1x * e2x));
  const T c = fma_t(e2z, e2z, fma_t(e2y, e2y, e2x * e2x));
  const T det = fma_t(a, c, -(b * b));
  const T inv_det = guarded_reciprocal(det, T(1));
  Tri<T> tri;
  tri.q0 = quad(v0x, v0y, v0z, a);
  tri.q1 = quad(e1x, e1y, e1z, b);
  tri.q2 = quad(e2x, e2y, e2z, c);
  tri.q3 = quad(guarded_reciprocal(a, T(0)), guarded_reciprocal(c, T(0)),
                guarded_reciprocal((a - b) + (c - b), T(1)), det * inv_det);
  tri.q4 = quad(a * inv_det, b * inv_det, c * inv_det, T(0));
  return tri;
}

// Squared distance from p to its closest point on the triangle. The CPU
// tests hold ops/trimesh.py:_d2_kernel_order, this function and make_tri
// in PyTorch, to the plain version: edit that function with these two.
template <typename T>
__device__ __forceinline__ T pair_d2(T px, T py, T pz, const Tri<T>& tri) {
  const T apx = px - tri.q0.x, apy = py - tri.q0.y, apz = pz - tri.q0.z;
  const T e1x = tri.q1.x, e1y = tri.q1.y, e1z = tri.q1.z;
  const T e2x = tri.q2.x, e2y = tri.q2.y, e2z = tri.q2.z;
  const T a = tri.q0.w, b = tri.q1.w, c = tri.q2.w;
  const T s = fma_t(e1z, apz, fma_t(e1y, apy, e1x * apx));
  const T t = fma_t(e2z, apz, fma_t(e2y, apy, e2x * apx));
  const T d3 = s - a, d4 = t - b, d5 = s - b, d6 = t - c;
  const T d43 = d4 - d3;
  // the interior's barycentrics vb/det and vc/det, with the signs of vb, vc
  const T v_in = fma_t(tri.q4.z, s, -(tri.q4.y * t));
  const T w_in = fma_t(tri.q4.x, t, -(tri.q4.y * s));

  const bool in_a = (s <= T(0)) & (t <= T(0));
  const bool in_b = (d3 >= T(0)) & (d43 <= T(0));
  const bool in_c = (d6 >= T(0)) & (d5 <= d6);
  const bool on_ab = (w_in <= T(0)) & (s >= T(0)) & (d3 <= T(0));
  const bool on_ac = (v_in <= T(0)) & (t >= T(0)) & (d6 <= T(0));
  const bool on_bc = (v_in + w_in) >= tri.q3.w;          // va <= 0
  const bool use_ab = in_a | in_b | (on_ab & !in_c);
  const bool use_ac = in_c | on_ac;

  const T u = saturate(d43 * tri.q3.z);
  T v = on_bc ? T(1) - u : v_in;
  T w = on_bc ? u : w_in;
  v = use_ac ? T(0) : v;
  w = use_ac ? saturate(t * tri.q3.y) : w;
  v = use_ab ? saturate(s * tri.q3.x) : v;
  w = use_ab ? T(0) : w;

  const T dx = fma_t(-w, e2x, fma_t(-v, e1x, apx));
  const T dy = fma_t(-w, e2y, fma_t(-v, e1y, apy));
  const T dz = fma_t(-w, e2z, fma_t(-v, e1z, apz));
  return fma_t(dz, dz, fma_t(dy, dy, dx * dx));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
d2_tiles_kernel(const T* __restrict__ probes,    // (P, 3)
                const T* __restrict__ v0t,       // (3, T)
                const T* __restrict__ e1t,       // (3, T)
                const T* __restrict__ e2t,       // (3, T)
                T* __restrict__ out,             // (P, T / kTile)
                int P, int T_) {
  __shared__ Tri<T> tris[kTile];
  const int tile = blockIdx.y;
  const int nt = T_ / kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t t = (size_t)tile * kTile + i;
    tris[i] = make_tri(v0t[t], v0t[T_ + t], v0t[2 * (size_t)T_ + t],
                       e1t[t], e1t[T_ + t], e1t[2 * (size_t)T_ + t],
                       e2t[t], e2t[T_ + t], e2t[2 * (size_t)T_ + t]);
  }
  __syncthreads();

  // probe j of this thread; past the end it repeats the last probe and is
  // not stored
  const int first = blockIdx.x * kProbes + threadIdx.x;
  T px[kPerThread], py[kPerThread], pz[kPerThread], best[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = min(first + j * kThreads, P - 1);
    px[j] = probes[(size_t)p * 3 + 0];
    py[j] = probes[(size_t)p * 3 + 1];
    pz[j] = probes[(size_t)p * 3 + 2];
    best[j] = T(INFINITY);
  }
  for (int i = 0; i < kTile; ++i) {
    const Tri<T> tri = tris[i];
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

template <typename T>
__global__ void __launch_bounds__(kTile)
d2_kernel(const T* __restrict__ centers,         // (C, 3)
          const T* __restrict__ v0t,             // (3, T)
          const T* __restrict__ e1t,
          const T* __restrict__ e2t,
          T* __restrict__ out,                   // (C, T / kTile, kTile)
          int C, int T_, int group) {
  __shared__ Quad<T> cs[kMaxGroup];
  const int first = blockIdx.x * group;
  const int n = min(group, C - first);
  if (threadIdx.x < n) {
    const T* c = centers + (size_t)(first + threadIdx.x) * 3;
    cs[threadIdx.x] = quad(c[0], c[1], c[2], T(0));
  }
  const size_t t = (size_t)blockIdx.y * kTile + threadIdx.x;
  const Tri<T> tri = make_tri(v0t[t], v0t[T_ + t], v0t[2 * (size_t)T_ + t],
                              e1t[t], e1t[T_ + t], e1t[2 * (size_t)T_ + t],
                              e2t[t], e2t[T_ + t], e2t[2 * (size_t)T_ + t]);
  __syncthreads();
  T* row = out + (size_t)first * T_ + t;
#pragma unroll 16
  for (int j = 0; j < n; ++j) {
    const Quad<T> c = cs[j];
    __stcs(row + (size_t)j * T_, pair_d2(c.x, c.y, c.z, tri));
  }
}

template <typename T>
int tiles_launch(const void* probes, const void* v0t, const void* e1t,
                 const void* e2t, void* out, int P, int T_, void* stream) {
  const dim3 grid((P + kProbes - 1) / kProbes, T_ / kTile);
  d2_tiles_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)probes, (const T*)v0t, (const T*)e1t, (const T*)e2t,
      (T*)out, P, T_);
  return (int)cudaGetLastError();
}

template <typename T>
int batch_launch(const void* centers, const void* v0t, const void* e1t,
                 const void* e2t, void* out, int C, int T_, void* stream) {
  const int tiles = T_ / kTile;
  const long long alone = (long long)C * tiles;      // blocks at group 1
  const long long wanted = (alone + kFillBlocks - 1) / kFillBlocks;
  const int group = wanted < kMaxGroup ? (int)wanted : kMaxGroup;
  const dim3 grid((C + group - 1) / group, tiles);
  d2_kernel<T><<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const T*)centers, (const T*)v0t, (const T*)e1t, (const T*)e2t,
      (T*)out, C, T_, group);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns the launch's
// cudaError_t (0 on success). Pointers are device pointers to float, or to
// double for the _f64 launchers; T is a multiple of 128 with at most
// 65,535 tiles, and P >= 1.
extern "C" int sphere_mesh_d2_tiles_launch(const void* probes, const void* v0t,
                                           const void* e1t, const void* e2t,
                                           void* out, int P, int T,
                                           void* stream) {
  return tiles_launch<float>(probes, v0t, e1t, e2t, out, P, T, stream);
}

extern "C" int sphere_mesh_d2_tiles_launch_f64(
    const void* probes, const void* v0t, const void* e1t, const void* e2t,
    void* out, int P, int T, void* stream) {
  return tiles_launch<double>(probes, v0t, e1t, e2t, out, P, T, stream);
}

// C >= 1 centres in one launch, whatever C is.
extern "C" int sphere_mesh_d2_batch_launch(const void* centers,
                                           const void* v0t,
                                           const void* e1t, const void* e2t,
                                           void* out, int C, int T,
                                           void* stream) {
  return batch_launch<float>(centers, v0t, e1t, e2t, out, C, T, stream);
}

extern "C" int sphere_mesh_d2_batch_launch_f64(
    const void* centers, const void* v0t, const void* e1t, const void* e2t,
    void* out, int C, int T, void* stream) {
  return batch_launch<double>(centers, v0t, e1t, e2t, out, C, T, stream);
}
