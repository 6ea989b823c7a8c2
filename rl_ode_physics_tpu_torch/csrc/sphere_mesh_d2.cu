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
// Both kernels evaluate one __device__ function per (probe, triangle) pair,
// written in the Pallas kernels' operation order (pallas_kernels.py:47-64
// and :89-105, with the region logic of ops/trimesh.py:_tri_vw). The
// library is built with -fmad=false: no multiply and add are contracted
// into an FMA, so every operation rounds as the plain PyTorch version's
// separate elementwise operations do, and the kernels equal it bit for bit.
//
// Bound: arithmetic. pair_d2 does 78 FP32 operations per pair (add, sub,
// mul, div; the comparisons, selects and clamps are not counted): 3 for ap,
// 6 for bp and cp, 30 for the six dot products d1..d6, 9 for va/vb/vc,
// 5 divisions and 8 adds and subs for the barycentric candidates, 12 for
// the offset d and 5 for its squared length; the tile kernel adds 1 for
// the running minimum (79). At the trimesh main path's
// shape (1,024 worlds x 16 slots x 3 probes = 49,152 probes against 9,216
// triangles, 453M pairs) that is 35.8 GFLOP, 0.53 ms at the data sheet's
// 67 TFLOP/s FP32 of the H100 SXM (a rate that counts an FMA as two
// operations; without FMA the kernel can reach half of it). The bytes are
// few: each probe is read once per tile from L2 and each tile's 9 x 128
// floats once per block, the output is 4 bytes per probe and tile.
//
// Design: the mesh is one table shared by every world, so the world batch
// is folded into the probes. The tile kernel runs one block per
// (128-triangle tile, 128 probes): the block stages the tile's 9 x 128
// floats in shared memory, each thread takes one probe, loops over the 128
// triangles (every thread reads the same shared word, a broadcast) and
// keeps a running minimum in a register; nothing but the minimum leaves
// the thread. The probe count needs no padding. The one-probe kernel runs
// one thread per triangle.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;            // triangles per tile (MESH_TILE)
constexpr int kProbes = 128;          // probes per block of the tile kernel
constexpr float kEps = 1e-9f;         // ops/trimesh.py _EPS

// clip to [0, 1] that keeps a NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Squared distance from p to its closest point on the triangle
// (v0, v0 + e1, v0 + e2), in the Pallas kernels' operation order.
__device__ __forceinline__ float pair_d2(
    float px, float py, float pz, float v0x, float v0y, float v0z,
    float e1x, float e1y, float e1z, float e2x, float e2y, float e2z) {
  const float apx = px - v0x, apy = py - v0y, apz = pz - v0z;
  const float d1 = e1x * apx + e1y * apy + e1z * apz;
  const float d2 = e2x * apx + e2y * apy + e2z * apz;
  const float bpx = apx - e1x, bpy = apy - e1y, bpz = apz - e1z;
  const float d3 = e1x * bpx + e1y * bpy + e1z * bpz;
  const float d4 = e2x * bpx + e2y * bpy + e2z * bpz;
  const float cpx = apx - e2x, cpy = apy - e2y, cpz = apz - e2z;
  const float d5 = e1x * cpx + e1y * cpy + e1z * cpz;
  const float d6 = e2x * cpx + e2y * cpy + e2z * cpz;

  // _tri_vw: barycentric (v, w) of the closest point
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom_ab = d1 - d3;
  const float v_ab = fabsf(denom_ab) > kEps ? d1 / denom_ab : 0.0f;
  const float denom_ac = d2 - d6;
  const float w_ac = fabsf(denom_ac) > kEps ? d2 / denom_ac : 0.0f;
  const float d43 = d4 - d3, d56 = d5 - d6;
  const float denom_bc = d43 + d56;
  const float w_bc = d43 / (fabsf(denom_bc) > kEps ? denom_bc : 1.0f);
  const float denom_in = va + vb + vc;
  const float safe_in = fabsf(denom_in) > kEps ? denom_in : 1.0f;
  float v = vb / safe_in;
  float w = vc / safe_in;

  // region masks, applied in reverse of Ericson's order so the first
  // region that matches has the last word
  const bool in_a = (d1 <= 0.0f) && (d2 <= 0.0f);
  const bool in_b = (d3 >= 0.0f) && (d4 <= d3);
  const bool in_c = (d6 >= 0.0f) && (d5 <= d6);
  const bool on_ab = (vc <= 0.0f) && (d1 >= 0.0f) && (d3 <= 0.0f);
  const bool on_ac = (vb <= 0.0f) && (d2 >= 0.0f) && (d6 <= 0.0f);
  const bool on_bc = (va <= 0.0f) && (d43 >= 0.0f) && (d56 >= 0.0f);
  if (on_bc) { const float c = clip01(w_bc); v = 1.0f - c; w = c; }
  if (on_ac) { v = 0.0f; w = clip01(w_ac); }
  if (on_ab) { v = clip01(v_ab); w = 0.0f; }
  if (in_c) { v = 0.0f; w = 1.0f; }
  if (in_b) { v = 1.0f; w = 0.0f; }
  if (in_a) { v = 0.0f; w = 0.0f; }

  const float dx = apx - v * e1x - w * e2x;
  const float dy = apy - v * e1y - w * e2y;
  const float dz = apz - v * e1z - w * e2z;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kProbes)
d2_tiles_kernel(const float* __restrict__ probes,    // (P, 3)
                const float* __restrict__ v0t,       // (3, T)
                const float* __restrict__ e1t,       // (3, T)
                const float* __restrict__ e2t,       // (3, T)
                float* __restrict__ out,             // (P, T / kTile)
                int P, int T) {
  __shared__ float tri[9][kTile];
  const int tile = blockIdx.y;
  const int nt = T / kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const size_t t = (size_t)tile * kTile + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tri[c][i] = v0t[(size_t)c * T + t];
      tri[3 + c][i] = e1t[(size_t)c * T + t];
      tri[6 + c][i] = e2t[(size_t)c * T + t];
    }
  }
  __syncthreads();

  const int p = blockIdx.x * kProbes + threadIdx.x;
  if (p >= P) return;
  const float px = probes[(size_t)p * 3 + 0];
  const float py = probes[(size_t)p * 3 + 1];
  const float pz = probes[(size_t)p * 3 + 2];
  float best = INFINITY;
  for (int i = 0; i < kTile; ++i) {
    const float d = pair_d2(px, py, pz, tri[0][i], tri[1][i], tri[2][i],
                            tri[3][i], tri[4][i], tri[5][i],
                            tri[6][i], tri[7][i], tri[8][i]);
    // a minimum that keeps a NaN, as torch.amin and jnp.min do
    best = (d < best || d != d) ? d : best;
  }
  out[(size_t)p * nt + tile] = best;
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
  out[t] = pair_d2(center[0], center[1], center[2],
                   v0t[t], v0t[T + t], v0t[2 * (size_t)T + t],
                   e1t[t], e1t[T + t], e1t[2 * (size_t)T + t],
                   e2t[t], e2t[T + t], e2t[2 * (size_t)T + t]);
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
  d2_tiles_kernel<<<grid, kProbes, 0, (cudaStream_t)stream>>>(
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
