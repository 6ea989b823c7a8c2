// Sequential projected Gauss-Seidel for Hopper (sm_90a): every sweep of one
// PGS solve, joint rows included, for every world, in one launch.
//
// Replaces no Pallas kernel. It replaces the JAX package's device loop of
// solve_pgs: a lax.scan over the contact rows inside a lax.fori_loop over
// the sweeps (rl_ode_physics_tpu/ops/solver.py:201, scan :285, fori :324),
// with the sequential joint pass joint_iteration_seq
// (rl_ode_physics_tpu/ops/joints.py:525) after each contact sweep. Under
// jit that is one program on the TPU; in PyTorch the same loop is some 30
// launches on (B,) tensors a row (ops/solver.py:pgs_sweeps_plain, the
// plain version, which this kernel rounds like), bounded by a host read.
//
// What it computes, per world, for each of `iterations` sweeps:
//   * the contact rows in buffer order, each its normal axis, then t1, then
//     t2 (friction_mode 0 skips the friction axes):
//       dλ = ω·((target − v_rel·axis) − cfm_term·λ) / d
//       λ' = max(λ + dλ, 0)            normal
//       λ' = clamp(λ + dλ, −b, b)      friction; b = ∞ (mode 1), μ·λ_n
//                                      (mode 2), the row's μ or ∞ (mode 3)
//       dλ = λ' − λ, λ += dλ, and ∓axis·dλ applied to the two bodies
//       through their inverse mass and world inverse inertia;
//   * then, given joint rows, the bilateral rows in order with the
//     ops/joints.py:joint_iteration_seq arithmetic (d_seq, lob/hib).
// With no contact rows (C = 0) and ω = 1 it is DANTZIG's joint passes.
//
// Layout, chosen for one thread per world. The rows of a sweep depend on
// each other (row i reads what row i − 1 wrote), and so do a row's three
// axes (the friction bound reads the new λ_n, and each axis reads the
// velocities the one before wrote). ROADMAP's first sketch, a warp for a
// row's three axes, therefore has nothing to spread over, and lanes on
// the two bodies' 6-vectors would buy a few operations of a ~25-operation
// chain with shuffles that cost as much. The one parallel axis is the
// world: thread t of a block steps world blockIdx.x·W + t, W = 32 worlds
// a block (fewer where N is large), with no barrier and no shared state
// between threads. The wrapper (ops/pgs_kernel.py) packs the rows with
// the worlds innermost, so that a warp's 32 reads of one field of row c
// are one coalesced request:
//   rec  (C, 40, B): r_a r_b n t1 t2 (3 each) | d_n d_t1 d_t2 | target |
//                    μ (mode 3) | inv_m_a inv_m_b | inv_i_a, inv_i_b
//                    (row-major 3x3 each)
//   idx  (C, 3, B) int32: a, b, live
//   jrec (R, 21, B): n wa wb | inv_m_a inv_m_b | ang_resp_a ang_resp_b |
//                    d_seq rhs lob hib;  jidx (R, 3, B): a, b, live
//   lam  (3, C, B) and jlam (R, B): the impulses, updated in place.
// A world's (N, 6) velocities live in shared memory for the whole solve,
// stored [slot][component][thread] so that the warp's 32 accesses to one
// component fall in 32 banks (two passes in float64). They take
// W·N·6·sizeof(T) bytes, at most 48 KB a block without an opt-in: W
// shrinks as N grows, and the wrapper refuses N·6·sizeof(T) > 48 KB
// (N > 1,024 slots in float64, 2,048 in float32).
//
// No host read: each thread finds its world's last live contact row and
// joint row on the device, once, and skips the dead rows before it. A dead
// row changes nothing in the plain loop (its dλ is 0), so the result is
// the plain loop's.
//
// Rounding follows the plain version on the CPU: each operation is
// rounded as PyTorch rounds it there, in its order ((x0 + x1) + x2 for a
// 3-sum; ω, cfm_term and μ rounded to T first), built with -fmad=false so
// that no multiply and add are fused that PyTorch rounds twice (XLA fuses
// them: ROADMAP's trap table). The one fused multiply-add of the plain
// version, torch.linalg.cross's x1·y2 − x2·y1 = fma(x1, y2, −x2·y1) on the
// CPU, is written as that fma (cross_c). Division is IEEE (nvcc's default
// -prec-div=true). On the card the plain version's own kernels may fuse
// otherwise, so there the two agree to roundoff (chip_smoke.py prints the
// gap).
//
// Bound. Device memory: each live row's 40 values, every row's 3 ints,
// the velocities in and out, λ in and out, ~10 KB a world in float64 at
// 30 live rows (a few µs for 1,024 worlds at 3.35 TB/s); the arithmetic,
// ~330 operations a row and sweep, is smaller still against 34 TFLOP/s
// FP64. What bounds it is the latency of the dependent chain: sweeps ×
// live rows × 3 axes, each axis ~20 dependent operations (velocity
// gather, cross, 3-sum, residual, division, clamp, impulse, cross,
// 3-sum, store) plus a shared-memory round trip; utils/bounds.pgs_bound
// reckons its floor at 4 cycles an operation at 1.98 GHz. Many worlds run
// side by side to cover that latency; one world takes as long as 1,024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowFields = 40;
constexpr int kJointFields = 21;
constexpr int kMaxWorlds = 32;           // worlds (threads) a block
constexpr int kSharedBytes = 48 * 1024;  // without cudaFuncSetAttribute

enum FrictionMode { kNoFriction = 0, kMuInf = 1, kMuGlobal = 2,
                    kMuPerRow = 3 };

// field offsets of a contact row record
enum { kRa = 0, kRb = 3, kN = 6, kT1 = 9, kT2 = 12, kDn = 15, kTarget = 18,
       kMu = 19, kImA = 20, kImB = 21, kIiA = 22, kIiB = 31 };
// and of a joint row record
enum { kJn = 0, kJwa = 3, kJwb = 6, kJimA = 9, kJimB = 10, kJarA = 11,
       kJarB = 14, kJd = 17, kJrhs = 18, kJlob = 19, kJhib = 20 };

// One world's velocities in shared memory: component k of slot s.
template <typename T>
struct Vel {
  T* base;
  int stride;
  __device__ __forceinline__ T& at(int s, int k) const {
    return base[(s * 6 + k) * stride];
  }
};

// Field k of a record whose field 0 is at p, worlds B apart.
template <typename T>
__device__ __forceinline__ T field(const T* p, int k, int b) {
  return p[static_cast<size_t>(k) * b];
}

// A live row's bodies index the world's slots in shared memory; one
// outside [0, N) stops the kernel with an error, as PyTorch's indexing
// asserts on the card, rather than write another world's velocities.
__device__ __forceinline__ void check_bodies(int a, int b, int n) {
  if (static_cast<unsigned>(a) >= static_cast<unsigned>(n)
      || static_cast<unsigned>(b) >= static_cast<unsigned>(n))
    __trap();
}

template <typename T>
__device__ __forceinline__ T clamp_min0(T x) {
  return x < T(0) ? T(0) : x;            // torch.clamp_min(x, 0.0), NaN kept
}

template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  x = x < lo ? lo : x;                    // torch.clamp(x, lo, hi)
  return x > hi ? hi : x;
}

// A component of a cross product, x1·y2 − x2·y1, as torch.linalg.cross
// rounds it on the CPU: fma(x1, y2, −(x2·y1)), the one multiply-add the
// plain version fuses
__device__ __forceinline__ float cross_c(float x1, float y2, float x2,
                                         float y1) {
  return fmaf(x1, y2, -(x2 * y1));
}
__device__ __forceinline__ double cross_c(double x1, double y2, double x2,
                                          double y1) {
  return fma(x1, y2, -(x2 * y1));
}

// (v_b + w_b × r_b − v_a − w_a × r_a) · axis
template <typename T>
__device__ __forceinline__ T rel_v(const Vel<T>& v, int a, int b,
                                   const T* ra, const T* rb, const T* ax) {
  T wa0 = v.at(a, 3), wa1 = v.at(a, 4), wa2 = v.at(a, 5);
  T wb0 = v.at(b, 3), wb1 = v.at(b, 4), wb2 = v.at(b, 5);
  T va0 = v.at(a, 0) + cross_c(wa1, ra[2], wa2, ra[1]);
  T va1 = v.at(a, 1) + cross_c(wa2, ra[0], wa0, ra[2]);
  T va2 = v.at(a, 2) + cross_c(wa0, ra[1], wa1, ra[0]);
  T vb0 = v.at(b, 0) + cross_c(wb1, rb[2], wb2, rb[1]);
  T vb1 = v.at(b, 1) + cross_c(wb2, rb[0], wb0, rb[2]);
  T vb2 = v.at(b, 2) + cross_c(wb0, rb[1], wb1, rb[0]);
  return ((vb0 - va0) * ax[0] + (vb1 - va1) * ax[1]) + (vb2 - va2) * ax[2];
}

// Impulse p (already signed for this side) on one body:
// Δv = inv_m·p, Δw = inv_I·(r × p).
template <typename T>
__device__ __forceinline__ void push(const Vel<T>& v, int body, const T* r,
                                     T im, const T* ii, T p0, T p1, T p2) {
  T t0 = cross_c(r[1], p2, r[2], p1);
  T t1 = cross_c(r[2], p0, r[0], p2);
  T t2 = cross_c(r[0], p1, r[1], p0);
  v.at(body, 0) += im * p0;
  v.at(body, 1) += im * p1;
  v.at(body, 2) += im * p2;
  v.at(body, 3) += (ii[0] * t0 + ii[1] * t1) + ii[2] * t2;
  v.at(body, 4) += (ii[3] * t0 + ii[4] * t1) + ii[5] * t2;
  v.at(body, 5) += (ii[6] * t0 + ii[7] * t1) + ii[8] * t2;
}

template <typename T>
__device__ __forceinline__ void apply_pair(const Vel<T>& v, int a, int b,
                                           const T* ra, const T* rb,
                                           T im_a, T im_b, const T* ii_a,
                                           const T* ii_b, const T* ax,
                                           T dl) {
  T p0 = ax[0] * dl, p1 = ax[1] * dl, p2 = ax[2] * dl;
  push(v, a, ra, im_a, ii_a, -p0, -p1, -p2);
  push(v, b, rb, im_b, ii_b, p0, p1, p2);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWorlds)
pgs_solve_kernel(const T* __restrict__ rec, const int* __restrict__ idx,
                 int C, const T* __restrict__ jrec,
                 const int* __restrict__ jidx, int R, T* __restrict__ vel,
                 T* __restrict__ lam, T* __restrict__ jlam, int B, int N,
                 int iterations, T omega, T cfm, int friction, T mu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x;
  const int t = threadIdx.x;
  const int w = blockIdx.x * W + t;
  if (w >= B) return;
  const Vel<T> v{reinterpret_cast<T*>(smem) + t, W};
  T* my_vel = vel + static_cast<size_t>(w) * N * 6;
  for (int s = 0; s < N; ++s)
    for (int k = 0; k < 6; ++k) v.at(s, k) = my_vel[s * 6 + k];

  // one past this world's last live row, found on the device
  int last = 0, jlast = 0;
  for (int c = 0; c < C; ++c)
    if (idx[(static_cast<size_t>(c) * 3 + 2) * B + w]) last = c + 1;
  for (int r = 0; r < R; ++r)
    if (jidx[(static_cast<size_t>(r) * 3 + 2) * B + w]) jlast = r + 1;

  const T inf = T(INFINITY);
  for (int it = 0; it < iterations; ++it) {
    for (int c = 0; c < last; ++c) {
      const int* ic = idx + static_cast<size_t>(c) * 3 * B + w;
      if (!ic[2 * B]) continue;
      const int a = ic[0], b = ic[B];
      check_bodies(a, b, N);
      const T* f = rec + static_cast<size_t>(c) * kRowFields * B + w;
      T ra[3], rb[3], n[3], t1[3], t2[3], ii_a[9], ii_b[9];
      for (int k = 0; k < 3; ++k) {
        ra[k] = field(f, kRa + k, B);
        rb[k] = field(f, kRb + k, B);
        n[k] = field(f, kN + k, B);
        t1[k] = field(f, kT1 + k, B);
        t2[k] = field(f, kT2 + k, B);
      }
      for (int k = 0; k < 9; ++k) {
        ii_a[k] = field(f, kIiA + k, B);
        ii_b[k] = field(f, kIiB + k, B);
      }
      const T im_a = field(f, kImA, B), im_b = field(f, kImB, B);
      T* lam_n = lam + static_cast<size_t>(c) * B + w;
      T* lam_1 = lam_n + static_cast<size_t>(C) * B;
      T* lam_2 = lam_1 + static_cast<size_t>(C) * B;

      // normal row (the residual includes ODE's CFM softening −cfm/h·λ)
      T ln = *lam_n;
      T dl = omega * ((field(f, kTarget, B) - rel_v(v, a, b, ra, rb, n))
                      - cfm * ln) / field(f, kDn, B);
      dl = clamp_min0(ln + dl) - ln;
      ln = ln + dl;
      *lam_n = ln;
      apply_pair(v, a, b, ra, rb, im_a, im_b, ii_a, ii_b, n, dl);

      if (friction == kNoFriction) continue;
      T bound = inf;
      if (friction == kMuGlobal) {
        bound = mu * ln;
      } else if (friction == kMuPerRow) {
        const T m = field(f, kMu, B);
        bound = isinf(m) ? inf : m * ln;
      }
      T* lt[2] = {lam_1, lam_2};
      const T* ax[2] = {t1, t2};
      for (int k = 0; k < 2; ++k) {
        T l = *lt[k];
        T ds = omega * ((T(0) - rel_v(v, a, b, ra, rb, ax[k])) - cfm * l)
               / field(f, kDn + 1 + k, B);
        ds = clamp(l + ds, -bound, bound) - l;
        *lt[k] = l + ds;
        apply_pair(v, a, b, ra, rb, im_a, im_b, ii_a, ii_b, ax[k], ds);
      }
    }

    // the bilateral rows after each contact sweep, sequential like it
    for (int r = 0; r < jlast; ++r) {
      const int* ir = jidx + static_cast<size_t>(r) * 3 * B + w;
      if (!ir[2 * B]) continue;
      const int a = ir[0], b = ir[B];
      check_bodies(a, b, N);
      const T* g = jrec + static_cast<size_t>(r) * kJointFields * B + w;
      T jn[3], wa[3], wb[3];
      for (int k = 0; k < 3; ++k) {
        jn[k] = field(g, kJn + k, B);
        wa[k] = field(g, kJwa + k, B);
        wb[k] = field(g, kJwb + k, B);
      }
      T s_lin = ((v.at(b, 0) - v.at(a, 0)) * jn[0]
                 + (v.at(b, 1) - v.at(a, 1)) * jn[1])
                + (v.at(b, 2) - v.at(a, 2)) * jn[2];
      T s_b = (v.at(b, 3) * wb[0] + v.at(b, 4) * wb[1]) + v.at(b, 5) * wb[2];
      T s_a = (v.at(a, 3) * wa[0] + v.at(a, 4) * wa[1]) + v.at(a, 5) * wa[2];
      T rel = (s_lin + s_b) - s_a;
      T* lp = jlam + static_cast<size_t>(r) * B + w;
      T l = *lp;
      T dl = omega * ((field(g, kJrhs, B) - rel) - cfm * l)
             / field(g, kJd, B);
      dl = clamp(l + dl, field(g, kJlob, B), field(g, kJhib, B)) - l;
      *lp = l + dl;
      // body a's whole change, then body b's, as the plain pass adds them
      const T im_a = field(g, kJimA, B), im_b = field(g, kJimB, B);
      for (int k = 0; k < 3; ++k) v.at(a, k) += -im_a * (jn[k] * dl);
      for (int k = 0; k < 3; ++k)
        v.at(a, 3 + k) += -field(g, kJarA + k, B) * dl;
      for (int k = 0; k < 3; ++k) v.at(b, k) += im_b * (jn[k] * dl);
      for (int k = 0; k < 3; ++k)
        v.at(b, 3 + k) += field(g, kJarB + k, B) * dl;
    }
  }

  for (int s = 0; s < N; ++s)
    for (int k = 0; k < 6; ++k) my_vel[s * 6 + k] = v.at(s, k);
}

template <typename T>
int launch(const void* rec, const void* idx, int C, const void* jrec,
           const void* jidx, int R, void* vel, void* lam, void* jlam, int B,
           int N, int iterations, double omega, double cfm,
           int friction, double mu, void* stream) {
  const int per_world = N * 6 * static_cast<int>(sizeof(T));
  if (B <= 0 || N <= 0 || per_world > kSharedBytes || friction < 0
      || friction > kMuPerRow)
    return static_cast<int>(cudaErrorInvalidValue);
  int worlds = kSharedBytes / per_world;
  worlds = worlds < kMaxWorlds ? worlds : kMaxWorlds;
  const int blocks = (B + worlds - 1) / worlds;
  pgs_solve_kernel<T><<<blocks, worlds, worlds * per_world,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rec), static_cast<const int*>(idx), C,
      static_cast<const T*>(jrec), static_cast<const int*>(jidx), R,
      static_cast<T*>(vel), static_cast<T*>(lam), static_cast<T*>(jlam), B,
      N, iterations, static_cast<T>(omega), static_cast<T>(cfm), friction,
      static_cast<T>(mu));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pgs_solve_launch(const void* rec, const void* idx, int C,
                     const void* jrec, const void* jidx, int R, void* vel,
                     void* lam, void* jlam, int B, int N, int iterations,
                     double omega, double cfm, int friction, double mu,
                     void* stream) {
  return launch<float>(rec, idx, C, jrec, jidx, R, vel, lam, jlam, B, N,
                       iterations, omega, cfm, friction, mu, stream);
}

int pgs_solve_launch_f64(const void* rec, const void* idx, int C,
                         const void* jrec, const void* jidx, int R,
                         void* vel, void* lam, void* jlam, int B, int N,
                         int iterations, double omega, double cfm,
                         int friction, double mu, void* stream) {
  return launch<double>(rec, idx, C, jrec, jidx, R, vel, lam, jlam, B, N,
                        iterations, omega, cfm, friction, mu, stream);
}

}  // extern "C"
