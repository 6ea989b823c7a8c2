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
//   * the live contact rows in buffer order, each its normal axis, then
//     t1, then t2 (friction_mode 0 skips the friction axes):
//       dλ = ω·((target − v_rel·axis) − cfm_term·λ) / d
//       λ' = max(λ + dλ, 0)            normal
//       λ' = clamp(λ + dλ, −b, b)      friction; b = ∞ (mode 1), μ·λ_n
//                                      (mode 2), the row's μ or ∞ (mode 3)
//       dλ = λ' − λ, λ += dλ, and ∓axis·dλ applied to the two bodies
//       through their inverse mass and world inverse inertia;
//   * then, given joint rows, the live bilateral rows in order with the
//     ops/joints.py:joint_iteration_seq arithmetic (d_seq, lob/hib).
// With no contact rows (C = 0) and ω = 1 it is DANTZIG's joint passes.
// A dead row changes nothing in the plain loop (its dλ is 0), so visiting
// only the live rows gives the plain loop's result.
//
// Design. The rows of a sweep depend on each other (row i reads what row
// i − 1 wrote), and so do a row's three axes (the friction bound reads the
// new λ_n, each axis reads the velocities the one before wrote): the one
// parallel axis is the world, and a world's solve is one dependent chain,
// bounded by its latency. So the design keeps every operand of the chain
// on the SM, close to its thread, and lets one instruction step several
// worlds:
//   * W worlds a block, W ≤ 8, so that 1,024 worlds take 128 of the 132
//     SMs and each world has ~28 KB of the 227 KB of shared memory a block
//     may opt into.
//   * Prologue, a warp a world: the world's (N, 6) velocities into shared
//     memory, or, in a world of more than kVelocityBytes of them (past
//     ops/pgs_kernel.max_slots: 1,024 slots in float64, 2,048 in float32),
//     into the output in device memory, where the sweeps then work on them
//     in place: the kernel's slower branch for such a world, which keeps
//     its share of shared memory for its staged rows; the impulses copied
//     to the output (dead rows pass through);
//     the live rows found 32 flags at a time (__ballot_sync, and a prefix
//     __popc for each live row's place, which keeps buffer order); the
//     first S live contact rows and S_j live joint rows staged into shared
//     memory, a lane a row, every field loaded at once, with their bodies
//     and impulses. The row table is read where the solver built it, the
//     (B, C, k) tensors of ops/solver.pgs_inputs and the (B, R, k) ones of
//     ops/joints.joint_rows, through one struct of pointers: no packing.
//   * Sweeps, after a barrier: warp 0 alone, lane k stepping world k of
//     the block. Eight single-lane warps on one SM would share its four
//     schedulers and FP64 pipes, each world's chain waiting on the others
//     (a warp a world through the sweeps took 0.231 ms in float64 at
//     conformance-1024, this design 0.144: PERF.md §6); one warp issues
//     each instruction once for all W worlds. A staged row's 40 fields are loaded into registers at the
//     row's start, from an array apart from the velocities; the row's two
//     bodies' 12 velocity components are loaded once, updated in
//     registers through its three axes and stored once at the row's end.
//     Where a = b the second body's update starts from the first one's
//     result, as the plain loop's two `vel[ar, body] +=` do (add_pair, in
//     an instantiation of its own: the pipelines' rows have a < b).
//     No device memory is read inside the chain (but in the slower
//     branches: a world's velocities past kVelocityBytes, the live rows
//     past S). The worlds' regions lie
//     128·k + 16 bytes apart, so the lanes' accesses fall in distinct banks.
//   * Live rows past S (S_j) are solved in the same order from the table
//     in device memory, found by scanning the flags on from the first of
//     them: the kernel's slower branch, right at any count of live rows.
//   * Epilogue, after a barrier, a warp a world: the velocities (where
//     they were in shared memory) and the staged rows' impulses written
//     out.
// TMA and wgmma do not fit: there is no matrix product, and the rows to
// gather are scattered by the live mask. W, S and S_j are the caller's
// (ops/pgs_kernel.launch_shape: from N, C, R and the dtype, never from a
// host read); the launcher refuses a shape that does not fit. No world
// is refused for its count of slots.
//
// Rounding follows the plain version on the CPU: each operation is
// rounded as PyTorch rounds it there, in its order ((x0 + x1) + x2 for a
// 3-sum; ω, cfm_term and μ rounded to T first), built with -fmad=false so
// that no multiply and add are fused that PyTorch rounds twice (XLA fuses
// them: ROADMAP's trap table). The one fused multiply-add of the plain
// version, torch.linalg.cross's x1·y2 − x2·y1 = fma(x1, y2, −x2·y1) on the
// CPU, is written as that fma (cross_c). Division is IEEE (nvcc's default
// -prec-div=true). A velocity held in a register is the value shared
// memory would hold, so keeping it there moves no rounding. On the card
// the plain version's own kernels may fuse otherwise, so there the two
// agree to roundoff (chip_smoke.py prints the gap).
//
// Bound. Device memory: every row's live flag, each live row's fields,
// the velocities in and out, every row's impulses in and out, ~17 KB a
// world in float64 at C = 256 (~5 µs for 1,024 worlds at 3.35 TB/s); the
// arithmetic, ~330 operations a row and sweep, is smaller against 34
// TFLOP/s FP64. What bounds it is the latency of the dependent chain:
// sweeps × live rows × 3 axes, each axis ~20 dependent operations
// (cross, 3-sum, residual, division, clamp, impulse, cross, 3-sum) on
// registers; utils/bounds.pgs_bound reckons its floor at 4 cycles an
// operation at 1.98 GHz. Many worlds run side by side to cover that
// latency; one world takes as long as 1,024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowFields = 40;
constexpr int kJointFields = 21;
constexpr int kMaxWorlds = 8;            // worlds a block
constexpr int kMaxShared = 232448;       // 227 KB, opted into per device
constexpr int kVelocityBytes = 48 * 1024; // a world's velocities in shared
constexpr unsigned kAll = 0xffffffffu;

enum FrictionMode { kNoFriction = 0, kMuInf = 1, kMuGlobal = 2,
                    kMuPerRow = 3 };

// The launch's tensors, in ops/pgs_kernel.POINTERS' order: the contact
// table (B, C, k), the impulses in and out (B, C, 3), the joint table
// (B, R, k) and its impulses' scratch (B, R), the velocities in and out
// (B, N, 6). a and b are int32, the flags bool; mu is null unless mode 3.
enum { pA, pB, pValid, pRa, pRb, pN, pT1, pT2, pDn, pDt1, pDt2, pTarget,
       pMu, pImA, pImB, pIiA, pIiB, pLam, pLamOut,
       pJa, pJb, pJlive, pJn, pJwa, pJwb, pJimA, pJimB, pJarA, pJarB, pJd,
       pJrhs, pJlob, pJhib, pJlam, pVel, pVelOut, kPointers };

struct Pointers {
  const void* p[kPointers];
};

// field offsets of a staged contact row
enum { kRa = 0, kRb = 3, kN = 6, kT1 = 9, kT2 = 12, kDn = 15, kTarget = 18,
       kMu = 19, kImA = 20, kImB = 21, kIiA = 22, kIiB = 31 };
// and of a staged joint row
enum { kJn = 0, kJwa = 3, kJwb = 6, kJimA = 9, kJimB = 10, kJarA = 11,
       kJarB = 14, kJd = 17, kJrhs = 18, kJlob = 19, kJhib = 20 };

template <typename T>
__device__ __forceinline__ const T* in(const Pointers& P, int k) {
  return static_cast<const T*>(P.p[k]);
}

// Whether a world of n slots keeps its (n, 6) velocities in shared memory
// (ops/pgs_kernel.max_slots); past that they stay in device memory.
template <typename T>
__host__ __device__ bool vel_in_shared(int n) {
  return static_cast<size_t>(n) * 6 * sizeof(T) <= kVelocityBytes;
}

// One world's region of shared memory: velocities (N, 6; none past
// vel_in_shared), the staged contact rows (S, 40) and impulses (S, 3), the
// staged joint rows (S_j, 21) and impulses (S_j), then the ints: the
// staged rows' bodies and buffer rows, the joint rows' bodies, and the
// world's live counts. The regions lie a multiple of 128 bytes plus 16
// apart, so that the lanes of the sweeping warp, a world each, reach the
// same field of their worlds in distinct banks. ops/pgs_kernel._world_bytes
// is the same sum.
template <typename T>
struct World {
  T* vel;
  T* rec;
  T* lam;
  T* jrec;
  T* jlam;
  int* a;
  int* b;
  int* row;
  int* ja;
  int* jb;
  int* live;          // count, past, jcount, jpast (find_live's)
};

template <typename T>
__host__ __device__ size_t world_bytes(int n, int s, int sj) {
  const size_t nv = vel_in_shared<T>(n) ? n : 0;
  const size_t t = sizeof(T) * (nv * 6
                                + static_cast<size_t>(s) * (kRowFields + 3)
                                + static_cast<size_t>(sj)
                                  * (kJointFields + 1));
  const size_t i = sizeof(int) * (static_cast<size_t>(s) * 3
                                  + static_cast<size_t>(sj) * 2 + 4);
  return (t + i + 127) / 128 * 128 + 16;
}

// World w's region at base; its velocities there (kShared, as
// vel_in_shared says), or in the output in device memory. A compile-time
// choice: the shared pointer's address space then stays known to the
// compiler, which keeps its accesses shared-memory instructions.
template <typename T, bool kShared>
__device__ World<T> carve(const Pointers& P, unsigned char* base, int w,
                          int n, int s, int sj) {
  World<T> r;
  r.rec = reinterpret_cast<T*>(base) + (kShared ? n * 6 : 0);
  if (kShared)
    r.vel = reinterpret_cast<T*>(base);
  else
    r.vel = const_cast<T*>(in<T>(P, pVelOut))
            + static_cast<size_t>(w) * n * 6;
  r.lam = r.rec + s * kRowFields;
  r.jrec = r.lam + s * 3;
  r.jlam = r.jrec + sj * kJointFields;
  r.a = reinterpret_cast<int*>(r.jlam + sj);
  r.b = r.a + s;
  r.row = r.b + s;
  r.ja = r.row + s;
  r.jb = r.ja + sj;
  r.live = r.jb + sj;
  return r;
}

template <typename T>
struct Row {
  T ra[3], rb[3], n[3], t1[3], t2[3], d[3], target, mu, im_a, im_b;
  T ii_a[9], ii_b[9];
};

template <typename T>
struct JRow {
  T n[3], wa[3], wb[3], im_a, im_b, ar_a[3], ar_b[3], d, rhs, lob, hib;
};

// contact row i = w·C + c of the table, where the solver built it
template <typename T>
__device__ __forceinline__ Row<T> table_row(const Pointers& P, size_t i,
                                            bool mu_per_row) {
  Row<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.ra[k] = in<T>(P, pRa)[i * 3 + k];
    r.rb[k] = in<T>(P, pRb)[i * 3 + k];
    r.n[k] = in<T>(P, pN)[i * 3 + k];
    r.t1[k] = in<T>(P, pT1)[i * 3 + k];
    r.t2[k] = in<T>(P, pT2)[i * 3 + k];
  }
  r.d[0] = in<T>(P, pDn)[i];
  r.d[1] = in<T>(P, pDt1)[i];
  r.d[2] = in<T>(P, pDt2)[i];
  r.target = in<T>(P, pTarget)[i];
  r.mu = mu_per_row ? in<T>(P, pMu)[i] : T(0);
  r.im_a = in<T>(P, pImA)[i];
  r.im_b = in<T>(P, pImB)[i];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r.ii_a[k] = in<T>(P, pIiA)[i * 9 + k];
    r.ii_b[k] = in<T>(P, pIiB)[i * 9 + k];
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void put_row(T* s, const Row<T>& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[kRa + k] = r.ra[k];
    s[kRb + k] = r.rb[k];
    s[kN + k] = r.n[k];
    s[kT1 + k] = r.t1[k];
    s[kT2 + k] = r.t2[k];
    s[kDn + k] = r.d[k];
  }
  s[kTarget] = r.target;
  s[kMu] = r.mu;
  s[kImA] = r.im_a;
  s[kImB] = r.im_b;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    s[kIiA + k] = r.ii_a[k];
    s[kIiB + k] = r.ii_b[k];
  }
}

template <typename T>
__device__ __forceinline__ Row<T> staged_row(const T* s) {
  Row<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.ra[k] = s[kRa + k];
    r.rb[k] = s[kRb + k];
    r.n[k] = s[kN + k];
    r.t1[k] = s[kT1 + k];
    r.t2[k] = s[kT2 + k];
    r.d[k] = s[kDn + k];
  }
  r.target = s[kTarget];
  r.mu = s[kMu];
  r.im_a = s[kImA];
  r.im_b = s[kImB];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r.ii_a[k] = s[kIiA + k];
    r.ii_b[k] = s[kIiB + k];
  }
  return r;
}

template <typename T>
__device__ __forceinline__ JRow<T> table_joint(const Pointers& P, size_t i) {
  JRow<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.n[k] = in<T>(P, pJn)[i * 3 + k];
    r.wa[k] = in<T>(P, pJwa)[i * 3 + k];
    r.wb[k] = in<T>(P, pJwb)[i * 3 + k];
    r.ar_a[k] = in<T>(P, pJarA)[i * 3 + k];
    r.ar_b[k] = in<T>(P, pJarB)[i * 3 + k];
  }
  r.im_a = in<T>(P, pJimA)[i];
  r.im_b = in<T>(P, pJimB)[i];
  r.d = in<T>(P, pJd)[i];
  r.rhs = in<T>(P, pJrhs)[i];
  r.lob = in<T>(P, pJlob)[i];
  r.hib = in<T>(P, pJhib)[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void put_joint(T* s, const JRow<T>& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[kJn + k] = r.n[k];
    s[kJwa + k] = r.wa[k];
    s[kJwb + k] = r.wb[k];
    s[kJarA + k] = r.ar_a[k];
    s[kJarB + k] = r.ar_b[k];
  }
  s[kJimA] = r.im_a;
  s[kJimB] = r.im_b;
  s[kJd] = r.d;
  s[kJrhs] = r.rhs;
  s[kJlob] = r.lob;
  s[kJhib] = r.hib;
}

template <typename T>
__device__ __forceinline__ JRow<T> staged_joint(const T* s) {
  JRow<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.n[k] = s[kJn + k];
    r.wa[k] = s[kJwa + k];
    r.wb[k] = s[kJwb + k];
    r.ar_a[k] = s[kJarA + k];
    r.ar_b[k] = s[kJarB + k];
  }
  r.im_a = s[kJimA];
  r.im_b = s[kJimB];
  r.d = s[kJd];
  r.rhs = s[kJrhs];
  r.lob = s[kJlob];
  r.hib = s[kJhib];
  return r;
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

// (v_b + w_b × r_b − v_a − w_a × r_a) · axis, on the bodies' registers
template <typename T>
__device__ __forceinline__ T rel_v(const T* va, const T* vb, const T* ra,
                                   const T* rb, const T* ax) {
  T a0 = va[0] + cross_c(va[4], ra[2], va[5], ra[1]);
  T a1 = va[1] + cross_c(va[5], ra[0], va[3], ra[2]);
  T a2 = va[2] + cross_c(va[3], ra[1], va[4], ra[0]);
  T b0 = vb[0] + cross_c(vb[4], rb[2], vb[5], rb[1]);
  T b1 = vb[1] + cross_c(vb[5], rb[0], vb[3], rb[2]);
  T b2 = vb[2] + cross_c(vb[3], rb[1], vb[4], rb[0]);
  return ((b0 - a0) * ax[0] + (b1 - a1) * ax[1]) + (b2 - a2) * ax[2];
}

// The change of one body's velocities under impulse p (already signed for
// this side): Δv = inv_m·p, Δw = inv_I·(r × p).
template <typename T>
__device__ __forceinline__ void impulse(T* dv, const T* r, T im,
                                        const T* ii, T p0, T p1, T p2) {
  T t0 = cross_c(r[1], p2, r[2], p1);
  T t1 = cross_c(r[2], p0, r[0], p2);
  T t2 = cross_c(r[0], p1, r[1], p0);
  dv[0] = im * p0;
  dv[1] = im * p1;
  dv[2] = im * p2;
  dv[3] = (ii[0] * t0 + ii[1] * t1) + ii[2] * t2;
  dv[4] = (ii[3] * t0 + ii[4] * t1) + ii[5] * t2;
  dv[5] = (ii[6] * t0 + ii[7] * t1) + ii[8] * t2;
}

// va += da, then vb += db, on the registers. Where a = b (kSame) the two
// are one slot: the second sum starts from the first one's result, as the
// plain loop's two `vel[ar, body] +=` on one slot do.
template <bool kSame, typename T>
__device__ __forceinline__ void add_pair(T* va, T* vb, const T* da,
                                         const T* db) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    va[k] = va[k] + da[k];
    if (kSame) vb[k] = va[k];
    vb[k] = vb[k] + db[k];
    if (kSame) va[k] = vb[k];
  }
}

template <bool kSame, typename T>
__device__ __forceinline__ void apply_pair(T* va, T* vb, const Row<T>& r,
                                           const T* ax, T dl) {
  T p0 = ax[0] * dl, p1 = ax[1] * dl, p2 = ax[2] * dl;
  T da[6], db[6];
  impulse(da, r.ra, r.im_a, r.ii_a, -p0, -p1, -p2);
  impulse(db, r.rb, r.im_b, r.ii_b, p0, p1, p2);
  add_pair<kSame>(va, vb, da, db);
}

template <typename T>
struct Params {
  T omega, cfm, mu;
  int friction;
};

// One contact row's three axes on the bodies' registers va, vb and its
// impulses l.
template <bool kSame, typename T>
__device__ __forceinline__ void contact_row(const Row<T>& r, T* va, T* vb,
                                            T* l, const Params<T>& q) {
  // normal row (the residual includes ODE's CFM softening −cfm/h·λ)
  T ln = l[0];
  T dl = q.omega * ((r.target - rel_v(va, vb, r.ra, r.rb, r.n))
                    - q.cfm * ln) / r.d[0];
  dl = clamp_min0(ln + dl) - ln;
  ln = ln + dl;
  l[0] = ln;
  apply_pair<kSame>(va, vb, r, r.n, dl);

  if (q.friction == kNoFriction) return;
  const T inf = T(INFINITY);
  T bound = inf;
  if (q.friction == kMuGlobal) {
    bound = q.mu * ln;
  } else if (q.friction == kMuPerRow) {
    bound = isinf(r.mu) ? inf : r.mu * ln;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T* ax = k == 0 ? r.t1 : r.t2;
    T lt = l[1 + k];
    T ds = q.omega * ((T(0) - rel_v(va, vb, r.ra, r.rb, ax)) - q.cfm * lt)
           / r.d[1 + k];
    ds = clamp(lt + ds, -bound, bound) - lt;
    l[1 + k] = lt + ds;
    apply_pair<kSame>(va, vb, r, ax, ds);
  }
}

// One joint row on the bodies' registers: body a's whole change, then
// body b's, as the plain pass adds them.
template <bool kSame, typename T>
__device__ __forceinline__ T joint_row(const JRow<T>& g, T* va, T* vb, T l,
                                       const Params<T>& q) {
  T s_lin = ((vb[0] - va[0]) * g.n[0] + (vb[1] - va[1]) * g.n[1])
            + (vb[2] - va[2]) * g.n[2];
  T s_b = (vb[3] * g.wb[0] + vb[4] * g.wb[1]) + vb[5] * g.wb[2];
  T s_a = (va[3] * g.wa[0] + va[4] * g.wa[1]) + va[5] * g.wa[2];
  T rel = (s_lin + s_b) - s_a;
  T dl = q.omega * ((g.rhs - rel) - q.cfm * l) / g.d;
  dl = clamp(l + dl, g.lob, g.hib) - l;
  T da[6], db[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    da[k] = -g.im_a * (g.n[k] * dl);
    da[3 + k] = -g.ar_a[k] * dl;
    db[k] = g.im_b * (g.n[k] * dl);
    db[3 + k] = g.ar_b[k] * dl;
  }
  add_pair<kSame>(va, vb, da, db);
  return l + dl;
}

template <typename T>
__device__ __forceinline__ void load6(const T* s, T* v) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = s[k];
}

template <typename T>
__device__ __forceinline__ void store6(T* s, const T* v) {
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = v[k];
}

// A contact row on the world's velocities in shared memory, its impulses
// at l (shared memory, or the output for a row past S): the two bodies
// loaded once, b stored last (where a = b its registers hold the result).
template <typename T>
__device__ __forceinline__ void solve_contact(const Row<T>& r, int a, int b,
                                              T* vel, T* l,
                                              const Params<T>& q) {
  T va[6], vb[6], lr[3] = {l[0], l[1], l[2]};
  load6(vel + a * 6, va);
  load6(vel + b * 6, vb);
  if (a == b)                            // not from the pipelines
    contact_row<true>(r, va, vb, lr, q);
  else
    contact_row<false>(r, va, vb, lr, q);
  l[0] = lr[0];
  l[1] = lr[1];
  l[2] = lr[2];
  store6(vel + a * 6, va);
  store6(vel + b * 6, vb);
}

template <typename T>
__device__ __forceinline__ T solve_joint(const JRow<T>& g, int a, int b,
                                         T* vel, T l, const Params<T>& q) {
  T va[6], vb[6];
  load6(vel + a * 6, va);
  load6(vel + b * 6, vb);
  l = a == b ? joint_row<true>(g, va, vb, l, q)
             : joint_row<false>(g, va, vb, l, q);
  store6(vel + a * 6, va);
  store6(vel + b * 6, vb);
  return l;
}

// The warp's scan of one world's n live flags, 32 at a time (4 chunks'
// loads in flight): the buffer rows of the first `cap` live rows, in
// buffer order, into row[]; returns the live count, and in *past the
// first live row after them (n if none).
__device__ __forceinline__ int find_live(const bool* live, int n, int cap,
                                         int* row, int* past, int lane) {
  int count = 0, first_past = n;
  for (int base = 0; base < n; base += 128) {
    bool on[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = base + 32 * u + lane;
      on[u] = c < n && live[c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = base + 32 * u + lane;
      const unsigned m = __ballot_sync(kAll, on[u]);
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      if (on[u] && pos < cap) row[pos] = c;
      if (on[u] && pos == cap) first_past = c;
      count += __popc(m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    first_past = min(first_past, __shfl_xor_sync(kAll, first_past, o));
  *past = first_past;
  return count;
}

// Prologue, the warp of world w: velocities in, impulses copied through,
// the live rows found and the first S (S_j) staged.
template <typename T>
__device__ __forceinline__ void stage(const Pointers& P, const World<T>& s,
                                      int w, int N, int C, int R, int S,
                                      int SJ, bool mu_per_row, int lane) {
  const size_t cw = static_cast<size_t>(w) * C;
  const size_t rw = static_cast<size_t>(w) * R;
  const T* vel_in = in<T>(P, pVel) + static_cast<size_t>(w) * N * 6;
  for (int e = lane; e < N * 6; e += 32) s.vel[e] = vel_in[e];
  T* lam_out = const_cast<T*>(in<T>(P, pLamOut));
  const T* lam_in = in<T>(P, pLam);
#pragma unroll 24
  for (int e = lane; e < C * 3; e += 32)
    lam_out[cw * 3 + e] = lam_in[cw * 3 + e];

  int past = C, jpast = R;
  const int count = C ? find_live(in<bool>(P, pValid) + cw, C, S, s.row,
                                  &past, lane) : 0;
  const int jcount = R ? find_live(in<bool>(P, pJlive) + rw, R, SJ, s.ja,
                                   &jpast, lane) : 0;
  const int staged = min(count, S), jstaged = min(jcount, SJ);
  __syncwarp();
  for (int j = lane; j < staged; j += 32) {
    const size_t i = cw + s.row[j];
    s.a[j] = in<int>(P, pA)[i];
    s.b[j] = in<int>(P, pB)[i];
    put_row(s.rec + j * kRowFields, table_row<T>(P, i, mu_per_row));
#pragma unroll
    for (int k = 0; k < 3; ++k) s.lam[j * 3 + k] = lam_in[i * 3 + k];
  }
  for (int j = lane; j < jstaged; j += 32) {
    const size_t i = rw + s.ja[j];      // the scan's buffer row, replaced
    put_joint(s.jrec + j * kJointFields, table_joint<T>(P, i));
    s.ja[j] = in<int>(P, pJa)[i];
    s.jb[j] = in<int>(P, pJb)[i];
    s.jlam[j] = T(0);
  }
  if (lane == 0) {
    s.live[0] = count;
    s.live[1] = past;
    s.live[2] = jcount;
    s.live[3] = jpast;
  }
}

// Every sweep of world w, one thread: its staged rows from shared memory,
// the live rows past them from the table, in buffer order.
template <typename T>
__device__ __forceinline__ void sweeps(const Pointers& P, const World<T>& s,
                                       int w, int N, int C, int R, int S,
                                       int SJ, int iterations, bool mu_per_row,
                                       const Params<T>& q) {
  const size_t cw = static_cast<size_t>(w) * C;
  const size_t rw = static_cast<size_t>(w) * R;
  const int count = s.live[0], past = s.live[1];
  const int jcount = s.live[2], jpast = s.live[3];
  const int staged = min(count, S), jstaged = min(jcount, SJ);
  const bool* valid = in<bool>(P, pValid) + cw;
  const bool* jlive = in<bool>(P, pJlive) + rw;
  T* lam_out = const_cast<T*>(in<T>(P, pLamOut));
  T* jlam = const_cast<T*>(in<T>(P, pJlam)) + rw;
  for (int it = 0; it < iterations; ++it) {
    for (int j = 0; j < staged; ++j) {
      const int a = s.a[j], b = s.b[j];
      check_bodies(a, b, N);
      solve_contact(staged_row(s.rec + j * kRowFields), a, b, s.vel,
                    s.lam + j * 3, q);
    }
    // the live rows past the staged ones, read in place, in order
    for (int c = past, left = count - staged; left > 0; ++c) {
      if (!valid[c]) continue;
      --left;
      const size_t i = cw + c;
      const int a = in<int>(P, pA)[i], b = in<int>(P, pB)[i];
      check_bodies(a, b, N);
      solve_contact(table_row<T>(P, i, mu_per_row), a, b, s.vel,
                    lam_out + i * 3, q);
    }
    // the bilateral rows after each contact sweep, sequential like it
    for (int j = 0; j < jstaged; ++j) {
      const int a = s.ja[j], b = s.jb[j];
      check_bodies(a, b, N);
      s.jlam[j] = solve_joint(staged_joint(s.jrec + j * kJointFields), a, b,
                              s.vel, s.jlam[j], q);
    }
    for (int r = jpast, left = jcount - jstaged; left > 0; ++r) {
      if (!jlive[r]) continue;
      --left;
      const size_t i = rw + r;
      const int a = in<int>(P, pJa)[i], b = in<int>(P, pJb)[i];
      check_bodies(a, b, N);
      jlam[r] = solve_joint(table_joint<T>(P, i), a, b, s.vel,
                            it == 0 ? T(0) : jlam[r], q);
    }
  }
}

// Epilogue, the warp of world w: velocities and the staged rows' impulses
// out.
template <typename T>
__device__ __forceinline__ void write_back(const Pointers& P,
                                           const World<T>& s, int w, int N,
                                           int C, int S, int lane) {
  const size_t cw = static_cast<size_t>(w) * C;
  const int staged = min(s.live[0], S);
  T* vel_out = const_cast<T*>(in<T>(P, pVelOut))
               + static_cast<size_t>(w) * N * 6;
  if (vel_in_shared<T>(N))              // else they are there already
    for (int e = lane; e < N * 6; e += 32) vel_out[e] = s.vel[e];
  T* lam_out = const_cast<T*>(in<T>(P, pLamOut));
  for (int e = lane; e < staged * 3; e += 32)
    lam_out[(cw + s.row[e / 3]) * 3 + e % 3] = s.lam[e];
}

// W warps a block, warp k staging and writing back world blockIdx.x·W + k;
// between two barriers, warp 0 runs the sweeps of all W worlds, lane k
// world k, so that one instruction steps W worlds.
template <typename T, bool kShared>
__device__ __forceinline__ void solve_block(const Pointers& P,
                                            unsigned char* smem, int B,
                                            int N, int C, int R, int S,
                                            int SJ, int iterations,
                                            const Params<T>& q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const size_t stride = world_bytes<T>(N, S, SJ);
  const bool mu_per_row = q.friction == kMuPerRow;
  const int w = blockIdx.x * W + warp;
  if (w < B)
    stage(P, carve<T, kShared>(P, smem + warp * stride, w, N, S, SJ), w, N,
          C, R, S, SJ, mu_per_row, lane);
  __syncthreads();
  if (warp == 0 && lane < W && blockIdx.x * W + lane < B) {
    const int v = blockIdx.x * W + lane;
    sweeps(P, carve<T, kShared>(P, smem + lane * stride, v, N, S, SJ), v, N,
           C, R, S, SJ, iterations, mu_per_row, q);
  }
  __syncthreads();
  if (w < B)
    write_back(P, carve<T, kShared>(P, smem + warp * stride, w, N, S, SJ), w,
               N, C, S, lane);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWorlds * 32, 1)
pgs_solve_kernel(Pointers P, int B, int N, int C, int R, int S, int SJ,
                 int iterations, T omega, T cfm, int friction, T mu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Params<T> q{omega, cfm, mu, friction};
  if (vel_in_shared<T>(N))
    solve_block<T, true>(P, smem, B, N, C, R, S, SJ, iterations, q);
  else
    solve_block<T, false>(P, smem, B, N, C, R, S, SJ, iterations, q);
}

// The opt-in to more than 48 KB of dynamic shared memory, once per device.
// The first launch on a device sets it; graphed callers launch eagerly
// once (utils/graphs.warm_up) before any capture, so it is set outside
// every capture.
template <typename T>
cudaError_t opt_in() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(pgs_solve_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* const* ptrs, int B, int N, int C, int R, int W,
           int S, int SJ, int iterations, double omega, double cfm,
           int friction, double mu, void* stream) {
  const size_t bytes = W > 0 ? W * world_bytes<T>(N, S, SJ) : 0;
  if (B <= 0 || N <= 0 || C < 0 || R < 0 || W < 1 || W > kMaxWorlds
      || S < 0 || S > C || SJ < 0 || SJ > R || bytes > kMaxShared
      || friction < 0 || friction > kMuPerRow)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Pointers P;
  for (int k = 0; k < kPointers; ++k) P.p[k] = ptrs[k];
  const int blocks = (B + W - 1) / W;
  pgs_solve_kernel<T><<<blocks, W * 32, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      P, B, N, C, R, S, SJ, iterations, static_cast<T>(omega),
      static_cast<T>(cfm), friction, static_cast<T>(mu));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pgs_solve_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  out[3] = attr.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

int pgs_solve_launch(const void* const* ptrs, int B, int N, int C, int R,
                     int W, int S, int SJ, int iterations, double omega,
                     double cfm, int friction, double mu, void* stream) {
  return launch<float>(ptrs, B, N, C, R, W, S, SJ, iterations, omega, cfm,
                       friction, mu, stream);
}

int pgs_solve_launch_f64(const void* const* ptrs, int B, int N, int C,
                         int R, int W, int S, int SJ, int iterations,
                         double omega, double cfm, int friction, double mu,
                         void* stream) {
  return launch<double>(ptrs, B, N, C, R, W, S, SJ, iterations, omega, cfm,
                        friction, mu, stream);
}

// registers a thread, local (spilled) bytes a thread, the most threads a
// block, the dynamic shared memory the kernel may take: of the float32
// kernel, or with f64 != 0 of the float64 one
int pgs_solve_resources(int f64, int* out) {
  return f64 ? resources<double>(out) : resources<float>(out);
}

}  // extern "C"
