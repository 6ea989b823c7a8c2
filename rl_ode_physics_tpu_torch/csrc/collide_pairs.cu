// The classic narrowphase's collide for Hopper (sm_90a): every broadphase
// candidate's contact manifold, in one launch.
//
// Replaces no Pallas kernel: the JAX package's classic narrowphase
// (rl_ode_physics_tpu/ops/narrowphase.py:narrowphase, collide_pair) is
// plain jnp that XLA fuses on the TPU. In PyTorch the same code,
// ops/pair_kernels.py:_gather_rows + _collide_rows + `& cand.valid` (the
// plain version, which CPU tensors take), runs every enabled pair kernel
// on every candidate slot and selects each pair's result by type: some
// 1,400 launches over (B, CP, K) tensors a substep, each a pass of
// megabytes through device memory.
//
// What it computes, per candidate slot (b, c): the two bodies' feature rows
// (pos | quat | size | type, ops/narrowphase._features), the lower type
// code as side A (swapped back by negating the normals, as collide_pair
// does), the one pair kernel of (tmin, tmax), its intrinsic manifold (at
// most 8 slots, _KERNEL_K) and that manifold reduced to k slots as the
// pair kernel reduces it: padded with zeros, folded (box-box at k = 4 keeps
// slot i or slot 4 + i, box-plane slot i or 7 - i) or the k deepest valid
// slots (k < 8, the lower slot first among equal depths, as
// jax.lax.top_k). A slot whose candidate is not valid, or whose type pair
// is not enabled, runs no pair kernel and stores zeros and valid = false.
// The exact clip (_clip_quad_to_rect) is a loop over the 4 planes with a
// running vertex count in the thread's own memory: no scan, no scatter.
//
// Numerics. Built with -fmad=false: every operation is rounded once, as
// each PyTorch launch rounds it, in the plain version's order; fma() stands
// exactly where the plain version calls torch.addcmul (the clip's crossing
// point, which PyTorch computes with std::fma). Division and sqrt are
// IEEE (nvcc's defaults). The plain version's sums over 3 components run
// in the order PyTorch's CUDA reduction takes: over a contiguous last axis
// two lanes share the 3 values, lane 0 adding elements 0 and 2 and the
// lanes then combining, so (p0 + p2) + p1 (sum3_lanes); over an axis that
// is not the fastest-moving one, one thread adds them in order,
// (p0 + p1) + p2 (sum3_seq). Python scalars round to the tensor's dtype,
// and the 1.05 face-preference fudge and its reciprocal to float32, as
// torch.where makes a float32 tensor of two Python floats.
//
// Bound: bytes. Device memory must carry, per slot, 8 bytes of indices
// and 1 of validity in and k slots of point, normal, depth and valid out
// (456 bytes at k = 8 in float64), and the (B, N, 11) feature table once:
// about 128 MB at the quickstep-f64 stack's shape (B = 1,024, N = 68,
// CP = 256, k = 8), 0.038 ms at 3.35 TB/s (utils/bounds.collide_bound). A
// live slot's two 11-wide feature rows (176 bytes in float64) come from
// that table, a few megabytes that stays in the 50 MB L2, and are not
// device-memory bytes. The heaviest pair, box-box with SAT and the exact
// clip, is a few thousand FP64 operations; at 120 live pairs a world that
// is well under the byte time at 34 TFLOP/s.
//
// Design. One thread a candidate slot, 128 threads a block; nothing is
// shared between threads, so there is no barrier. The feature rows are
// read where _features wrote them. Each thread branches to its pair's
// kernel alone, so a warp whose 32 slots hold mixed type pairs runs each
// type present once, one after another, with the other lanes masked:
// warp divergence costs the sum of the types present in the warp, not the
// sum of all nine, and the broadphase's candidate lists put each world's
// valid pairs first, so the invalid tail's warps retire at once. The
// manifold and the clip's vertices live in per-thread arrays (registers,
// or local memory where indexed at run time, cached in L1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 8;        // the widest intrinsic manifold
constexpr int kFeatures = 11;    // pos | quat | size | type

// core/state.BodyType
constexpr int kSphere = 1, kBox = 2, kCapsule = 3, kPlane = 4;

// bits of the enabled-kernel mask, in ops/pair_kernels._PAIR_KERNELS order
enum PairBit {
  kSphereSphere = 0, kSphereBox, kSphereCapsule, kSpherePlane, kBoxBox,
  kBoxCapsule, kBoxPlane, kCapsuleCapsule, kCapsulePlane, kNoPair
};

__device__ __forceinline__ int pair_bit(int t1, int t2) {
  if (t1 == kSphere) {
    if (t2 == kSphere) return kSphereSphere;
    if (t2 == kBox) return kSphereBox;
    if (t2 == kCapsule) return kSphereCapsule;
    if (t2 == kPlane) return kSpherePlane;
  } else if (t1 == kBox) {
    if (t2 == kBox) return kBoxBox;
    if (t2 == kCapsule) return kBoxCapsule;
    if (t2 == kPlane) return kBoxPlane;
  } else if (t1 == kCapsule) {
    if (t2 == kCapsule) return kCapsuleCapsule;
    if (t2 == kPlane) return kCapsulePlane;
  }
  return kNoPair;
}

// ---------------------------------------------------------------------------
// Vectors, matrices and PyTorch's orders of summation
// ---------------------------------------------------------------------------

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
struct M3 {
  V3<T> r[3];  // rows: m[i][j] = r[i].j
};

template <typename T>
__device__ __forceinline__ T comp(const V3<T>& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}

template <typename T>
__device__ __forceinline__ V3<T> col(const M3<T>& m, int j) {
  return {comp(m.r[0], j), comp(m.r[1], j), comp(m.r[2], j)};
}

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> neg(V3<T> a) {
  return {-a.x, -a.y, -a.z};
}

template <typename T>
__device__ __forceinline__ V3<T> mul(V3<T> a, V3<T> b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}

// torch.sum over a contiguous last axis of 3: two lanes, (p0 + p2) + p1
template <typename T>
__device__ __forceinline__ T sum3_lanes(T p0, T p1, T p2) {
  return (p0 + p2) + p1;
}

// torch.sum over an axis of 3 that is not the fastest-moving: in order
template <typename T>
__device__ __forceinline__ T sum3_seq(T p0, T p1, T p2) {
  return (p0 + p1) + p2;
}

// _dot: torch.sum(a * b, -1)
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return sum3_lanes(a.x * b.x, a.y * b.y, a.z * b.z);
}

template <typename T>
__device__ __forceinline__ T norm(V3<T> a) {
  return sqrt(dot(a, a));
}

// _mv: m @ v, summed over the contiguous last axis
template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& m, V3<T> v) {
  return {dot(m.r[0], v), dot(m.r[1], v), dot(m.r[2], v)};
}

// _mtv: m.T @ v, summed over axis -2; also _mv on a transposed matrix,
// whose product PyTorch lays out transposed
template <typename T>
__device__ __forceinline__ V3<T> mtv(const M3<T>& m, V3<T> v) {
  return {sum3_seq(m.r[0].x * v.x, m.r[1].x * v.y, m.r[2].x * v.z),
          sum3_seq(m.r[0].y * v.x, m.r[1].y * v.y, m.r[2].y * v.z),
          sum3_seq(m.r[0].z * v.x, m.r[1].z * v.y, m.r[2].z * v.z)};
}

// _mtm: a.T @ b, summed over axis -3
template <typename T>
__device__ __forceinline__ M3<T> mtm(const M3<T>& a, const M3<T>& b) {
  M3<T> c;
  c.r[0] = mtv(b, col(a, 0));
  c.r[1] = mtv(b, col(a, 1));
  c.r[2] = mtv(b, col(a, 2));
  return c;
}

// NaN-propagating min, max and clamps, as torch.minimum / maximum / clamp
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// _sign: 1 where x >= 0, else -1
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x >= T(0) ? T(1) : T(-1);
}

// torch.sign: 1, -1 or 0
template <typename T>
__device__ __forceinline__ T torch_sign(T x) {
  return T((T(0) < x) - (x < T(0)));
}

template <typename T>
__device__ __forceinline__ V3<T> onehot(int i) {
  return {T(i == 0), T(i == 1), T(i == 2)};
}

// utils/quat.to_matrix
template <typename T>
__device__ __forceinline__ M3<T> to_matrix(const T* q) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  M3<T> m;
  m.r[0] = {T(1) - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy)};
  m.r[1] = {T(2) * (xy + wz), T(1) - T(2) * (xx + zz), T(2) * (yz - wx)};
  m.r[2] = {T(2) * (xz - wy), T(2) * (yz + wx), T(1) - T(2) * (xx + yy)};
  return m;
}

// ---------------------------------------------------------------------------
// A manifold of up to 8 slots
// ---------------------------------------------------------------------------

template <typename T>
struct Manifold {
  V3<T> p[kSlots];
  V3<T> n[kSlots];
  T d[kSlots];
  bool v[kSlots];
  int m;        // intrinsic slots
  int pairing;  // 0: pad to k; 1: box-box fold/top-k; 2: box-plane's
};

template <typename T>
__device__ __forceinline__ void one_slot(Manifold<T>& out, V3<T> point,
                                         V3<T> n, T depth) {
  out.p[0] = point;
  out.n[0] = n;
  out.d[0] = depth;
  out.v[0] = depth > T(0);
  out.m = 1;
  out.pairing = 0;
}

template <typename T>
struct Side {
  V3<T> p;
  const T* q;
  V3<T> s;
};

// ---------------------------------------------------------------------------
// Pair kernels (ops/pair_kernels.py, each formula in its order)
// ---------------------------------------------------------------------------

// _sphere_sphere's (point, normal, depth)
template <typename T>
__device__ __forceinline__ void sphere_sphere_core(V3<T> pa, T ra, V3<T> pb,
                                                   T rb, V3<T>& point,
                                                   V3<T>& n, T& depth) {
  const T eps = T(1e-9);
  const V3<T> d = sub(pb, pa);
  const T dist = norm(d);
  const T inv = clamp_min(dist, eps);
  n = {d.x / inv, d.y / inv, d.z / inv};
  if (!(dist > eps)) n = {T(0), T(1), T(0)};
  depth = ra + rb - dist;
  point = add(pa, scale(n, ra - T(0.5) * depth));
}

template <typename T>
__device__ void sphere_sphere(const Side<T>& a, const Side<T>& b,
                              Manifold<T>& out) {
  V3<T> point, n;
  T depth;
  sphere_sphere_core(a.p, a.s.x, b.p, b.s.x, point, n, depth);
  one_slot(out, point, n, depth);
}

// _sphere_box_core
template <typename T>
__device__ __forceinline__ void sphere_box_core(V3<T> center, T radius,
                                                V3<T> pb, const M3<T>& rb,
                                                V3<T> half, V3<T>& point,
                                                V3<T>& normal, T& depth) {
  const T eps = T(1e-9);
  const V3<T> pl = mtv(rb, sub(center, pb));
  const V3<T> nh = neg(half);
  const V3<T> clamped = {tmin(tmax(pl.x, nh.x), half.x),
                         tmin(tmax(pl.y, nh.y), half.y),
                         tmin(tmax(pl.z, nh.z), half.z)};
  const V3<T> delta = sub(pl, clamped);
  const T dist = norm(delta);
  const bool outside = dist > eps;
  V3<T> n_local, surf;
  if (outside) {
    const T c = clamp_min(dist, eps);
    const V3<T> nd = neg(delta);
    n_local = {nd.x / c, nd.y / c, nd.z / c};
    depth = radius - dist;
    surf = clamped;
  } else {
    const V3<T> fd = {half.x - fabs(pl.x), half.y - fabs(pl.y),
                      half.z - fabs(pl.z)};
    int ax = 0;  // argmin, the first among equals
    if (fd.y < comp(fd, ax)) ax = 1;
    if (fd.z < comp(fd, ax)) ax = 2;
    const V3<T> oh = onehot<T>(ax);
    const T p_ax = dot(pl, oh);
    const T fd_ax = dot(fd, oh);
    const V3<T> n_in = scale(oh, sgn(p_ax));
    n_local = n_in;
    depth = radius + fd_ax;
    surf = add(pl, scale(n_in, fd_ax));
  }
  point = add(pb, mv(rb, surf));
  normal = mv(rb, n_local);
}

template <typename T>
__device__ void sphere_box(const Side<T>& a, const Side<T>& b,
                           Manifold<T>& out) {
  V3<T> point, n;
  T depth;
  sphere_box_core(a.p, a.s.x, b.p, to_matrix(b.q), scale(b.s, T(0.5)), point,
                  n, depth);
  one_slot(out, point, n, depth);
}

// _plane_params: the plane's world normal (local +Z) and offset
template <typename T>
__device__ __forceinline__ void plane_params(const Side<T>& pl, V3<T>& n,
                                             T& d) {
  n = col(to_matrix(pl.q), 2);
  d = dot(n, pl.p);
}

template <typename T>
__device__ void sphere_plane(const Side<T>& a, const Side<T>& b,
                             Manifold<T>& out) {
  V3<T> n_p;
  T d_p;
  plane_params(b, n_p, d_p);
  const T h = dot(n_p, a.p) - d_p;
  one_slot(out, sub(a.p, scale(n_p, h)), neg(n_p), a.s.x - h);
}

// _segment_endpoints
template <typename T>
__device__ __forceinline__ void segment_endpoints(const Side<T>& c, V3<T>& e0,
                                                  V3<T>& e1, V3<T>& axis) {
  axis = col(to_matrix(c.q), 2);
  const T h = T(0.5) * c.s.y;
  e0 = sub(c.p, scale(axis, h));
  e1 = add(c.p, scale(axis, h));
}

// _closest_on_segment
template <typename T>
__device__ __forceinline__ V3<T> closest_on_segment(V3<T> a0, V3<T> a1,
                                                    V3<T> p) {
  const V3<T> d = sub(a1, a0);
  const T t = dot(sub(p, a0), d) / clamp_min(dot(d, d), T(1e-9));
  return add(a0, scale(d, clamp01(t)));
}

// _segment_segment
template <typename T>
__device__ __forceinline__ void segment_segment(V3<T> p0, V3<T> p1, V3<T> q0,
                                                V3<T> q1, V3<T>& cp,
                                                V3<T>& cq) {
  const T eps = T(1e-9);
  const V3<T> d1 = sub(p1, p0);
  const V3<T> d2 = sub(q1, q0);
  const V3<T> r = sub(p0, q0);
  const T a = dot(d1, d1);
  const T e = dot(d2, d2);
  const T f = dot(d2, r);
  const T c = dot(d1, r);
  const T b = dot(d1, d2);
  const T denom = a * e - b * b;
  T s = T(0);
  if (denom > eps) s = clamp01((b * f - c * e) / clamp_min(denom, eps));
  const T t = (b * s + f) / clamp_min(e, eps);
  const T t_cl = clamp01(t);
  s = clamp01((b * t_cl - c) / clamp_min(a, eps));
  cp = add(p0, scale(d1, s));
  cq = add(q0, scale(d2, t_cl));
}

template <typename T>
__device__ void sphere_capsule(const Side<T>& a, const Side<T>& b,
                               Manifold<T>& out) {
  V3<T> b0, b1, axis;
  segment_endpoints(b, b0, b1, axis);
  const V3<T> closest = closest_on_segment(b0, b1, a.p);
  V3<T> point, n;
  T depth;
  sphere_sphere_core(a.p, a.s.x, closest, b.s.x, point, n, depth);
  one_slot(out, point, n, depth);
}

template <typename T>
__device__ __forceinline__ T dist2(V3<T> a, V3<T> b) {
  const V3<T> d = sub(a, b);
  return dot(d, d);
}

template <typename T>
__device__ void capsule_capsule(const Side<T>& a, const Side<T>& b,
                                Manifold<T>& out) {
  V3<T> a0, a1, ax_a, b0, b1, ax_b;
  segment_endpoints(a, a0, a1, ax_a);
  segment_endpoints(b, b0, b1, ax_b);
  V3<T> ca, cb;
  segment_segment(a0, a1, b0, b1, ca, cb);
  sphere_sphere_core(ca, a.s.x, cb, b.s.x, out.p[0], out.n[0], out.d[0]);
  out.v[0] = out.d[0] > T(0);

  // parallel case: probe from the other end of capsule A's overlap range
  const bool parallel = fabs(dot(ax_a, ax_b)) > T(0.999);
  const bool far = dist2(ca, a0) > dist2(ca, a1);
  const V3<T> cb2 = closest_on_segment(b0, b1, far ? a0 : a1);
  const V3<T> ca2 = closest_on_segment(a0, a1, cb2);
  sphere_sphere_core(ca2, a.s.x, cb2, b.s.x, out.p[1], out.n[1], out.d[1]);
  const bool distinct = dist2(ca2, ca) > T(1e-8);
  out.v[1] = (out.d[1] > T(0)) && parallel && distinct;
  out.m = 2;
  out.pairing = 0;
}

template <typename T>
__device__ void capsule_plane(const Side<T>& a, const Side<T>& b,
                              Manifold<T>& out) {
  V3<T> n_p;
  T d_p;
  plane_params(b, n_p, d_p);
  V3<T> e[2], axis;
  segment_endpoints(a, e[0], e[1], axis);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T h = dot(n_p, e[i]) - d_p;
    out.d[i] = a.s.x - h;
    out.p[i] = sub(e[i], scale(n_p, h));
    out.n[i] = neg(n_p);
    out.v[i] = out.d[i] > T(0);
  }
  out.m = 2;
  out.pairing = 0;
}

// _capsule_box with the capsule as side a; box_capsule flips its normals
template <typename T>
__device__ void capsule_box(const Side<T>& a, const Side<T>& b,
                            Manifold<T>& out) {
  const M3<T> rb = to_matrix(b.q);
  const V3<T> half = scale(b.s, T(0.5));
  V3<T> e[3], axis;
  segment_endpoints(a, e[0], e[1], axis);
  e[2] = closest_on_segment(e[0], e[1], b.p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sphere_box_core(e[i], a.s.x, b.p, rb, half, out.p[i], out.n[i],
                    out.d[i]);
    out.v[i] = out.d[i] > T(0);
  }
  const bool dup = (norm(sub(e[2], e[0])) < T(1e-6)) ||
                   (norm(sub(e[2], e[1])) < T(1e-6));
  out.v[2] = out.v[2] && !dup;
  out.m = 3;
  out.pairing = 0;
}

template <typename T>
__device__ void box_plane(const Side<T>& a, const Side<T>& b,
                          Manifold<T>& out) {
  V3<T> n_p;
  T d_p;
  plane_params(b, n_p, d_p);
  const M3<T> ra = to_matrix(a.q);
  const V3<T> half = scale(a.s, T(0.5));
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // _BOX_CORNERS: (sx, sy, sz) for sx, sy, sz in (-1, 1), x slowest
    const V3<T> sgnv = {(c & 4) ? T(1) : T(-1), (c & 2) ? T(1) : T(-1),
                        (c & 1) ? T(1) : T(-1)};
    const V3<T> corner = add(a.p, mv(ra, mul(sgnv, half)));
    out.p[c] = corner;
    out.d[c] = d_p - dot(corner, n_p);
    out.v[c] = out.d[c] > T(0);
    out.n[c] = neg(n_p);
  }
  out.m = 8;
  out.pairing = 2;
}

// _clip_quad_to_rect: Sutherland-Hodgman against |x| <= hx, |y| <= hy, at
// most 8 vertices kept in emission order; slots past the count are zero
template <typename T>
__device__ __forceinline__ int clip_quad_to_rect(const T (&quad)[4][2], T hx,
                                                 T hy, T (&out)[8][2]) {
  const T eps = T(1e-9);
  T verts[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    verts[i][0] = i < 4 ? quad[i][0] : T(0);
    verts[i][1] = i < 4 ? quad[i][1] : T(0);
  }
  int count = 4;
#pragma unroll
  for (int plane = 0; plane < 4; ++plane) {
    // _CLIP_PLANES: (1, 0), (-1, 0), (0, 1), (0, -1)
    const T a = plane == 0 ? T(1) : (plane == 1 ? T(-1) : T(0));
    const T b = plane == 2 ? T(1) : (plane == 3 ? T(-1) : T(0));
    const T lim = plane < 2 ? hx : hy;
    T next[8][2];
    int n = 0;
    for (int i = 0; i < count; ++i) {
      const int j = (i + 1 >= count) ? 0 : i + 1;
      const T x = verts[i][0], y = verts[i][1];
      const T nx = verts[j][0], ny = verts[j][1];
      const T d_cur = a * x + b * y;
      const bool in_cur = d_cur <= lim;
      const bool in_nxt = a * nx + b * ny <= lim;
      const T dx = nx - x, dy = ny - y;
      const T denom = a * dx + b * dy;
      const bool crosses = fabs(denom) > eps;
      const T t = clamp01((lim - d_cur) / (crosses ? denom : T(1)));
      if (in_cur && n < 8) {
        next[n][0] = x;
        next[n][1] = y;
        ++n;
      }
      if (in_cur != in_nxt && crosses && n < 8) {
        next[n][0] = fma(t, dx, x);
        next[n][1] = fma(t, dy, y);
        ++n;
      }
    }
    for (int i = 0; i < 8; ++i) {
      verts[i][0] = i < n ? next[i][0] : T(0);
      verts[i][1] = i < n ? next[i][1] : T(0);
    }
    count = n;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i][0] = verts[i][0];
    out[i][1] = verts[i][1];
  }
  return count;
}

// _face_candidates: the incident corners clamped into the rectangle, and
// the rectangle's corners where they lie inside the incident quad
template <typename T>
__device__ __forceinline__ void face_candidates(const T (&quad)[4][2], T hx,
                                                T hy, T (&pts)[8][2],
                                                bool (&valid)[8]) {
  const T sx[4] = {T(-1), T(1), T(1), T(-1)};
  const T sy[4] = {T(-1), T(-1), T(1), T(1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pts[i][0] = tmin(tmax(quad[i][0], -hx), hx);
    pts[i][1] = tmin(tmax(quad[i][1], -hy), hy);
    valid[i] = true;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T rx = sx[i] * hx, ry = sy[i] * hy;
    bool all_ge = true, all_le = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jn = (j + 1) & 3;
      const T ex = quad[jn][0] - quad[j][0];
      const T ey = quad[jn][1] - quad[j][1];
      const T cross = ex * (ry - quad[j][1]) - ey * (rx - quad[j][0]);
      all_ge = all_ge && cross >= T(-1e-7);
      all_le = all_le && cross <= T(1e-7);
    }
    pts[4 + i][0] = rx;
    pts[4 + i][1] = ry;
    valid[4 + i] = all_ge || all_le;
  }
}

// _box_box: SAT over 15 axes with ODE's order and 1.05 face preference,
// then reference-face clipping or the edge-edge closest point
template <typename T>
__device__ void box_box(const Side<T>& A, const Side<T>& B, bool exact_clip,
                        Manifold<T>& out) {
  const T eps = T(1e-9);
  const T ninf = -INFINITY;
  const M3<T> ra = to_matrix(A.q);
  const M3<T> rb = to_matrix(B.q);
  const V3<T> ha = scale(A.s, T(0.5));
  const V3<T> hb = scale(B.s, T(0.5));

  const V3<T> t = mtv(ra, sub(B.p, A.p));  // B centre in A frame
  const M3<T> c = mtm(ra, rb);              // B orientation in A frame
  M3<T> absc;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    absc.r[i] = {fabs(c.r[i].x) + T(1e-6), fabs(c.r[i].y) + T(1e-6),
                 fabs(c.r[i].z) + T(1e-6)};
  T face[6];
  {
    const V3<T> m = mv(absc, hb);
    face[0] = fabs(t.x) - (ha.x + m.x);
    face[1] = fabs(t.y) - (ha.y + m.y);
    face[2] = fabs(t.z) - (ha.z + m.z);
    const V3<T> t_b = mtv(c, t);
    const V3<T> mt = mtv(absc, ha);
    face[3] = fabs(t_b.x) - (hb.x + mt.x);
    face[4] = fabs(t_b.y) - (hb.y + mt.y);
    face[5] = fabs(t_b.z) - (hb.z + mt.z);
  }

  // edge axes u[i, j] = e_i x C[:, j] (A frame), unit
  T edge_sep[9];
  bool edge_ok[9];
  V3<T> edge_unit[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const int i = e / 3, j = e % 3;
    const V3<T> cj = col(c, j);
    V3<T> u;
    if (i == 0) u = {T(0), -cj.z, cj.y};
    else if (i == 1) u = {cj.z, T(0), -cj.x};
    else u = {-cj.y, cj.x, T(0)};
    const T nu = norm(u);
    edge_ok[e] = nu > T(1e-6);
    const T cn = clamp_min(nu, eps);
    const V3<T> eu = {u.x / cn, u.y / cn, u.z / cn};
    edge_unit[e] = eu;
    const V3<T> aeu = {fabs(eu.x), fabs(eu.y), fabs(eu.z)};
    const T proj_a = dot(aeu, ha);
    const V3<T> in_b = mtv(c, eu);
    const V3<T> ain_b = {fabs(in_b.x), fabs(in_b.y), fabs(in_b.z)};
    const T proj_b = dot(ain_b, hb);
    edge_sep[e] = fabs(dot(eu, t)) - (proj_a + proj_b);
  }

  T max_all = face[0];
  for (int f = 1; f < 6; ++f) max_all = tmax(max_all, face[f]);
  for (int e = 0; e < 9; ++e) max_all = tmax(max_all, edge_ok[e] ? edge_sep[e] : ninf);
  const bool separated = max_all > T(0);

  // ODE's sequential axis choice: an edge axis must beat the best face
  // separation by the 1.05 fudge factor (float32 scalars)
  T best_face_sep = face[0];
  int best_face = 0;
  for (int f = 1; f < 6; ++f) {
    if (face[f] > best_face_sep) {
      best_face_sep = face[f];
      best_face = f;
    }
  }
  const T fudge = T(1.05f);
  const T inv_fudge = T(float(1.0 / 1.05));
  T best_edge_adj = ninf;
  int best_edge = 0;
  for (int e = 0; e < 9; ++e) {
    const T adj = edge_ok[e]
        ? edge_sep[e] * (edge_sep[e] < T(0) ? inv_fudge : fudge) : ninf;
    if (adj > best_edge_adj) {
      best_edge_adj = adj;
      best_edge = e;
    }
  }
  const bool use_edge = best_edge_adj > best_face_sep;

  if (use_edge) {
    // --------------------------- edge-edge case ---------------------------
    V3<T> u_a = edge_unit[0];
    T sep = edge_sep[0];
#pragma unroll
    for (int e = 1; e < 9; ++e) {
      if (e == best_edge) {
        u_a = edge_unit[e];
        sep = edge_sep[e];
      }
    }
    const V3<T> n_a = scale(u_a, sgn(dot(u_a, t)));
    const V3<T> n_world = mv(ra, n_a);
    const V3<T> oh_ei = onehot<T>(best_edge / 3);
    const V3<T> oh_ej = onehot<T>(best_edge % 3);
    const T ha_ei = dot(ha, oh_ei);
    const T hb_ej = dot(hb, oh_ej);
    const V3<T> one = {T(1), T(1), T(1)};
    const V3<T> sa = {sgn(n_a.x), sgn(n_a.y), sgn(n_a.z)};
    const V3<T> pa_sup = add(A.p, mv(ra, mul(mul(sa, sub(one, oh_ei)), ha)));
    const V3<T> da = mv(ra, oh_ei);
    const V3<T> a0 = sub(pa_sup, scale(da, ha_ei));
    const V3<T> a1 = add(pa_sup, scale(da, ha_ei));
    const V3<T> nb = neg(mtv(c, n_a));
    const V3<T> sb = {sgn(nb.x), sgn(nb.y), sgn(nb.z)};
    const V3<T> pb_sup = add(B.p, mv(rb, mul(mul(sb, sub(one, oh_ej)), hb)));
    const V3<T> db = mv(rb, oh_ej);
    const V3<T> b0 = sub(pb_sup, scale(db, hb_ej));
    const V3<T> b1 = add(pb_sup, scale(db, hb_ej));
    V3<T> ca, cb;
    segment_segment(a0, a1, b0, b1, ca, cb);
    const V3<T> point = scale(add(ca, cb), T(0.5));
    const T depth = -sep;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      out.p[s] = point;
      out.n[s] = n_world;
      out.d[s] = s == 0 ? depth : T(0);
      out.v[s] = s == 0 && depth > T(0) && !separated;
    }
    out.m = 8;
    out.pairing = 1;
    return;
  }

  // --------------------------- face case --------------------------------
  const bool face_is_a = best_face < 3;
  const int axis = face_is_a ? best_face : best_face - 3;
  const M3<T>& r_ref = face_is_a ? ra : rb;
  const M3<T>& r_inc = face_is_a ? rb : ra;
  const V3<T> p_ref = face_is_a ? A.p : B.p;
  const V3<T> p_inc = face_is_a ? B.p : A.p;
  const V3<T> h_ref = face_is_a ? ha : hb;
  const V3<T> h_inc = face_is_a ? hb : ha;

  const V3<T> n_raw = col(r_ref, axis);
  const V3<T> n_ref = scale(n_raw, sgn(dot(n_raw, sub(p_inc, p_ref))));
  const V3<T> n_world = face_is_a ? n_ref : neg(n_ref);
  const int idx0 = axis == 0 ? 1 : 0;
  const int idx1 = axis == 2 ? 1 : 2;
  const V3<T> u0 = col(r_ref, idx0), u1 = col(r_ref, idx1);
  const T hu0 = comp(h_ref, idx0), hu1 = comp(h_ref, idx1);
  const V3<T> face_center = add(p_ref, scale(n_ref, comp(h_ref, axis)));

  // incident face: the incident axis most anti-parallel to n_ref
  const V3<T> align = mtv(r_inc, n_ref);
  int inc_axis = 0;
  if (fabs(align.y) > fabs(comp(align, inc_axis))) inc_axis = 1;
  if (fabs(align.z) > fabs(comp(align, inc_axis))) inc_axis = 2;
  const T inc_sign = -torch_sign(comp(align, inc_axis));
  const V3<T> inc_vec = col(r_inc, inc_axis);
  const V3<T> inc_n = scale(inc_vec, inc_sign);
  const V3<T> inc_center = add(p_inc, scale(inc_n, comp(h_inc, inc_axis)));
  const int j0 = inc_axis == 0 ? 1 : 0;
  const int j1 = inc_axis == 2 ? 1 : 2;
  const V3<T> v0 = scale(col(r_inc, j0), comp(h_inc, j0));
  const V3<T> v1 = scale(col(r_inc, j1), comp(h_inc, j1));
  V3<T> quad_world[4];
  quad_world[0] = add(add(inc_center, v0), v1);
  quad_world[1] = sub(add(inc_center, v0), v1);
  quad_world[2] = sub(sub(inc_center, v0), v1);
  quad_world[3] = add(sub(inc_center, v0), v1);
  T quad[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const V3<T> rel = sub(quad_world[i], face_center);
    quad[i][0] = dot(rel, u0);
    quad[i][1] = dot(rel, u1);
  }
  T verts[8][2];
  bool cand[8];
  if (exact_clip) {
    const int count = clip_quad_to_rect(quad, hu0, hu1, verts);
#pragma unroll
    for (int s = 0; s < 8; ++s) cand[s] = s < count;
  } else {
    face_candidates(quad, hu0, hu1, verts, cand);
  }

  // lift each candidate onto the incident face plane
  const T denom = dot(inc_n, n_ref);
  const T d_inc = dot(inc_n, inc_center);
  const T den = fabs(denom) > T(1e-6) ? denom : T(1);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const V3<T> base = add(add(face_center, scale(u0, verts[s][0])),
                           scale(u1, verts[s][1]));
    const T z = (d_inc - dot(base, inc_n)) / den;
    const V3<T> lifted = add(base, scale(n_ref, z));
    const T depth = -z;
    out.p[s] = sub(lifted, scale(n_ref, T(0.5) * depth));
    out.n[s] = n_world;
    out.d[s] = depth;
    out.v[s] = cand[s] && depth > T(0) && !separated;
  }
  out.m = 8;
  out.pairing = 1;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store_slot(T* points, T* normals, T* depths,
                                           bool* valid, int64_t o, V3<T> p,
                                           V3<T> n, T d, bool v) {
  points[3 * o + 0] = p.x;
  points[3 * o + 1] = p.y;
  points[3 * o + 2] = p.z;
  normals[3 * o + 0] = n.x;
  normals[3 * o + 1] = n.y;
  normals[3 * o + 2] = n.z;
  depths[o] = d;
  valid[o] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
collide_pairs_kernel(const T* __restrict__ feats, const int* __restrict__ ia,
                     const int* __restrict__ ib,
                     const bool* __restrict__ cand_valid, T* points,
                     T* normals, T* depths, bool* valid, int B, int N, int CP,
                     int k, unsigned enabled, int exact_clip) {
  const int64_t slot = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (slot >= int64_t(B) * CP) return;
  const int64_t world = slot / CP;
  const int64_t base = slot * k;
  const V3<T> zero = {T(0), T(0), T(0)};

  const int i_a = ia[slot], i_b = ib[slot];
  int bit = kNoPair;
  bool swap = false;
  Side<T> sa, sb;
  if (cand_valid[slot] && i_a >= 0 && i_a < N && i_b >= 0 && i_b < N) {
    const T* fa = feats + (world * N + i_a) * kFeatures;
    const T* fb = feats + (world * N + i_b) * kFeatures;
    const int ta = int(fa[10]), tb = int(fb[10]);
    swap = ta > tb;
    const T* f1 = swap ? fb : fa;
    const T* f2 = swap ? fa : fb;
    sa = {{f1[0], f1[1], f1[2]}, f1 + 3, {f1[7], f1[8], f1[9]}};
    sb = {{f2[0], f2[1], f2[2]}, f2 + 3, {f2[7], f2[8], f2[9]}};
    bit = pair_bit(swap ? tb : ta, swap ? ta : tb);
    if (bit != kNoPair && !((enabled >> bit) & 1u)) bit = kNoPair;
  }
  if (bit == kNoPair) {
    for (int s = 0; s < k; ++s)
      store_slot(points, normals, depths, valid, base + s, zero, zero, T(0),
                 false);
    return;
  }

  Manifold<T> man;
  bool flip = swap;
  switch (bit) {
    case kSphereSphere: sphere_sphere(sa, sb, man); break;
    case kSphereBox: sphere_box(sa, sb, man); break;
    case kSphereCapsule: sphere_capsule(sa, sb, man); break;
    case kSpherePlane: sphere_plane(sa, sb, man); break;
    case kBoxBox: box_box(sa, sb, exact_clip != 0, man); break;
    case kBoxCapsule:  // _box_capsule: _capsule_box swapped, normals flipped
      capsule_box(sb, sa, man);
      flip = !flip;
      break;
    case kBoxPlane: box_plane(sa, sb, man); break;
    case kCapsuleCapsule: capsule_capsule(sa, sb, man); break;
    default: capsule_plane(sa, sb, man); break;
  }

  if (man.pairing != 0 && k == 4) {
    // _fold_manifold: slot i against slot hi, the valid one or the deeper
    for (int s = 0; s < 4; ++s) {
      const int hi = man.pairing == 1 ? 4 + s : 7 - s;
      const bool v_lo = man.v[s], v_hi = man.v[hi];
      const bool take_hi = (v_hi && !v_lo) ||
                           (v_hi && v_lo && man.d[hi] > man.d[s]);
      const int src = take_hi ? hi : s;
      const V3<T> n = man.n[src];
      store_slot(points, normals, depths, valid, base + s, man.p[src],
                 flip ? neg(n) : n, man.d[src], man.v[src]);
    }
  } else if (man.pairing != 0 && k < 8) {
    // _topk_manifold: the k deepest valid slots, stable among equals
    for (int s = 0; s < 8; ++s) {
      const T key = man.v[s] ? man.d[s] : T(-INFINITY);
      int rank = 0;
      for (int o = 0; o < 8; ++o) {
        const T other = man.v[o] ? man.d[o] : T(-INFINITY);
        rank += (other > key) || (o < s && other == key);
      }
      if (rank < k) {
        const V3<T> n = man.n[s];
        store_slot(points, normals, depths, valid, base + rank, man.p[s],
                   flip ? neg(n) : n, man.d[s], man.v[s]);
      }
    }
  } else {
    // _pad_manifold
    for (int s = 0; s < k; ++s) {
      if (s < man.m) {
        const V3<T> n = man.n[s];
        store_slot(points, normals, depths, valid, base + s, man.p[s],
                   flip ? neg(n) : n, man.d[s], man.v[s]);
      } else {
        store_slot(points, normals, depths, valid, base + s, zero, zero,
                   T(0), false);
      }
    }
  }
}

template <typename T>
int launch(const void* feats, const void* ia, const void* ib,
           const void* cand_valid, void* points, void* normals, void* depths,
           void* valid, int B, int N, int CP, int k, unsigned enabled,
           int exact_clip, void* stream) {
  if (B <= 0 || CP <= 0 || N < 0 || k < 1 || k > kSlots)
    return int(cudaErrorInvalidValue);
  const int64_t slots = int64_t(B) * CP;
  const unsigned blocks = unsigned((slots + kThreads - 1) / kThreads);
  collide_pairs_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const int*>(ia),
      static_cast<const int*>(ib), static_cast<const bool*>(cand_valid),
      static_cast<T*>(points), static_cast<T*>(normals),
      static_cast<T*>(depths), static_cast<bool*>(valid), B, N, CP, k,
      enabled, exact_clip);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int collide_pairs_launch(const void* feats, const void* ia,
                                    const void* ib, const void* cand_valid,
                                    void* points, void* normals,
                                    void* depths, void* valid, int B, int N,
                                    int CP, int k, unsigned enabled,
                                    int exact_clip, void* stream) {
  return launch<float>(feats, ia, ib, cand_valid, points, normals, depths,
                       valid, B, N, CP, k, enabled, exact_clip, stream);
}

extern "C" int collide_pairs_launch_f64(const void* feats, const void* ia,
                                        const void* ib,
                                        const void* cand_valid, void* points,
                                        void* normals, void* depths,
                                        void* valid, int B, int N, int CP,
                                        int k, unsigned enabled,
                                        int exact_clip, void* stream) {
  return launch<double>(feats, ia, ib, cand_valid, points, normals, depths,
                        valid, B, N, CP, k, enabled, exact_clip, stream);
}
