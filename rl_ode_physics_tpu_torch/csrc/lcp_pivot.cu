// DANTZIG's pivot loop for Hopper (sm_90a): the whole Murty principal block
// pivoting of every world's contact LCP, boxed friction rows included, in
// one launch a solve.
//
// Replaces no Pallas kernel. It replaces the JAX package's device loop of
// _pivot_solve: the lax.while_loop over pivot rounds
// (rl_ode_physics_tpu/ops/lcp.py:206, body :168-202, warm guess :203,
// final solve and projection :209-213), which under jit and vmap runs on
// the TPU with each world keeping its carry once it is done. In PyTorch the
// same loop is a Python loop with a host read of "every world done" a round
// (ops/lcp.py:_pivot_solve, the plain version), and each round LU-factors
// every world's whole (R, R) masked matrix.
//
// What it computes, per world, with A (R, R), b (R,), its valid rows and
// normal rows, μ a contact (or ∞), R = 3C rows ordered [normal | t1 | t2]:
//   * the kinds of rows: toggled (valid normal rows), bilateral (valid
//     friction rows with μ = ∞, always active), boxed (valid friction rows
//     with a finite μ; none without friction);
//   * the warm guess: active = bilateral, or toggled with b < 0; λ = 0;
//   * rounds, until the world is done or MAX_PIVOT_ROUNDS:
//       hi = μ·max(λ_n, 0) for a boxed row (its contact's normal row),
//       the clamp values of the inactive rows (±hi at their side, else 0),
//       λ = the masked solve: the active rows' A_CC λ_C = −b_C − A_CB λ_B,
//       the inactive rows at their clamp values; w = A λ + b;
//       the normal-row pivots, the boxed rows' clamps and releases, and
//       done = no row moved and max|λ − λ_prev| ≤ tol·(1 + max|λ|), tol
//       1e-7 in float64 and 30 ε in float32 (ops/lcp.py:193-202);
//   * the final masked solve on the last set and bounds, then the
//     projection: 0 on invalid rows, max(λ, 0) on normal rows, the box on
//     boxed rows. It writes λ (B, R) and each world's rounds (B,).
//
// The reduction. An inactive or invalid row of the plain version's masked
// matrix is e_i, and so is its column, so Gaussian elimination leaves it
// e_i and its λ the clamp value: the solve of the active block alone gives
// the same λ. A world has V valid rows (3 a live contact: ~30 in the
// settled mini stack against R = 288), and only the active ones, n ≤ V,
// are factored: ~2/3·n³ operations a solve against 2/3·R³.
//
// Design, simple and right first:
//   * One warp a world (a block each), lanes striding over its rows; no
//     barrier but __syncwarp.
//   * The valid rows found 32 flags at a time (__ballot_sync, a prefix
//     __popc keeps buffer order); V × V of A gathered once into shared
//     memory with b, μ and the row kinds, where V ≤ the launch's cap
//     (48 rows in float64, 64 in float32: under 48 KB a block, so 5-6
//     worlds on an SM); every round's work then reads shared memory only.
//   * A world with more valid rows takes the slower branch: it works in one
//     of the wrapper's pool slots in device memory (an R × R matrix and its
//     vectors), taken with an atomic lock and given back when it is done,
//     and reads A where _build_lcp left it. No world is refused; a world
//     waits for a slot only while POOL_WORLDS others hold them, and those
//     wait on nothing.
//   * A round gathers the active block into its matrix (row stride odd, so
//     that a lane a row reaches distinct banks) and solves it by Gaussian
//     elimination with partial pivoting, as jnp.linalg.solve's LU does (the
//     first largest |pivot|), on the right-hand side as it goes, then back
//     substitution. LU is right for any A; A is SPD where cfm > 0.
// TMA and wgmma do not fit: the rows to gather are scattered by the valid
// and active masks, and the blocks are small.
//
// Rounding: each world's sums run in its own order (the plain version's
// are cuBLAS's and the LU's), so the two agree to roundoff (chip_smoke.py
// holds λ to 1e-10 of max|λ| in float64, with the same rounds a world).
//
// Bound. Device memory: each world's valid rows' flags, its V × V block of
// A, b and μ in, λ (R) and its rounds out (~10 MB for 1,024 worlds at
// V ≈ 30 in float64, ~3 µs at 3.35 TB/s); the operations, (rounds + 1) ×
// (2/3·n³ + 4·V²) a world, are ~0.1 GFLOP there (~3 µs at 34 TFLOP/s
// FP64). What bounds it is the latency of each world's dependent chain:
// n pivot steps a solve, each a warp reduction, an exchange and an update.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRounds = 128;           // ops/lcp.MAX_PIVOT_ROUNDS
constexpr double kTol = 1e-10;            // ops/lcp._TOL
constexpr int kMaxShared = 48 * 1024;     // no opt-in needed
constexpr unsigned kAll = 0xffffffffu;

// a row's kind
enum : unsigned char { kToggled = 1, kBilateral = 2, kBoxed = 4 };

__host__ __device__ inline int odd(int n) { return n | 1; }

// The bytes of one world's work space for up to `cap` rows: the active
// block's matrix, with `staged` a copy of A's V × V block too, 6 vectors,
// 3 of ints and 3 of bytes. ops/lcp_kernel.world_bytes is the same sum.
template <typename T>
__host__ __device__ size_t world_bytes(int cap, bool staged) {
  const size_t mat = static_cast<size_t>(cap) * odd(cap);
  const size_t t = sizeof(T) * ((staged ? 2 : 1) * mat + 6 * cap);
  const size_t i = sizeof(int) * 3 * static_cast<size_t>(cap) + 3 * cap;
  return (t + i + 15) / 16 * 16;
}

template <typename T>
struct Work {
  T* m;        // the active block, eliminated in place
  T* a;        // A's valid block (staged), or null
  T* bv;       // b of the valid rows
  T* mu3;      // μ of their contacts (∞: none)
  T* lam;      // λ of the last round
  T* lnew;     // λ of this round
  T* hi;       // the bound of each boxed row
  T* x;        // the active rows' right-hand side, then their λ
  int* rows;   // the valid rows, in buffer order
  int* nrm;    // the local index of each row's normal row, or −1
  int* ai;     // the active rows, in order
  signed char* act;
  signed char* side;
  unsigned char* kind;
};

template <typename T>
__device__ Work<T> carve(unsigned char* base, int cap, bool staged) {
  Work<T> s;
  const size_t mat = static_cast<size_t>(cap) * odd(cap);
  T* p = reinterpret_cast<T*>(base);
  s.m = p;
  p += mat;
  s.a = staged ? p : nullptr;
  if (staged) p += mat;
  s.bv = p;
  s.mu3 = p + cap;
  s.lam = p + 2 * cap;
  s.lnew = p + 3 * cap;
  s.hi = p + 4 * cap;
  s.x = p + 5 * cap;
  int* q = reinterpret_cast<int*>(p + 6 * cap);
  s.rows = q;
  s.nrm = q + cap;
  s.ai = q + 2 * cap;
  signed char* c = reinterpret_cast<signed char*>(q + 3 * cap);
  s.act = c;
  s.side = c + cap;
  s.kind = reinterpret_cast<unsigned char*>(c + 2 * cap);
  return s;
}

// A's entry (i, j) in local row indices: from the staged block, or from
// the world's (R, R) matrix in device memory through the valid rows.
template <typename T>
struct Mat {
  const T* a;
  const int* rows;
  int ld;
  bool staged;
  __device__ __forceinline__ T operator()(int i, int j) const {
    return staged ? a[i * ld + j]
                  : a[static_cast<size_t>(rows[i]) * ld + rows[j]];
  }
};

struct Args {
  const void* a;              // (B, R, R)
  const void* b;              // (B, R)
  const bool* valid;          // (B, R)
  const bool* is_normal;      // (B, R)
  const void* mu;             // (B, C) or null (all ∞)
  void* lam;                  // (B, R) out
  int* rounds;                // (B,) out
  unsigned char* pool;        // pool_worlds slots of world_bytes(R, false)
  int* locks;                 // (pool_worlds,), zero
  int B, R, cap, pool_worlds, friction;
};

// The positions i < n where flag(i) holds, in order, into out[0, cap);
// returns their count.
template <typename F>
__device__ int compact(F flag, int n, int cap, int* out, int lane) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool on = i < n && flag(i);
    const unsigned m = __ballot_sync(kAll, on);
    const int pos = count + __popc(m & ((1u << lane) - 1u));
    if (on && pos < cap) out[pos] = i;
    count += __popc(m);
  }
  return count;
}

// the larger, NaN kept (torch.amax)
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (b > a || isnan(b)) ? b : a;
}

template <typename T>
__device__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// hi = μ·max(λ_n, 0) of row i, ∞ where μ is (ops/lcp.py: bounds)
template <typename T>
__device__ __forceinline__ T bound_of(const Work<T>& s, int i) {
  const T mu = s.mu3[i];
  if (isinf(mu)) return T(INFINITY);
  T ln = s.nrm[i] >= 0 ? s.lam[s.nrm[i]] : T(0);
  ln = ln < T(0) ? T(0) : ln;
  return mu * ln;
}

// a clamped row's value: ±hi at its side, 0 in the middle or unboxed
template <typename T>
__device__ __forceinline__ T clamp_value(const Work<T>& s, int i) {
  if (!(s.kind[i] & kBoxed)) return T(0);
  const signed char side = s.side[i];
  return side < 0 ? -s.hi[i] : (side > 0 ? s.hi[i] : T(0));
}

// x ← the solution of m x = x, m (n, n) at row stride ld: Gaussian
// elimination with partial pivoting (the first largest |pivot|), applied
// to x as it goes, then back substitution. m is overwritten.
template <typename T>
__device__ void gauss(T* m, T* x, int n, int ld, int lane) {
  for (int k = 0; k < n; ++k) {
    T best = T(-1);
    int at = n;
    for (int r = k + lane; r < n; r += 32) {
      const T v = fabs(m[r * ld + k]);
      if (v > best) {
        best = v;
        at = r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T ob = __shfl_xor_sync(kAll, best, o);
      const int oa = __shfl_xor_sync(kAll, at, o);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    if (at >= n) at = k;                 // a column of NaN: no exchange
    if (at != k) {
      for (int c = k + lane; c < n; c += 32) {
        const T t = m[k * ld + c];
        m[k * ld + c] = m[at * ld + c];
        m[at * ld + c] = t;
      }
      if (lane == 0) {
        const T t = x[k];
        x[k] = x[at];
        x[at] = t;
      }
    }
    __syncwarp();
    const T piv = m[k * ld + k];
    const T xk = x[k];
    const T* top = m + k * ld;
    for (int r = k + 1 + lane; r < n; r += 32) {
      T* row = m + r * ld;
      const T f = row[k] / piv;
      for (int c = k + 1; c < n; ++c) row[c] -= f * top[c];
      x[r] -= f * xk;
    }
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    const T xk = x[k] / m[k * ld + k];
    __syncwarp();
    if (lane == 0) x[k] = xk;
    for (int r = lane; r < k; r += 32) x[r] -= m[r * ld + k] * xk;
    __syncwarp();
  }
}

// lnew ← the masked solve of the world's V rows: the active rows against
// A with the inactive ones at their clamp values (s.hi, s.side).
template <typename T>
__device__ void masked_solve(const Work<T>& s, const Mat<T>& A, int V,
                             int lane) {
  const int n = compact([&](int i) { return s.act[i] != 0; }, V, V, s.ai,
                        lane);
  __syncwarp();
  const int ld = odd(n);
  for (int k = lane; k < n; k += 32) {
    const int i = s.ai[k];
    T contrib = T(0);
    for (int j = 0; j < V; ++j)
      if (!s.act[j]) contrib += A(i, j) * clamp_value(s, j);
    s.x[k] = -s.bv[i] - contrib;
  }
  for (int e = lane; e < n * n; e += 32) {
    const int k = e / n, l = e - k * n;
    s.m[k * ld + l] = A(s.ai[k], s.ai[l]);
  }
  __syncwarp();
  gauss(s.m, s.x, n, ld, lane);
  for (int k = lane; k < n; k += 32) s.lnew[s.ai[k]] = s.x[k];
  for (int i = lane; i < V; i += 32)
    if (!s.act[i]) s.lnew[i] = clamp_value(s, i);
  __syncwarp();
}

// The pivot loop of world w on its V valid rows (s.rows), then the final
// solve, the projection and the outputs.
template <typename T>
__device__ void solve_world(const Args& g, const Work<T>& s, const Mat<T>& A,
                            int w, int V, int lane) {
  const int R = g.R, C = R / 3;
  const T* b = static_cast<const T*>(g.b) + static_cast<size_t>(w) * R;
  const bool* normal = g.is_normal + static_cast<size_t>(w) * R;
  const T* mu = g.mu ? static_cast<const T*>(g.mu) + static_cast<size_t>(w) * C
                     : nullptr;
  const T inf = T(INFINITY), tol = T(kTol);
  for (int i = lane; i < V; i += 32) {
    const int r = s.rows[i], c = r % C;
    int lo = 0, hi = V;                  // the contact's normal row c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.rows[mid] < c) lo = mid + 1; else hi = mid;
    }
    s.nrm[i] = lo < V && s.rows[lo] == c ? lo : -1;
    const T bi = b[r];
    const T m3 = mu ? mu[c] : inf;
    unsigned char k = 0;
    if (normal[r]) k = kToggled;
    else if (g.friction) k = isinf(m3) ? kBilateral : kBoxed;
    s.bv[i] = bi;
    s.mu3[i] = m3;
    s.kind[i] = k;
    s.act[i] = (k & kBilateral) || ((k & kToggled) && bi < T(0));
    s.side[i] = 0;
    s.lam[i] = T(0);
  }
  __syncwarp();
  const T fp_tol = sizeof(T) == 8 ? T(1e3 * kTol) : T(30) * T(FLT_EPSILON);
  int round = 0;
  bool done = false;
  while (!done && round < kMaxRounds) {
    for (int i = lane; i < V; i += 32) s.hi[i] = bound_of(s, i);
    __syncwarp();
    masked_solve(s, A, V, lane);
    bool moved = false;
    T chg = T(0), big = T(0);
    for (int i = lane; i < V; i += 32) {
      T wi = T(0);
      for (int j = 0; j < V; ++j) wi += A(i, j) * s.lnew[j];
      wi = wi + s.bv[i];
      const unsigned char k = s.kind[i];
      const bool act = s.act[i] != 0, tog = k & kToggled;
      const bool box = k & kBoxed, bil = k & kBilateral;
      const signed char side = s.side[i];
      const T hi = s.hi[i], ln = s.lnew[i];
      const bool tiny = box && hi < tol;       // bound collapsed (λ_n = 0)
      // normal-row pivots (classic Murty)
      const bool rm_n = act && tog && ln < -tol;
      const bool add_n = !act && tog && wi < -tol;
      // boxed rows: leave the box → clamp at the bound; clamped with a
      // violating w sign → release; clamped at 0 with a live bound → enter
      const bool go_lo = act && box && ln < -hi - tol;
      const bool go_hi = act && box && ln > hi + tol;
      const bool rel_lo = !act && box && side < 0 && wi < -tol && !tiny;
      const bool rel_hi = !act && box && side > 0 && wi > tol && !tiny;
      const bool rel_mid = !act && box && side == 0 && !tiny;
      const bool nact = (act && !rm_n && !go_lo && !go_hi && !tiny) || add_n
                        || rel_lo || rel_hi || rel_mid || bil;
      signed char nside = go_lo ? -1 : (go_hi ? 1 : side);
      if (rel_lo || rel_hi || rel_mid) nside = 0;
      if (tiny) nside = 1;                    // sit at hi = 0
      if (!box) nside = 0;
      moved |= nact != act || nside != side;
      chg = max_nan(chg, fabs(ln - s.lam[i]));
      big = max_nan(big, fabs(ln));
      s.act[i] = nact;
      s.side[i] = nside;
    }
    moved = __any_sync(kAll, moved);
    chg = warp_max(chg);
    big = warp_max(big);
    // the bounds move with λ_n even at a stable set: the iterate itself
    // must be a fixed point
    done = !moved && chg <= fp_tol * (T(1) + big);
    for (int i = lane; i < V; i += 32) s.lam[i] = s.lnew[i];
    __syncwarp();
    ++round;
  }
  // the final consistent solve and the projection on the last set, bounds
  for (int i = lane; i < V; i += 32) s.hi[i] = bound_of(s, i);
  __syncwarp();
  masked_solve(s, A, V, lane);
  T* out = static_cast<T*>(g.lam) + static_cast<size_t>(w) * R;
  for (int i = lane; i < R; i += 32) out[i] = T(0);
  __syncwarp();
  for (int i = lane; i < V; i += 32) {
    const unsigned char k = s.kind[i];
    T l = s.lnew[i];
    if (k & kToggled) l = l < T(0) ? T(0) : l;
    if (k & kBoxed) {
      const T hi = s.hi[i];
      l = l < -hi ? -hi : l;
      l = l > hi ? hi : l;
    }
    out[s.rows[i]] = l;
  }
  if (lane == 0) g.rounds[w] = round;
}

// One warp a block, block w the world w.
template <typename T>
__global__ void __launch_bounds__(32) lcp_pivot_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x, lane = threadIdx.x, R = g.R;
  const bool* valid = g.valid + static_cast<size_t>(w) * R;
  const T* a = static_cast<const T*>(g.a) + static_cast<size_t>(w) * R * R;
  const Work<T> s = carve<T>(smem, g.cap, true);
  const int V = compact([&](int i) { return valid[i]; }, R, g.cap, s.rows,
                        lane);
  __syncwarp();
  if (V <= g.cap) {
    const int ld = odd(V);
    for (int e = lane; e < V * V; e += 32) {
      const int i = e / V, j = e - i * V;
      s.a[i * ld + j] = a[static_cast<size_t>(s.rows[i]) * R + s.rows[j]];
    }
    __syncwarp();
    solve_world<T>(g, s, Mat<T>{s.a, s.rows, ld, true}, w, V, lane);
    return;
  }
  // the slower branch: a pool slot in device memory, A read in place
  int slot = 0;
  if (lane == 0) {
    slot = w % g.pool_worlds;
    while (atomicCAS(&g.locks[slot], 0, 1) != 0) {
      slot = (slot + 1) % g.pool_worlds;
      __nanosleep(256);
    }
  }
  slot = __shfl_sync(kAll, slot, 0);
  __threadfence();
  const Work<T> d = carve<T>(g.pool + slot * world_bytes<T>(R, false), R,
                             false);
  compact([&](int i) { return valid[i]; }, R, R, d.rows, lane);
  __syncwarp();
  solve_world<T>(g, d, Mat<T>{a, d.rows, R, false}, w, V, lane);
  __syncwarp();
  __threadfence();
  if (lane == 0) atomicExch(&g.locks[slot], 0);
}

template <typename T>
int launch(const void* a, const void* b, const void* valid,
           const void* is_normal, const void* mu, void* lam, void* rounds,
           void* pool, void* locks, int B, int R, int cap, int pool_worlds,
           int friction, void* stream) {
  const size_t bytes = cap > 0 ? world_bytes<T>(cap, true) : 0;
  if (B <= 0 || R <= 0 || R % 3 != 0 || cap < 1 || cap > R
      || bytes > kMaxShared || pool_worlds < 0
      || (cap < R && (pool_worlds < 1 || !pool || !locks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{a, b, static_cast<const bool*>(valid),
         static_cast<const bool*>(is_normal), mu, lam,
         static_cast<int*>(rounds), static_cast<unsigned char*>(pool),
         static_cast<int*>(locks), B, R, cap, pool_worlds, friction != 0};
  lcp_pivot_kernel<T><<<B, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lcp_pivot_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  out[3] = attr.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

int lcp_pivot_launch(const void* a, const void* b, const void* valid,
                     const void* is_normal, const void* mu, void* lam,
                     void* rounds, void* pool, void* locks, int B, int R,
                     int cap, int pool_worlds, int friction, void* stream) {
  return launch<float>(a, b, valid, is_normal, mu, lam, rounds, pool, locks,
                       B, R, cap, pool_worlds, friction, stream);
}

int lcp_pivot_launch_f64(const void* a, const void* b, const void* valid,
                         const void* is_normal, const void* mu, void* lam,
                         void* rounds, void* pool, void* locks, int B, int R,
                         int cap, int pool_worlds, int friction,
                         void* stream) {
  return launch<double>(a, b, valid, is_normal, mu, lam, rounds, pool, locks,
                        B, R, cap, pool_worlds, friction, stream);
}

// registers a thread, local (spilled) bytes a thread, the most threads a
// block, the dynamic shared memory it may take: of the float32 kernel, or
// with f64 != 0 of the float64 one
int lcp_pivot_resources(int f64, int* out) {
  return f64 ? resources<double>(out) : resources<float>(out);
}

}  // extern "C"
