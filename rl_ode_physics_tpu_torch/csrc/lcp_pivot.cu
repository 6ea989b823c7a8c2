// DANTZIG's pivot loop for Hopper (sm_90a): the whole Murty principal block
// pivoting of every world's contact LCP, boxed friction rows included, in
// a fixed number of launches a solve and no read on the host.
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
//       the normal-row pivots, the boxed rows' clamps and releases, all
//       of them flipped at once; in a world with no boxed row (its bounds
//       fixed) only while the count of moving rows keeps falling below its
//       least, else (after kStallRounds rounds that did not lower it) the
//       first moving row alone, Murty's least-index rule (Júdice and
//       Pires' safeguard: block flips cycle on large piles);
//       done = no row moved and max|λ − λ_prev| ≤ tol·(1 + max|λ|), tol
//       1e-7 in float64 and 30 ε in float32 (ops/lcp._pivot_solve);
//   * the final masked solve on the last set and bounds, then the
//     projection: 0 on invalid rows, max(λ, 0) on normal rows, the box on
//     boxed rows. It writes λ (B, R) and each world's rounds (B,).
//
// The reduction. An inactive or invalid row of the plain version's masked
// matrix is e_i, and so is its column, so Gaussian elimination leaves it
// e_i and its λ the clamp value: the solve of the active block alone gives
// the same λ. A world has V valid rows (3 a contact), and only the active
// ones, n ≤ V, are factored: ~2/3·n³ operations a solve against 2/3·R³.
//
// Bound. Device memory: each world's valid flags, its V × V block of A, b
// and μ in, λ and its rounds out (~10 MB for 1,024 worlds at V ≈ 30 in
// float64, ~3 µs at 3.35 TB/s); the operations, (rounds + 1) × (2/3·n³ +
// 4·V²) a world, ~0.1 GFLOP there. What bounds it is each world's chain:
// n dependent pivot steps a solve (an argmax, the pivot's reciprocal, the
// next column's update), then n back-substitution steps
// (utils/bounds.lcp_pivot_bound, chain_ms): a step's chain is three
// reductions (redux), a shuffle, the reciprocal and an FMA in sequence.
//
// Design: tiers by the valid count V, counted on the card, so that the
// dispatch needs no host read and a fixed number of launches (a memset of
// the worklists' counters and three kernels):
//   * staged (V ≤ 32): a warp a world, block w the world w, a lane a valid
//     row. A's valid block is staged in shared memory (~9.5 KB in float64),
//     and each round the active rows' entries of the active block sit in
//     the lanes' registers, its columns compacted into row[0, n): nothing
//     of the elimination goes through memory. A step: the candidates' keys
//     (|pivot|, then position) reduced by redux, the pivot row shuffled to
//     the other lanes, one reciprocal, each row's update in registers; the
//     steps unrolled in straight-line code, those past n predicated off, so
//     that a step's tail overlaps the next step's argmax (a branch between
//     the columns made each shuffle wait for the previous column's FMA).
//     A 1,024-world batch is resident in one wave.
//   * medium (V ≤ 64): the same on two warps, persistent blocks that take
//     the worlds past the stage from a worklist; the argmax's candidates
//     and the pivot row pass through shared memory, two barriers a step,
//     each candidate's reciprocal taken while the argmax reduces, and 32,
//     48 or 64 steps unrolled as n needs. The capsule pile's ~42 rows land
//     here.
//   * large (V ≤ R): persistent blocks of 256 threads with the 227 KB
//     opt-in, the active block in shared memory up to nm rows (158 in
//     float64, 230 in float32 at R = 288), a larger one by a blocked
//     right-looking elimination: panels of 32 columns factored in shared
//     memory, U12 by forward substitution, the trailing matrix in the
//     block's own slot of device memory (R × (R + 1), L2-resident) updated a
//     64-column tile at a time with the tile's U12 beside the panel, until
//     the rest fits in shared memory. The panel (R × 33) and the world's
//     vectors (~95 bytes a row in float64) sit in shared memory beside the
//     region while they fit (R ≤ 597 in float64, 1,146 in float32); past
//     that ("far") they sit in the slot after the trailing matrix, and the
//     whole 227 KB holds the region (nm 169 / 240), so that every R is
//     solved. A step there: every warp finds the
//     argmax alike (no cross-warp pass: that would cost a second barrier),
//     the row exchange is a permutation kept in two buffers, one reciprocal,
//     warps over rows with the next group of rows loaded before the current
//     one is stored, lanes over columns; one barrier a step.
//   The staged kernel appends each world past its stage to the medium or
//   the large worklist (an atomic counter); no world is refused and none
//   waits on a lock.
//   * A world's arithmetic depends only on its own inputs and V, never on
//     which block or slot takes it, so a CUDA graph's replay equals the
//     eager launch bit for bit. The blocked elimination applies to each
//     element the same fused multiply-adds in the same order as the
//     unblocked one (the panel's multipliers, U12, the trailing update in
//     the panel's column order), and so does the register tiers'
//     elimination, so a world's λ does not depend on where its pivot steps
//     ran. The FP64 tensor cores (mma.sync m8n8k4) are not used: their sums
//     would break that equality, and the trailing update is not what bounds
//     a solve at these sizes (the pivot steps' chain is).
//   * The panel is loaded with plain loads through the permutation: its
//     rows are scattered by the masks, so TMA's tiles do not fit, and it is
//     R × 32 elements a panel against the trailing update's R² × 32
//     operations.
//
// Rounding: each world's sums run in its own order (the plain version's
// are cuBLAS's and the LU's, which divides where this multiplies by the
// pivot's correctly rounded reciprocal), so the two agree to roundoff
// (chip_smoke.py holds λ to 1e-10 of max|λ| in float64, with the same
// rounds a world).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRounds = 128;           // ops/lcp.MAX_PIVOT_ROUNDS
constexpr int kStallRounds = 3;           // ops/lcp.STALL_ROUNDS
constexpr double kTol = 1e-10;            // ops/lcp._TOL
constexpr int kMaxShared = 232448;        // 227 KB: the opt-in's limit
// the register tiers' most rows: a warp (staged), two warps (medium)
constexpr int kStagedRows = 32, kMediumRows = 64;
// the large tier's threads a block, and the most columns a thread updates
// in a pivot step (its shared rows + 1 ≤ 32 × that)
constexpr int kLargeThreads = 256, kLargeCols = 8;
constexpr int kPanel = 32;                // the blocked elimination's panel
constexpr int kPanelLd = kPanel + 1;
constexpr int kTile = 64;                 // the trailing update's columns
constexpr int kScratch = 64;              // a block's small slots
constexpr unsigned kAll = 0xffffffffu;

// a row's kind
enum : unsigned char { kToggled = 1, kBilateral = 2, kBoxed = 4 };
// the counters: each worklist's length and the worlds taken from it, the
// solves that took the blocked elimination
enum { kMediumLen = 0, kMediumTaken = 1, kLargeLen = 2, kLargeTaken = 3,
       kBlockedSolves = 4, kCounters = 8 };
// the block's int slots: the valid count, the active count, the world taken,
// then each warp's "a row moved"
enum { kSlotValid = 0, kSlotActive = 1, kSlotWorld = 2, kSlotMoved = 8,
       kSlotCount = 16, kSlotFirst = 24 };

__host__ __device__ inline int odd(int n) { return n | 1; }
__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
// 1 / x correctly rounded, as the division gives it
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// |v| as an unsigned key that orders like |v|, above 0 for any |v| ≥ 0;
// 0 for a lane with no candidate (v < 0) or NaN, which are never chosen
__device__ __forceinline__ unsigned long long abs_key(double v) {
  return v >= 0.0 ? static_cast<unsigned long long>(__double_as_longlong(v))
                        + 1ull
                  : 0ull;
}
__device__ __forceinline__ unsigned long long abs_key(float v) {
  return v >= 0.0f ? static_cast<unsigned long long>(__float_as_uint(v)) + 1ull
                   : 0ull;
}

// A large-tier block's memory; ops/lcp_kernel.py has the same sums. Its
// vectors: 8 of `cap` rows and kScratch of T, 7 of ints and kScratch, 3 of
// bytes, each part rounded up to 16 bytes.
template <typename T>
__host__ __device__ size_t vector_bytes(int cap) {
  const size_t c = static_cast<size_t>(cap);
  return align16((8 * c + kScratch) * sizeof(T))
         + align16((7 * c + kScratch) * sizeof(int)) + align16(3 * c);
}

// the panel's elements: R rows at stride kPanelLd, then a tile's U12
__host__ __device__ inline size_t panel_elems(int R) {
  return static_cast<size_t>(R) * kPanelLd + kPanel * kTile;
}

// shared memory: the region of `region` elements, then (unless far) the
// vectors; the panel lies in the region, unless far
template <typename T>
__host__ __device__ size_t shared_bytes(int R, size_t region, bool far) {
  return align16(region * sizeof(T)) + (far ? 0 : vector_bytes<T>(R));
}

// a block's slot of device memory: the trailing matrix R × (R + 1), then
// (far) the panel and the vectors
template <typename T>
__host__ __device__ size_t slot_bytes(int R, bool far) {
  return align16(static_cast<size_t>(R) * (R + 1) * sizeof(T))
         + (far ? align16(panel_elems(R) * sizeof(T)) + vector_bytes<T>(R)
                : 0);
}

template <typename T>
struct Work {
  T* mat;      // the elimination's region (shared memory)
  T* panel;    // the blocked elimination's panel and U12 tile
  T* bv;       // b of the valid rows
  T* mu3;      // μ of their contacts (∞: none)
  T* lam;      // λ of the last round
  T* lnew;     // λ of this round
  T* hi;       // the bound of each boxed row
  T* cv;       // each inactive row's clamp value, 0 on active rows
  T* y;        // the active block's right-hand side, then its λ
  T* dinv;     // the reciprocal of each pivot step's pivot
  T* red;      // each warp's partial maxima
  int* rows;   // the valid rows, in buffer order
  int* nrm;    // the local index of each row's normal row, or −1
  int* ai;     // the active rows, in order
  int* pa;     // two buffers of the row permutation (position → row)
  int* pb;
  int* la;     // the same for the part eliminated in shared memory
  int* lb;
  int* slots;  // kScratch ints (kSlot*)
  signed char* act;
  signed char* side;
  unsigned char* kind;
};

template <typename T>
__device__ Work<T> carve(T* mat, T* panel, unsigned char* base, int cap) {
  Work<T> s;
  s.mat = mat;
  s.panel = panel;
  T* p = reinterpret_cast<T*>(base);
  s.bv = p;
  s.mu3 = p + cap;
  s.lam = p + 2 * cap;
  s.lnew = p + 3 * cap;
  s.hi = p + 4 * cap;
  s.cv = p + 5 * cap;
  s.y = p + 6 * cap;
  s.dinv = p + 7 * cap;
  s.red = p + 8 * cap;
  const size_t tb = align16((8 * static_cast<size_t>(cap) + kScratch)
                            * sizeof(T));
  int* q = reinterpret_cast<int*>(base + tb);
  s.rows = q;
  s.nrm = q + cap;
  s.ai = q + 2 * cap;
  s.pa = q + 3 * cap;
  s.pb = q + 4 * cap;
  s.la = q + 5 * cap;
  s.lb = q + 6 * cap;
  s.slots = q + 7 * cap;
  const size_t ib = align16((7 * static_cast<size_t>(cap) + kScratch)
                            * sizeof(int));
  signed char* c = reinterpret_cast<signed char*>(base + tb + ib);
  s.act = c;
  s.side = c + cap;
  s.kind = reinterpret_cast<unsigned char*>(c + 2 * cap);
  return s;
}

// A's entry (i, j) in local row indices, read where it lies: the world's
// (R, R) matrix through its valid rows.
template <typename T>
struct AView {
  const T* a;
  const int* rows;
  int ld;
  __device__ __forceinline__ T operator()(int i, int j) const {
    return a[static_cast<size_t>(rows[i]) * ld + rows[j]];
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
  int* counters;              // kCounters, zeroed before the launches
  int* lists;                 // the medium and the large worklist, B each
  void* slots;                // a large block's slot each (slot_bytes)
  int B, R, friction, cap_s, cap_m;
};

// The positions i < n where flag(i) holds, in order, into out[0, cap): warp
// 0 by ballot; returns their count to every thread (through *slot).
template <typename F>
__device__ int block_compact(F flag, int n, int cap, int* out, int* slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool on = i < n && flag(i);
      const unsigned m = __ballot_sync(kAll, on);
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      if (on && pos < cap) out[pos] = i;
      count += __popc(m);
    }
    if (lane == 0) *slot = count;
  }
  __syncthreads();
  return *slot;
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

// sink(r, Σ_j term(r, j)) for r < nrows, j < ncols: a group of g threads
// a row (the most that still takes every row at once, and no more than the
// columns need), lanes over j, a shuffle tree. Every thread of the block
// calls it.
template <int NT, typename T, typename F, typename S>
__device__ __forceinline__ void group_dots(int nrows, int ncols, F term,
                                           S sink) {
  int lg = 5;
  while (lg > 0 && ((NT >> lg) < nrows || (1 << (lg - 1)) >= ncols)) --lg;
  const int g = 1 << lg, sub = threadIdx.x & (g - 1);
  const int grp = threadIdx.x >> lg, ngrp = NT >> lg;
  for (int r0 = 0; r0 < nrows; r0 += ngrp) {
    const int r = r0 + grp;
    T s = T(0);
    if (r < nrows)
      for (int j = sub; j < ncols; j += g) s += term(r, j);
    for (int o = g >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kAll, s, o);
    if (r < nrows && sub == 0) sink(r, s);
  }
}

// The position of the first largest |m(row pa[i], col)| among positions
// [k, n), in every warp alike; k if the column is all NaN. Each lane keeps
// the first largest of its positions, then the warp's largest key (its
// high and low words by redux) and the first position holding it.
template <typename T>
__device__ __forceinline__ int warp_argmax(const T* m, int ld, const int* pa,
                                           int k, int n, int col) {
  const int lane = threadIdx.x & 31;
  T best = T(-1);
  int at = n;
  for (int i = k + lane; i < n; i += 32) {
    const T v = fabs(m[pa[i] * ld + col]);
    if (v > best) {
      best = v;
      at = i;
    }
  }
  const unsigned long long key = abs_key(best);
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned top = __reduce_max_sync(kAll, hi);
  const unsigned low = __reduce_max_sync(kAll, hi == top ? lo : 0u);
  const bool first = hi == top && lo == low;
  const int pos = __reduce_min_sync(kAll, first ? at : n);
  return pos >= n ? k : pos;
}

// One group of kRows rows of a pivot step's update (their rows r, the
// multipliers f = m[r][kc]·inv and this lane's kQ columns), loaded at once.
template <int NW, int kRows, int kQ, typename T>
__device__ __forceinline__ void load_rows(const T* m, int ld, const int* pa,
                                          int i0, int at, int pk, int n,
                                          int kc, int c1, T inv,
                                          int (&r)[kRows], T (&f)[kRows],
                                          T (&a)[kRows][kQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const int i = i0 + h * NW;
    r[h] = i < n ? (i == at ? pk : pa[i]) : -1;
  }
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    f[h] = r[h] >= 0 ? m[r[h] * ld + kc] * inv : T(0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = kc + 1 + lane + 32 * q;
      a[h][q] = r[h] >= 0 && c < c1 ? m[r[h] * ld + c] : T(0);
    }
  }
}

// One pivot step's update of the rows at positions (k, n) (row at position
// i: pa[i], at `at` the old pivot position's row pk), in columns (kc, c1):
// f = m[r][kc]·inv, m[r][c] −= f·m[pr][c]; with kStoreL f is kept in
// m[r][kc] (the panel's multipliers). Warps over rows, kRows of them a
// group, the next group loaded before the current one is stored (rows
// differ, so the loads may pass the stores); lanes over columns, at most kQ
// a lane (c1 − kc − 1 ≤ 32·kQ).
template <int NT, bool kStoreL, int kQ, typename T>
__device__ __forceinline__ void step_update(T* m, int ld, const int* pa,
                                            int k, int at, int pk, int pr,
                                            int n, int kc, int c1, T inv) {
  constexpr int NW = NT / 32, kRows = kQ > 4 ? 2 : 4;
  constexpr int kStride = NW * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (n - k - 1 <= 0) return;
  T u[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int c = kc + 1 + lane + 32 * q;
    u[q] = c < c1 ? m[pr * ld + c] : T(0);
  }
  int r[kRows];
  T f[kRows], a[kRows][kQ];
  int i0 = k + 1 + warp;
  load_rows<NW>(m, ld, pa, i0, at, pk, n, kc, c1, inv, r, f, a);
  for (; i0 < n; i0 += kStride) {
    int rn[kRows];
    T fn[kRows], an[kRows][kQ];
    const bool more = i0 + kStride < n;
    if (more)
      load_rows<NW>(m, ld, pa, i0 + kStride, at, pk, n, kc, c1, inv, rn, fn,
                    an);
    if (kStoreL) {
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kRows; ++h)
          if (r[h] >= 0) m[r[h] * ld + kc] = f[h];
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int c = kc + 1 + lane + 32 * q;
        if (r[h] >= 0 && c < c1) m[r[h] * ld + c] = fmadd(-f[h], u[q], a[h][q]);
      }
    }
    if (more) {
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
        r[h] = rn[h];
        f[h] = fn[h];
#pragma unroll
        for (int q = 0; q < kQ; ++q) a[h][q] = an[h][q];
      }
    }
  }
}

// The pivot step's exchange: pb ← pa with positions k and at swapped.
template <int NT>
__device__ __forceinline__ void next_perm(const int* pa, int* pb, int k,
                                          int at, int n) {
  const int pk = pa[k], pr = pa[at];
  for (int i = threadIdx.x; i < n; i += NT)
    pb[i] = i == k ? pr : (i == at ? pk : pa[i]);
}

// Gaussian elimination with partial pivoting (the first largest |pivot|,
// as jnp.linalg.solve's LU) of the mm × (mm + 1) augmented matrix m at row
// stride ld, rows through the permutation pa (identity on entry): one
// barrier a step. dinv[k] ← 1 / the k-th pivot. Returns the buffer that
// holds the final permutation.
template <int NT, int kQ, typename T>
__device__ int* eliminate(T* m, int ld, int mm, int* pa, int* pb, T* dinv) {
  for (int k = 0; k < mm; ++k) {
    const int at = warp_argmax(m, ld, pa, k, mm, k);
    const int pk = pa[k], pr = pa[at];
    const T inv = recip(m[pr * ld + k]);
    next_perm<NT>(pa, pb, k, at, mm);
    if (threadIdx.x == 0) dinv[k] = inv;
    step_update<NT, false, kQ>(m, ld, pa, k, at, pk, pr, mm, k, mm + 1, inv);
    __syncthreads();
    int* t = pa;
    pa = pb;
    pb = t;
  }
  return pa;
}

// y ← the solution of U x = y, U(i, c) (c ≥ i) the eliminated rows at
// positions i < n, dinv their pivots' reciprocals, the right-hand side
// U(i, n): in blocks of 32 rows from the last, each a block-wide product of
// the solved part, then warp 0's triangular solve on shuffles (kPreload:
// the block's column read into registers first, for rows in device
// memory).
template <int NT, bool kPreload, typename T, typename UF>
__device__ void back_substitute(UF U, int n, const T* dinv, T* y) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < n; i += NT) y[i] = U(i, n);
  __syncthreads();
  for (int lo = (n - 1) & ~31; lo >= 0; lo -= 32) {
    const int hi = min(lo + 32, n), nb = hi - lo;
    if (hi < n) {
      group_dots<NT, T>(
          nb, n - hi, [&](int r, int j) { return U(lo + r, hi + j) * y[hi + j]; },
          [&](int r, T s) { y[lo + r] -= s; });
      __syncthreads();
    }
    if (tid < 32) {
      T yv = lane < nb ? y[lo + lane] : T(0);
      if constexpr (kPreload) {
        T u[32];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          u[k] = (lane < k && k < nb) ? U(lo + lane, lo + k) : T(0);
#pragma unroll
        for (int k = 31; k >= 0; --k) {
          if (k < nb) {
            const T xk = __shfl_sync(kAll, yv, k) * dinv[lo + k];
            if (lane < k) yv = fmadd(-u[k], xk, yv);
            if (lane == k) y[lo + k] = xk;
          }
        }
      } else {
        for (int k = nb - 1; k >= 0; --k) {
          const T xk = __shfl_sync(kAll, yv, k) * dinv[lo + k];
          if (lane < k) yv = fmadd(-U(lo + lane, lo + k), xk, yv);
          if (lane == k) y[lo + k] = xk;
        }
      }
    }
    __syncthreads();
  }
}

// One panel of the blocked elimination of the n × (n + 1) augmented
// matrix in `slot` (row stride lds, rows through pa), positions and
// columns [p0, p0 + kPanel): the panel's columns of the rows at positions
// ≥ p0 factored in shared memory (P, rows by their index, stride
// kPanelLd), its multipliers kept there; its rows written back; U12 by
// forward substitution; the trailing matrix updated in the panel's column
// order, a tile of kTile columns at a time with the tile's U12 staged
// after P. An even number of steps: pa holds the permutation again after
// it. P lies in shared memory, or (far) in the block's slot.
template <int NT, typename T>
__device__ void panel_step(T* slot, int lds, int n, int p0, int* pa, int* pb,
                           T* P, T* dinv) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = p0 + warp; i < n; i += NW) {
    const int r = pa[i];
    P[r * kPanelLd + lane] = slot[static_cast<size_t>(r) * lds + p0 + lane];
  }
  __syncthreads();
  int* qa = pa;
  int* qb = pb;
  for (int k = p0; k < p0 + kPanel; ++k) {
    const int kc = k - p0;
    const int at = warp_argmax(P, kPanelLd, qa, k, n, kc);
    const int pk = qa[k], pr = qa[at];
    const T inv = recip(P[pr * kPanelLd + kc]);
    next_perm<NT>(qa, qb, k, at, n);
    if (tid == 0) dinv[k] = inv;
    step_update<NT, true, 1>(P, kPanelLd, qa, k, at, pk, pr, n, kc, kPanel,
                             inv);
    __syncthreads();
    int* t = qa;
    qa = qb;
    qb = t;
  }
  // the panel's rows of U
  for (int q = warp; q < kPanel; q += NW) {
    const int r = pa[p0 + q];
    slot[static_cast<size_t>(r) * lds + p0 + lane] = P[r * kPanelLd + lane];
  }
  // U12: the panel's rows in the trailing columns, by forward substitution
  const int r0 = p0 + kPanel;
  const int* lrow = pa + p0;
  for (int c = r0 + tid; c <= n; c += NT) {
    T u[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      u[j] = slot[static_cast<size_t>(lrow[j]) * lds + c];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
#pragma unroll
      for (int i = j + 1; i < kPanel; ++i)
        u[i] = fmadd(-P[lrow[i] * kPanelLd + j], u[j], u[i]);
    }
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      slot[static_cast<size_t>(lrow[j]) * lds + c] = u[j];
  }
  __syncthreads();
  // the trailing matrix: a warp's tile 8 rows × kTile columns
  T* us = P + static_cast<size_t>(n) * kPanelLd;
  const int rt = (n - r0 + 7) / 8;
  for (int c0 = r0; c0 <= n; c0 += kTile) {
    for (int e = tid; e < kPanel * kTile; e += NT) {
      const int j = e / kTile, c = c0 + e % kTile;
      us[e] = c <= n ? slot[static_cast<size_t>(lrow[j]) * lds + c] : T(0);
    }
    __syncthreads();
    for (int t = warp; t < rt; t += NW) {
      const int i0 = r0 + t * 8;
      int row[8];
      T acc[8][2];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        row[q] = i0 + q < n ? pa[i0 + q] : -1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + lane + 32 * h;
          acc[q][h] = row[q] >= 0 && c <= n
                          ? slot[static_cast<size_t>(row[q]) * lds + c]
                          : T(0);
        }
      }
#pragma unroll 4
      for (int j = 0; j < kPanel; ++j) {
        const T u0 = us[j * kTile + lane], u1 = us[j * kTile + 32 + lane];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const T l = row[q] >= 0 ? P[row[q] * kPanelLd + j] : T(0);
          acc[q][0] = fmadd(-l, u0, acc[q][0]);
          acc[q][1] = fmadd(-l, u1, acc[q][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + lane + 32 * h;
          if (row[q] >= 0 && c <= n)
            slot[static_cast<size_t>(row[q]) * lds + c] = acc[q][h];
        }
      }
    }
    __syncthreads();
  }
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

// The active block of n > nm rows: gathered into `slot`, panels of the
// blocked elimination until at most nm rows are left, those eliminated in
// shared memory, then back substitution through both.
template <int NT, int kQ, typename T>
__device__ void masked_solve_blocked(const Args& g, const Work<T>& s,
                                     const AView<T>& A, int n,
                                     int V, T* slot, int nm) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lds = g.R + 1;
  for (int k = warp; k < n; k += NW) {
    const int rk = s.ai[k];
    T* row = slot + static_cast<size_t>(k) * lds;
    for (int l = lane; l < n; l += 32) row[l] = A(rk, s.ai[l]);
  }
  group_dots<NT, T>(
      n, V, [&](int k, int j) { return A(s.ai[k], j) * s.cv[j]; },
      [&](int k, T c) {
        slot[static_cast<size_t>(k) * lds + n] = -s.bv[s.ai[k]] - c;
      });
  for (int i = tid; i < n; i += NT) s.pa[i] = i;
  if (tid == 0) atomicAdd(&g.counters[kBlockedSolves], 1);
  __syncthreads();
  int p0 = 0;
  while (n - p0 > nm) {
    panel_step<NT>(slot, lds, n, p0, s.pa, s.pb, s.panel, s.dinv);
    p0 += kPanel;
  }
  // the rest, positions [p0, n), in shared memory
  const int mm = n - p0, ld = odd(mm + 1);
  T* m = s.mat;
  for (int q = warp; q < mm; q += NW) {
    const T* src = slot + static_cast<size_t>(s.pa[p0 + q]) * lds + p0;
    T* dst = m + q * ld;
    for (int c = lane; c <= mm; c += 32) dst[c] = src[c];
  }
  for (int i = tid; i < mm; i += NT) s.la[i] = i;
  __syncthreads();
  const int* lf = eliminate<NT, kQ>(m, ld, mm, s.la, s.lb, s.dinv + p0);
  const int* pa = s.pa;
  back_substitute<NT, true, T>(
      [&](int i, int c) {
        return i < p0 ? slot[static_cast<size_t>(pa[i]) * lds + c]
                      : m[lf[i - p0] * ld + c - p0];
      },
      n, s.dinv, s.y);
}

// lnew ← the masked solve of the world's V rows: the active rows against
// A with the inactive ones at their clamp values. The active block in
// shared memory where it has at most nm rows, else in `slot`.
template <int NT, int kQ, typename T>
__device__ void masked_solve(const Args& g, const Work<T>& s,
                             const AView<T>& A, int V, T* slot,
                             int nm) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < V; i += NT) {
    const T h = bound_of(s, i);
    s.hi[i] = h;
    T c = T(0);
    if (!s.act[i] && (s.kind[i] & kBoxed))
      c = s.side[i] < 0 ? -h : (s.side[i] > 0 ? h : T(0));
    s.cv[i] = c;
  }
  const int n = block_compact([&](int i) { return s.act[i] != 0; }, V, V,
                              s.ai, &s.slots[kSlotActive]);
  if (n > 0 && n <= nm) {
    T* m = s.mat;
    const int ld = odd(n + 1);
    for (int k = warp; k < n; k += NW) {
      const int rk = s.ai[k];
      T* row = m + k * ld;
      for (int l = lane; l < n; l += 32) row[l] = A(rk, s.ai[l]);
    }
    group_dots<NT, T>(
        n, V, [&](int k, int j) { return A(s.ai[k], j) * s.cv[j]; },
        [&](int k, T c) { m[k * ld + n] = -s.bv[s.ai[k]] - c; });
    for (int i = tid; i < n; i += NT) s.la[i] = i;
    __syncthreads();
    const int* lf = eliminate<NT, kQ>(m, ld, n, s.la, s.lb, s.dinv);
    back_substitute<NT, false, T>(
        [&](int i, int c) { return m[lf[i] * ld + c]; }, n, s.dinv, s.y);
  }
  if (n > nm) masked_solve_blocked<NT, kQ>(g, s, A, n, V, slot, nm);
  for (int i = tid; i < V; i += NT)
    if (!s.act[i]) s.lnew[i] = s.cv[i];
  for (int k = tid; k < n; k += NT) s.lnew[s.ai[k]] = s.y[k];
  __syncthreads();
}

// The pivot loop of world w on its V valid rows (s.rows), then the final
// solve, the projection and the outputs. Every thread of the block.
template <int NT, int kQ, typename T>
__device__ void solve_world(const Args& g, const Work<T>& s,
                            const AView<T>& A, int w, int V,
                            T* slot, int nm) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = g.R, C = R / 3;
  const T* b = static_cast<const T*>(g.b) + static_cast<size_t>(w) * R;
  const bool* normal = g.is_normal + static_cast<size_t>(w) * R;
  const T* mu = g.mu ? static_cast<const T*>(g.mu) + static_cast<size_t>(w) * C
                     : nullptr;
  const T inf = T(INFINITY), tol = T(kTol);
  bool boxed = false;
  for (int i = tid; i < V; i += NT) {
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
    boxed |= (k & kBoxed) != 0;
  }
  // the safeguard holds only where the bounds are fixed: no boxed row
  const bool fixed = !__syncthreads_or(boxed);
  const T fp_tol = sizeof(T) == 8 ? T(1e3 * kTol) : T(30) * T(FLT_EPSILON);
  int round = 0;
  bool done = false;
  // the safeguard: the least count of moving rows, the rounds since it fell
  int best = V + 1, stall = 0;
  while (!done && round < kMaxRounds) {
    masked_solve<NT, kQ, T>(g, s, A, V, slot, nm);
    bool moved = false;
    int count = 0, first = V;
    T chg = T(0), big = T(0);
    group_dots<NT, T>(
        V, V, [&](int i, int j) { return A(i, j) * s.lnew[j]; },
        [&](int i, T wi) {
          wi = wi + s.bv[i];
          const unsigned char k = s.kind[i];
          const bool act = s.act[i] != 0, tog = k & kToggled;
          const bool box = k & kBoxed, bil = k & kBilateral;
          const signed char side = s.side[i];
          const T hi = s.hi[i], ln = s.lnew[i];
          const bool tiny = box && hi < tol;     // bound collapsed (λ_n = 0)
          // normal-row pivots (classic Murty)
          const bool rm_n = act && tog && ln < -tol;
          const bool add_n = !act && tog && wi < -tol;
          // boxed rows: leave the box → clamp at the bound; clamped with a
          // violating w sign → release; clamped at 0 with a live bound →
          // enter
          const bool go_lo = act && box && ln < -hi - tol;
          const bool go_hi = act && box && ln > hi + tol;
          const bool rel_lo = !act && box && side < 0 && wi < -tol && !tiny;
          const bool rel_hi = !act && box && side > 0 && wi > tol && !tiny;
          const bool rel_mid = !act && box && side == 0 && !tiny;
          const bool nact = (act && !rm_n && !go_lo && !go_hi && !tiny)
                            || add_n || rel_lo || rel_hi || rel_mid || bil;
          signed char nside = go_lo ? -1 : (go_hi ? 1 : side);
          if (rel_lo || rel_hi || rel_mid) nside = 0;
          if (tiny) nside = 1;                  // sit at hi = 0
          if (!box) nside = 0;
          const bool mv = nact != act || nside != side;
          moved |= mv;
          if (mv) {
            ++count;
            first = min(first, i);
          }
          chg = max_nan(chg, fabs(ln - s.lam[i]));
          big = max_nan(big, fabs(ln));
          // the row's move, applied once the round's count is known (the
          // permutation buffer is free until the next solve)
          s.pb[i] = mv ? 1 | (nact << 1) | ((nside + 1) << 2) : 0;
        });
    moved = __any_sync(kAll, moved);
    count = __reduce_add_sync(kAll, count);
    first = __reduce_min_sync(kAll, first);
    chg = warp_max(chg);
    big = warp_max(big);
    if (lane == 0) {
      s.red[warp] = chg;
      s.red[NW + warp] = big;
      s.slots[kSlotMoved + warp] = moved;
      s.slots[kSlotCount + warp] = count;
      s.slots[kSlotFirst + warp] = first;
    }
    __syncthreads();
    chg = T(0);
    big = T(0);
    moved = false;
    count = 0;
    first = V;
    for (int q = 0; q < NW; ++q) {
      chg = max_nan(chg, s.red[q]);
      big = max_nan(big, s.red[NW + q]);
      moved |= s.slots[kSlotMoved + q] != 0;
      count += s.slots[kSlotCount + q];
      first = min(first, s.slots[kSlotFirst + q]);
    }
    // block flips while the count falls below its least, else the first
    // moving row alone (Murty's least-index rule)
    stall = count < best ? 0 : stall + 1;
    best = min(best, count);
    const bool single = fixed && stall >= kStallRounds;
    // the bounds move with λ_n even at a stable set: the iterate itself
    // must be a fixed point
    done = !moved && chg <= fp_tol * (T(1) + big);
    for (int i = tid; i < V; i += NT) {
      const int mv = s.pb[i];
      if (mv && (!single || i == first)) {
        s.act[i] = (mv >> 1) & 1;
        s.side[i] = static_cast<signed char>(((mv >> 2) & 3) - 1);
      }
      s.lam[i] = s.lnew[i];
    }
    __syncthreads();
    ++round;
  }
  // the final consistent solve and the projection on the last set, bounds
  masked_solve<NT, kQ, T>(g, s, A, V, slot, nm);
  T* out = static_cast<T*>(g.lam) + static_cast<size_t>(w) * R;
  for (int i = tid; i < R; i += NT) out[i] = T(0);
  __syncthreads();
  for (int i = tid; i < V; i += NT) {
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
  if (tid == 0) g.rounds[w] = round;
}

// The register tiers: a block of NW warps a world, a thread a valid row
// (V ≤ 32·NW; threads past V idle), the row's entries of the active block
// in registers. NW = 1 is the staged tier (a warp a world, the pivot row
// passed by shuffles), NW = 2 the medium tier (the argmax's candidates and
// the pivot row passed through shared memory, two barriers a step).
template <int NW, typename T>
struct RegShared {
  static constexpr int kRows = 32 * NW, kLd = kRows + 1;
  T As[kRows * kLd];          // A's valid block
  T xs[kRows];                // a vector the rows share
  T prow[kRows + 1];          // the pivot row and its right-hand side
  T xk[kRows];                // each back-substitution step's x
  T red[2 * NW];              // each warp's maxima
  unsigned long long key[NW]; // each warp's largest key and its candidate
  unsigned pk[NW];
  unsigned ballot[NW];
  int moved[NW];
  int rows[kRows];            // the valid rows, in buffer order
  int ai[kRows];              // the active rows, in order
  int plane[kRows];           // each step's pivot thread
  int count, world;
};

template <int NW>
__device__ __forceinline__ void block_sync() {
  if constexpr (NW == 1) __syncwarp(); else __syncthreads();
}

// bit i: `on` of row (thread) i, for every thread
template <int NW, typename T>
__device__ __forceinline__ unsigned long long rows_ballot(
    bool on, RegShared<NW, T>& sh) {
  const unsigned b = __ballot_sync(kAll, on);
  if constexpr (NW == 1) {
    return b;
  } else {
    if ((threadIdx.x & 31) == 0) sh.ballot[threadIdx.x >> 5] = b;
    __syncthreads();
    unsigned long long m = 0;
#pragma unroll
    for (int q = 0; q < NW; ++q)
      m |= static_cast<unsigned long long>(sh.ballot[q]) << (32 * q);
    __syncthreads();
    return m;
  }
}

// the block's largest chg and big (NaN kept) and whether any row moved
template <int NW, typename T>
__device__ __forceinline__ void rows_reduce(T& chg, T& big, bool& moved,
                                            RegShared<NW, T>& sh) {
  chg = warp_max(chg);
  big = warp_max(big);
  moved = __any_sync(kAll, moved);
  if constexpr (NW > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      sh.red[warp] = chg;
      sh.red[NW + warp] = big;
      sh.moved[warp] = moved;
    }
    __syncthreads();
    chg = T(0);
    big = T(0);
    moved = false;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      chg = max_nan(chg, sh.red[q]);
      big = max_nan(big, sh.red[NW + q]);
      moved |= sh.moved[q] != 0;
    }
    __syncthreads();
  }
}

// The elimination and back substitution of the active block, its n ≤ NB
// columns compacted into row[0, n) (sh.ai: their rows), in straight-line
// code: NB steps unrolled, those past n predicated off, so that a step's
// tail overlaps the next step's argmax. A step's argmax is redux over the
// candidates' keys (the first largest |pivot|); each element takes the same
// operations as in `eliminate`. Returns this thread's x (its unknown's value
// where active).
template <int NW, int NB, typename T>
__device__ __forceinline__ T reg_eliminate(T (&row)[32 * NW], T rhs, int n,
                                           bool active, int pos,
                                           RegShared<NW, T>& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int pcol = 32 * NW;
  T dinv = T(0);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool live = k < n;
    const bool cand = live && active && pos >= k;
    // two warps: each candidate's reciprocal, off the argmax's chain (the
    // pivot's is then passed on, the same bits as taking it after the
    // exchange); one warp takes it after the pivot's shuffle, as early
    // there made that tier slower
    T own_inv = T(0);
    if constexpr (NW > 1) own_inv = recip(row[k]);
    const unsigned long long key = cand ? abs_key(fabs(row[k])) : 0ull;
    const unsigned khi = static_cast<unsigned>(key >> 32);
    const unsigned klo = static_cast<unsigned>(key);
    const unsigned top = __reduce_max_sync(kAll, khi);
    const unsigned low = __reduce_max_sync(kAll, khi == top ? klo : 0u);
    const bool first = cand && khi == top && klo == low;
    unsigned pk = __reduce_min_sync(
        kAll, first ? static_cast<unsigned>(pos * 64 + t) : ~0u);
    T inv;
    if constexpr (NW == 1) {
      inv = recip(__shfl_sync(kAll, row[k], pk & 63));
    } else {
      if (lane == 0) {
        sh.key[warp] = (static_cast<unsigned long long>(top) << 32) | low;
        sh.pk[warp] = pk;
      }
      __syncthreads();
      unsigned long long best = sh.key[0];
      pk = sh.pk[0];
#pragma unroll
      for (int q = 1; q < NW; ++q) {
        const unsigned long long kq = sh.key[q];
        const unsigned pq = sh.pk[q];
        if (kq > best || (kq == best && pq < pk)) {
          best = kq;
          pk = pq;
        }
      }
      if (t == static_cast<int>(pk & 63)) {
#pragma unroll
        for (int c = k + 1; c < NB; ++c) sh.prow[c] = row[c];
        sh.prow[NB] = rhs;
        sh.prow[k] = own_inv;
      }
      __syncthreads();
      inv = sh.prow[k];
    }
    const int ppos = static_cast<int>(pk >> 6), p = pk & 63;
    if (t == 0) sh.plane[k] = p;
    pos = live && active && pos == k ? ppos : pos;
    pos = live && t == p ? k : pos;
    pcol = live && t == p ? k : pcol;
    dinv = live && t == p ? inv : dinv;
    const bool upd = live && active && pos > k;
    const T f = row[k] * inv;
    if constexpr (NW == 1) {
      T u[32 * NW];
#pragma unroll
      for (int c = k + 1; c < NB; ++c) u[c] = __shfl_sync(kAll, row[c], p);
      const T ur = __shfl_sync(kAll, rhs, p);
#pragma unroll
      for (int c = k + 1; c < NB; ++c)
        row[c] = upd ? fmadd(-f, u[c], row[c]) : row[c];
      rhs = upd ? fmadd(-f, ur, rhs) : rhs;
    } else {
#pragma unroll
      for (int c = k + 1; c < NB; ++c)
        row[c] = upd ? fmadd(-f, sh.prow[c], row[c]) : row[c];
      rhs = upd ? fmadd(-f, sh.prow[NB], rhs) : rhs;
    }
  }
  block_sync<NW>();
  T x = T(0);
#pragma unroll
  for (int k = NB - 1; k >= 0; --k) {
    const bool live = k < n;
    const int p = sh.plane[k];
    T xk;
    if constexpr (NW == 1) {
      xk = __shfl_sync(kAll, rhs * dinv, p & 31);
    } else {
      if (live && t == p) sh.xk[k] = rhs * dinv;
      __syncthreads();
      xk = sh.xk[k];
    }
    rhs = live && active && pcol < k ? fmadd(-row[k], xk, rhs) : rhs;
    x = live && t == sh.ai[k] ? xk : x;
  }
  return x;
}

// The masked solve of one world's V rows: the bounds, the clamp values, the
// active block's rows gathered into registers, its elimination. Returns
// this thread's λ of the round (its clamp value where inactive) and sets
// hi, its bound.
template <int NW, typename T>
__device__ __forceinline__ T reg_masked_solve(
    RegShared<NW, T>& sh, int V, bool mine, unsigned char kind, bool act,
    signed char side, T lam, int nrm, T mu3, T bv, T& hi) {
  constexpr int kRows = 32 * NW, ld = kRows + 1;
  const int t = threadIdx.x;
  T ln;
  if constexpr (NW == 1) {
    ln = __shfl_sync(kAll, lam, nrm >= 0 ? nrm : t);
  } else {
    sh.xs[t] = lam;
    __syncthreads();
    ln = sh.xs[nrm >= 0 ? nrm : t];
    __syncthreads();
  }
  hi = isinf(mu3) ? T(INFINITY)
                  : mu3 * (nrm >= 0 && ln > T(0) ? ln : T(0));
  T cv = T(0);
  if (!act && (kind & kBoxed)) cv = side < 0 ? -hi : (side > 0 ? hi : T(0));
  sh.xs[t] = mine ? cv : T(0);
  const bool active = mine && act;
  const unsigned long long am = rows_ballot<NW>(active, sh);
  const int n = __popcll(am);
  const int pos = active ? __popcll(am & ((1ull << t) - 1ull)) : 2 * kRows;
  if (active) sh.ai[pos] = t;
  block_sync<NW>();
  T row[kRows];
  T contrib = T(0);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < V) contrib += (mine ? sh.As[t * ld + j] : T(0)) * sh.xs[j];
    row[j] = mine && j < n ? sh.As[t * ld + sh.ai[j]] : T(0);
  }
  const T rhs = -bv - contrib;
  // the shortest step loop that holds n: on an H100 each is 31-36% faster
  // than the next longer one on the worlds that take it
  // (utils/kernel_ab.py --pivot)
  T x;
  if constexpr (NW == 1)
    x = n <= 16 ? reg_eliminate<1, 16>(row, rhs, n, active, pos, sh)
                : reg_eliminate<1, 32>(row, rhs, n, active, pos, sh);
  else
    x = n <= 32   ? reg_eliminate<NW, 32>(row, rhs, n, active, pos, sh)
        : n <= 48 ? reg_eliminate<NW, 48>(row, rhs, n, active, pos, sh)
                  : reg_eliminate<NW, kRows>(row, rhs, n, active, pos, sh);
  return mine ? (active ? x : cv) : T(0);
}

// The pivot loop of world w on its V ≤ 32·NW valid rows (sh.rows), then the
// final solve, the projection and the outputs. Every thread of the block.
template <int NW, typename T>
__device__ void reg_world(const Args& g, RegShared<NW, T>& sh, int w,
                          int V) {
  constexpr int kRows = 32 * NW, ld = kRows + 1;
  const int t = threadIdx.x, R = g.R, C = R / 3;
  const T* a = static_cast<const T*>(g.a) + static_cast<size_t>(w) * R * R;
  const bool mine = t < V;
  const int r = mine ? sh.rows[t] : 0, c = r % C;
  // A's valid block, this thread's column: its loads in flight at once
#pragma unroll
  for (int i0 = 0; i0 < kRows; i0 += 32) {
    T column[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      column[i] = mine && i0 + i < V
                      ? a[static_cast<size_t>(sh.rows[i0 + i]) * R + r]
                      : T(0);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i0 + i < V) sh.As[(i0 + i) * ld + t] = column[i];
  }
  const T* b = static_cast<const T*>(g.b) + static_cast<size_t>(w) * R;
  const bool* normal = g.is_normal + static_cast<size_t>(w) * R;
  const T* mu = g.mu ? static_cast<const T*>(g.mu) + static_cast<size_t>(w) * C
                     : nullptr;
  const T tol = T(kTol);
  // this row's contact's normal row among the valid ones, b, μ, its kind
  int lo = 0, hi_ = V;
  while (lo < hi_) {
    const int mid = (lo + hi_) >> 1;
    if (sh.rows[mid] < c) lo = mid + 1; else hi_ = mid;
  }
  const int nrm = mine && lo < V && sh.rows[lo] == c ? lo : -1;
  const T bv = mine ? b[r] : T(0);
  const T mu3 = mine && mu ? mu[c] : T(INFINITY);
  unsigned char kind = 0;
  if (mine) {
    if (normal[r]) kind = kToggled;
    else if (g.friction) kind = isinf(mu3) ? kBilateral : kBoxed;
  }
  bool act = (kind & kBilateral) || ((kind & kToggled) && bv < T(0));
  signed char side = 0;
  T lam = T(0), hi = T(0), lnew;
  block_sync<NW>();
  // the safeguard holds only where the bounds are fixed: no boxed row
  const bool fixed = rows_ballot<NW>((kind & kBoxed) != 0, sh) == 0;
  const T fp_tol = sizeof(T) == 8 ? T(1e3 * kTol) : T(30) * T(FLT_EPSILON);
  int round = 0;
  bool last = false;
  // the safeguard: the least count of moving rows, the rounds since it fell
  int best = V + 1, stall = 0;
  for (;;) {
    lnew = reg_masked_solve<NW>(sh, V, mine, kind, act, side, lam, nrm, mu3,
                                bv, hi);
    if (last) break;
    block_sync<NW>();
    sh.xs[t] = lnew;
    block_sync<NW>();
    T wi = T(0);
    if (mine)
      for (int j = 0; j < V; ++j) wi += sh.As[t * ld + j] * sh.xs[j];
    wi = wi + bv;
    const bool tog = kind & kToggled, box = kind & kBoxed;
    const bool bil = kind & kBilateral;
    const T ln = lnew;
    const bool tiny = box && hi < tol;         // bound collapsed (λ_n = 0)
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
    if (tiny) nside = 1;                        // sit at hi = 0
    if (!box) nside = 0;
    bool moved = mine && (nact != act || nside != side);
    // block flips while the count of moving rows falls below its least,
    // else the first moving row alone (Murty's least-index rule)
    const unsigned long long movers = rows_ballot<NW>(moved, sh);
    const int count = __popcll(movers);
    stall = count < best ? 0 : stall + 1;
    best = min(best, count);
    const bool flip =
        moved && (!fixed || stall < kStallRounds
                  || t == __ffsll(static_cast<long long>(movers)) - 1);
    T chg = mine ? fabs(ln - lam) : T(0);
    T big = mine ? fabs(ln) : T(0);
    rows_reduce<NW>(chg, big, moved, sh);
    if (flip) {
      act = nact;
      side = nside;
    }
    lam = lnew;
    ++round;
    // the bounds move with λ_n even at a stable set: the iterate itself
    // must be a fixed point
    last = (!moved && chg <= fp_tol * (T(1) + big)) || round >= kMaxRounds;
    block_sync<NW>();
  }
  // the projection on the last set and bounds, and the outputs
  T* out = static_cast<T*>(g.lam) + static_cast<size_t>(w) * R;
  for (int i = t; i < R; i += kRows) out[i] = T(0);
  block_sync<NW>();
  if (mine) {
    T l = lnew;
    if (kind & kToggled) l = l < T(0) ? T(0) : l;
    if (kind & kBoxed) {
      l = l < -hi ? -hi : l;
      l = l > hi ? hi : l;
    }
    out[r] = l;
  }
  if (t == 0) g.rounds[w] = round;
}

// The staged tier: block w the world w, a warp. A world of more valid rows
// than cap_s goes to the medium or the large worklist.
template <typename T>
__global__ void __launch_bounds__(32) lcp_pivot_warp(Args g) {
  __shared__ RegShared<1, T> sh;
  const int w = blockIdx.x, R = g.R;
  const bool* valid = g.valid + static_cast<size_t>(w) * R;
  const int V = block_compact([&](int i) { return valid[i]; }, R, 32,
                              sh.rows, &sh.count);
  if (V > g.cap_s) {
    if (threadIdx.x == 0) {
      const bool large = V > g.cap_m;
      const int at = atomicAdd(&g.counters[large ? kLargeLen : kMediumLen],
                               1);
      g.lists[(large ? g.B : 0) + at] = w;
    }
    return;
  }
  reg_world<1, T>(g, sh, w, V);
}

// The medium tier: persistent blocks of two warps that take worlds from
// the medium worklist until it is empty.
template <typename T>
__global__ void __launch_bounds__(64) lcp_pivot_pair(Args g) {
  __shared__ RegShared<2, T> sh;
  const int R = g.R;
  for (;;) {
    if (threadIdx.x == 0) {
      const int t = atomicAdd(&g.counters[kMediumTaken], 1);
      sh.world = t < g.counters[kMediumLen] ? g.lists[t] : -1;
    }
    __syncthreads();
    const int w = sh.world;
    if (w < 0) return;
    const bool* valid = g.valid + static_cast<size_t>(w) * R;
    const int V = block_compact([&](int i) { return valid[i]; }, R, 64,
                                sh.rows, &sh.count);
    reg_world<2, T>(g, sh, w, V);
    __syncthreads();
  }
}

// The large tier: persistent blocks that take worlds from the large
// worklist until it is empty, each with its own slot; A read where it lies.
// Far: the panel and the vectors in the slot, after the trailing matrix.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads, 1)
    lcp_pivot_large(Args g, long long region, int nm, int far) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = g.R;
  unsigned char* own =
      g.slots ? static_cast<unsigned char*>(g.slots)
                    + static_cast<size_t>(blockIdx.x) * slot_bytes<T>(R, far)
              : nullptr;
  T* mat = reinterpret_cast<T*>(smem);
  const size_t trail = slot_bytes<T>(R, false);
  const Work<T> s =
      far ? carve<T>(mat, reinterpret_cast<T*>(own + trail),
                     own + trail + align16(panel_elems(R) * sizeof(T)), R)
          : carve<T>(mat, mat,
                     smem + align16(static_cast<size_t>(region) * sizeof(T)),
                     R);
  T* slot = reinterpret_cast<T*>(own);
  for (;;) {
    if (threadIdx.x == 0) {
      const int t = atomicAdd(&g.counters[kLargeTaken], 1);
      s.slots[kSlotWorld] = t < g.counters[kLargeLen] ? g.lists[g.B + t] : -1;
    }
    __syncthreads();
    const int w = s.slots[kSlotWorld];
    if (w < 0) return;
    const bool* valid = g.valid + static_cast<size_t>(w) * R;
    const T* a = static_cast<const T*>(g.a) + static_cast<size_t>(w) * R * R;
    const int V = block_compact([&](int i) { return valid[i]; }, R, R,
                                s.rows, &s.slots[kSlotValid]);
    solve_world<kLargeThreads, kLargeCols, T>(
        g, s, AView<T>{a, s.rows, R}, w, V, slot, nm);
    __syncthreads();
  }
}

// The opt-in to more dynamic shared memory than 48 KB (where `dynamic`),
// and the carveout that lets a tier's blocks share an SM, once per kernel
// and device. The first launch on a device sets them; graphed callers
// launch eagerly once (utils/graphs.warm_up) before any capture.
template <typename K>
cudaError_t opt_in(K kernel, bool dynamic, bool* done_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done_for[dev]) return cudaSuccess;
  if (dynamic)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done_for[dev] = true;
  return err;
}

template <typename T>
int launch(const void* a, const void* b, const void* valid,
           const void* is_normal, const void* mu, void* lam, void* rounds,
           void* counters, void* lists, void* slots, int B, int R, int cap_s,
           int cap_m, int blocks_m, int blocks_l, long long region_l,
           int nm_l, int far_l, int friction, void* stream) {
  static bool done_s[64], done_m[64], done_l[64];
  if (B <= 0 || R <= 0 || R % 3 != 0 || cap_s < 1 || cap_s > R
      || cap_s > kStagedRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool medium = R > cap_s, large = R > cap_m, far = far_l != 0;
  const size_t bytes_l =
      large && region_l > 0 ? shared_bytes<T>(R, region_l, far) : 0;
  if ((medium && (cap_m <= cap_s || cap_m > R || cap_m > kMediumRows
                  || blocks_m < 1 || !counters || !lists))
      || (large && (blocks_l < 1 || bytes_l < 1 || bytes_l > kMaxShared
                    || nm_l < 1 || nm_l > R || nm_l >= 32 * kLargeCols
                    || static_cast<long long>(nm_l) * odd(nm_l + 1) > region_l))
      || (large && nm_l < R
          && (!slots || nm_l < kPanel
              || (!far && panel_elems(R) > static_cast<size_t>(region_l))))
      || (large && far && nm_l >= R))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(lcp_pivot_warp<T>, false, done_s);
  if (err == cudaSuccess && medium)
    err = opt_in(lcp_pivot_pair<T>, false, done_m);
  if (err == cudaSuccess && large)
    err = opt_in(lcp_pivot_large<T>, true, done_l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args g{a, b, static_cast<const bool*>(valid),
         static_cast<const bool*>(is_normal), mu, lam,
         static_cast<int*>(rounds), static_cast<int*>(counters),
         static_cast<int*>(lists), slots, B, R, friction != 0, cap_s,
         medium ? cap_m : R};
  if (medium) {
    err = cudaMemsetAsync(counters, 0, kCounters * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lcp_pivot_warp<T><<<B, 32, 0, st>>>(g);
  if (medium) lcp_pivot_pair<T><<<blocks_m, 64, 0, st>>>(g);
  if (large)
    lcp_pivot_large<T><<<blocks_l, kLargeThreads, bytes_l, st>>>(
        g, region_l, nm_l, far_l);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int resources_of(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  out[3] = attr.maxDynamicSharedSizeBytes;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

template <typename T>
int resources(int which, int* out) {
  switch (which) {
    case 0: return resources_of(lcp_pivot_warp<T>, out);
    case 1: return resources_of(lcp_pivot_pair<T>, out);
    case 2: return resources_of(lcp_pivot_large<T>, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One library a dtype, LCP_PIVOT_F64 = 0 (float32) or 1 (float64), so that
// the two halves compile in parallel (ops/lcp_kernel.build): each is over
// a minute of nvcc, most of it the register tiers' unrolled step loops.
#if !defined(LCP_PIVOT_F64)
#error "build with -DLCP_PIVOT_F64=0 (float32) or -DLCP_PIVOT_F64=1 (float64)"
#elif LCP_PIVOT_F64
using Real = double;
#else
using Real = float;
#endif

extern "C" {

int lcp_pivot_launch(const void* a, const void* b, const void* valid,
                     const void* is_normal, const void* mu, void* lam,
                     void* rounds, void* counters, void* lists, void* slots,
                     int B, int R, int cap_s, int cap_m, int blocks_m,
                     int blocks_l, long long region_l, int nm_l, int far_l,
                     int friction, void* stream) {
  return launch<Real>(a, b, valid, is_normal, mu, lam, rounds, counters,
                      lists, slots, B, R, cap_s, cap_m, blocks_m, blocks_l,
                      region_l, nm_l, far_l, friction, stream);
}

// registers a thread, local (spilled) bytes a thread, the most threads a
// block, the dynamic shared memory it may take, its static shared memory:
// of the staged (which 0), medium (1) or large (2) tier's kernel
int lcp_pivot_resources(int which, int* out) {
  return resources<Real>(which, out);
}

}  // extern "C"
