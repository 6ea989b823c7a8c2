"""DANTZIG's pivot loop as one kernel (``ops/lcp_kernel.py``,
``csrc/lcp_pivot.cu``): what it rests on, held on the CPU.

* The active-block reduction: the JAX package's dense masked solve
  (``rl_ode_physics_tpu/ops/lcp.py:150-156``: the inactive rows and columns
  of the matrix replaced by the identity's, the clamped rows' values in the
  right-hand side) against a float64 solve of the gathered active block,
  within 1e-12 of max |λ| (both are solves of the same system in float64;
  measured 2e-16 to 7e-16 on the random systems, 1e-13 on the
  ill-conditioned ones of the settled stack), on random SPD systems with
  random valid, active and clamped rows, and on ``_build_lcp``'s systems of
  ``tests/test_lcp.py``'s states.
* The kernel's algorithm, transcribed per world in numpy (``_kernel_model``:
  the tier chosen from the valid count, the valid rows gathered, each
  round's active block eliminated with partial pivoting and a reciprocal a
  pivot, blocked past the large tier's shared rows, back substitution in
  blocks of 32, the pivots with the single-pivot safeguard and the
  fixed-point test on local rows), against
  the plain ``_pivot_solve`` in float64: λ within 1e-10 of max |λ| and each
  world's rounds equal, at μ = ∞, a finite μ and per-contact μ, at every
  tier boundary (the large tier's shared rows − 1 eliminated whole, + 1
  blocked) and on the capsule pile's own system; the blocked elimination
  bitwise the unblocked one; the last solve's active rows read from λ.
* The plain ``_pivot_solve`` returns each world's rounds, those the world
  takes alone.
* ``lcp_pivot_solve`` on CPU tensors is the plain version, bit for bit, and
  counts no launch; it raises on what the kernel does not take; its launch
  is sized from the shapes alone, at any R; the tiers follow the valid
  count; the bound's chain floor.

Inputs are made from numpy seeds. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 19b).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.ops import lcp as jax_lcp
from rl_ode_physics_tpu_torch.ops import lcp, lcp_kernel
from rl_ode_physics_tpu_torch.testing import dantzig_reference
from rl_ode_physics_tpu_torch.testing.lcp_systems import (
    block_cycle_lcp, random_contact_lcp, tier_boundary_lcp)

from _torch_port import single_cpu_thread  # noqa: F401  (autouse)

REDUCTION_RTOL = 1e-12
MODEL_RTOL = 1e-10
CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=64)


@functools.lru_cache(maxsize=None)
def _test_lcp_systems():
    """``_build_lcp``'s systems of ``tests/test_lcp.py``'s states: the
    settled bench world (300 substeps) and the same at 120 substeps, as
    float64 numpy arrays (A, b, valid)."""
    from test_lcp import _contact_state
    out = []
    for settle in (300, 120):
        state, contacts = _contact_state(settle=settle)
        _, a_mat, b, valid, _, _ = jax_lcp._build_lcp(
            state, contacts, JaxConfig(**CAPS))
        out.append((np.asarray(a_mat, np.float64),
                    np.asarray(b, np.float64), np.asarray(valid)))
    return out


def _jax_masked_solve(a_mat, b, act, lam_clamp):
    """``rl_ode_physics_tpu/ops/lcp.py:150-156`` in float64."""
    with jax.enable_x64(True):
        a_mat, b = jnp.asarray(a_mat), jnp.asarray(b)
        act, lam_clamp = jnp.asarray(act), jnp.asarray(lam_clamp)
        eye = jnp.eye(b.shape[0], dtype=a_mat.dtype)
        m = jnp.where(act[:, None] & act[None, :], a_mat, eye)
        contrib = a_mat @ jnp.where(act, 0.0, lam_clamp)
        rhs = jnp.where(act, -b - contrib, lam_clamp)
        out = np.asarray(jnp.linalg.solve(m, rhs))
    assert out.dtype == np.float64
    return out


def _block_solve(a_mat, b, act, lam_clamp):
    """The kernel's reduction in torch float64: the active block solved
    alone, the inactive rows at their clamp values."""
    a, b = torch.from_numpy(a_mat), torch.from_numpy(b)
    act = torch.from_numpy(act)
    lam = torch.from_numpy(lam_clamp).clone()
    idx = act.nonzero()[:, 0]
    rhs = -b[idx] - a[idx][:, ~act] @ lam[~act]
    lam[idx] = torch.linalg.solve(a[idx][:, idx], rhs)
    return lam.numpy()


def _masks(rng, valid):
    """Random active rows among the valid ones, and clamp values on the
    others: ±h on a random half of the valid inactive rows, 0 elsewhere."""
    act = valid & (rng.random(valid.shape) < 0.6)
    clamped = valid & ~act & (rng.random(valid.shape) < 0.5)
    lam_clamp = np.where(clamped, rng.uniform(-2.0, 2.0, valid.shape), 0.0)
    return act, lam_clamp


def _reduction_holds(a_mat, b, act, lam_clamp):
    want = _jax_masked_solve(a_mat, b, act, lam_clamp)
    got = _block_solve(a_mat, b, act, lam_clamp)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= REDUCTION_RTOL * scale, (err, scale)
    assert np.array_equal(got[~act], lam_clamp[~act])
    return err / scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_active_block_reduction_on_random_systems(seed):
    a_mat, b, valid, _, _ = random_contact_lcp(seed, worlds=3)
    rng = np.random.default_rng(100 + seed)
    worst = 0.0
    for w in range(a_mat.shape[0]):
        act, lam_clamp = _masks(rng, valid[w])
        assert act.any() and (~act & valid[w]).any()
        worst = max(worst, _reduction_holds(a_mat[w], b[w], act, lam_clamp))
    print(f"[lcp-kernel] reduction, random systems: {worst:.3e} of max|λ|")


def test_active_block_reduction_on_build_lcp_systems():
    rng = np.random.default_rng(7)
    worst = 0.0
    for a_mat, b, valid in _test_lcp_systems():
        assert valid.sum() >= 12
        for _ in range(3):
            act, lam_clamp = _masks(rng, valid)
            worst = max(worst, _reduction_holds(a_mat, b, act, lam_clamp))
    print(f"[lcp-kernel] reduction, _build_lcp systems: {worst:.3e} of "
          f"max|λ|")


def _eliminate(m):
    """Gaussian elimination with partial pivoting (the first largest
    |pivot|) of the augmented n × (n + 1) matrix ``m``, in place: a
    reciprocal of the pivot a step, the multipliers f = m[i, k]·(1/pivot),
    the rows exchanged whole (the kernel keeps a permutation instead). The
    kernel's ``eliminate``. Returns the pivots' reciprocals."""
    n = m.shape[0]
    dinv = np.empty(n)
    for k in range(n):
        at = k + int(np.argmax(np.abs(m[k:, k])))
        if at != k:
            m[[k, at]] = m[[at, k]]
        dinv[k] = inv = 1.0 / m[k, k]
        f = m[k + 1:, k] * inv
        m[k + 1:, k + 1:] -= np.outer(f, m[k, k + 1:])
    return dinv


def _eliminate_blocked(m, nm, panel=lcp_kernel.PANEL):
    """The large tier's blocked right-looking elimination of ``m`` in
    place while more than ``nm`` rows are left (``csrc/lcp_pivot.cu:
    panel_step``): a panel of ``panel`` columns factored with its
    multipliers kept, U12 by forward substitution, the trailing matrix
    updated in the panel's column order; then the rest unblocked. Each
    element takes the same operations in the same order as in
    ``_eliminate``. Returns (the pivots' reciprocals, the panels)."""
    n = m.shape[0]
    dinv = np.empty(n)
    p0 = 0
    while n - p0 > nm:
        e = p0 + panel
        for k in range(p0, e):
            at = k + int(np.argmax(np.abs(m[k:, k])))
            if at != k:
                m[[k, at]] = m[[at, k]]
            dinv[k] = inv = 1.0 / m[k, k]
            m[k + 1:, k] *= inv
            m[k + 1:, k + 1:e] -= np.outer(m[k + 1:, k], m[k, k + 1:e])
        for j in range(p0, e):
            for i in range(j + 1, e):
                m[i, e:] -= m[i, j] * m[j, e:]
        for j in range(p0, e):
            m[e:, e:] -= np.outer(m[e:, j], m[j, e:])
        p0 = e
    dinv[p0:] = _eliminate(m[p0:, p0:])
    return dinv, p0 // panel


def _back_substitute(u, dinv):
    """x of U x = y, U the eliminated rows, y their last column: in blocks
    of 32 rows from the last, the solved part's product, then the block's
    triangular solve, x_k = y_k·(1/pivot) (the kernel's
    ``back_substitute``)."""
    n = len(dinv)
    y = u[:, n].copy()
    for lo in range((n - 1) // 32 * 32, -1, -32):
        hi = min(lo + 32, n)
        if hi < n:
            y[lo:hi] -= u[lo:hi, hi:n] @ y[hi:n]
        for k in range(hi - 1, lo - 1, -1):
            y[k] *= dinv[k]
            y[lo:k] -= u[lo:k, k] * y[k]
    return y


def _gauss(m, x, nm=None):
    """The solution of m z = x as the kernel finds it: the augmented matrix
    eliminated (blocked while more than ``nm`` rows are left), then back
    substitution. Returns (z, the panels of the blocked elimination)."""
    aug = np.concatenate([m, x[:, None]], 1)
    if nm is not None and len(x) > nm:
        dinv, panels = _eliminate_blocked(aug, nm)
    else:
        dinv, panels = _eliminate(aug), 0
    return _back_substitute(aug, dinv), panels


def _kernel_model(a_mat, b, valid, is_normal, friction, mu_row=None,
                  dtype=torch.float64):
    """``csrc/lcp_pivot.cu``'s algorithm per world in numpy float64: the
    tier chosen from the valid count (the large tier eliminates an active
    block of more than its shared rows blocked, ``launch_shape(dtype)``),
    the valid rows gathered (local indices), each row's normal row found
    among them, the rounds on the active block alone. Returns (λ (B, R),
    rounds (B,), each world's tier, each world's solves that took the
    blocked elimination, each world's active rows in its last solve)."""
    bsz, r = b.shape
    c = r // 3
    tol = lcp._TOL
    fp_tol = 1e3 * tol
    lam_out = np.zeros((bsz, r))
    rounds_out = np.zeros(bsz, np.int32)
    tiers, blocked, last_active = [], np.zeros(bsz, int), np.zeros(bsz, int)
    for w in range(bsz):
        rows = np.nonzero(valid[w])[0]
        v = len(rows)
        tiers.append(lcp_kernel.tier_of(r, v))
        nm = (lcp_kernel.launch_shape(dtype, bsz, r).shared_rows
              if tiers[-1] == "large" else None)
        a = a_mat[w][np.ix_(rows, rows)]
        bv = b[w][rows]
        local = {g: i for i, g in enumerate(rows)}
        nrm = np.array([local.get(g % c, -1) for g in rows], int)
        mu3 = (np.full(v, np.inf) if mu_row is None
               else mu_row[w][rows % c])
        tog = is_normal[w][rows]
        fric = ~tog & friction
        bil = fric & np.isinf(mu3)
        box = fric & ~np.isinf(mu3)
        act = bil | (tog & (bv < 0))
        side = np.zeros(v, int)
        lam = np.zeros(v)

        def bounds(lam):
            ln = np.where(nrm >= 0, lam[np.maximum(nrm, 0)], 0.0)
            with np.errstate(invalid="ignore"):
                return np.where(np.isinf(mu3), np.inf,
                                mu3 * np.maximum(ln, 0.0))

        def solve(act, hi):
            cv = np.where(box, np.where(side < 0, -hi,
                                        np.where(side > 0, hi, 0.0)), 0.0)
            out = cv.copy()
            ai = np.nonzero(act)[0]
            rhs = -bv[ai] - a[np.ix_(ai, ~act)] @ cv[~act]
            out[ai], panels = _gauss(a[np.ix_(ai, ai)], rhs, nm)
            blocked[w] += panels > 0
            return out

        done, rnd = False, 0
        best, stall = v + 1, 0
        while not done and rnd < lcp.MAX_PIVOT_ROUNDS:
            hi = bounds(lam)
            tiny = box & (hi < tol)
            new = solve(act, hi)
            wv = a @ new + bv
            rm_n = act & tog & (new < -tol)
            add_n = ~act & tog & (wv < -tol)
            go_lo = act & box & (new < -hi - tol)
            go_hi = act & box & (new > hi + tol)
            rel_lo = ~act & box & (side < 0) & (wv < -tol) & ~tiny
            rel_hi = ~act & box & (side > 0) & (wv > tol) & ~tiny
            rel_mid = ~act & box & (side == 0) & ~tiny
            nact = ((act & ~rm_n & ~go_lo & ~go_hi & ~tiny) | add_n | rel_lo
                    | rel_hi | rel_mid | bil)
            nside = np.where(go_lo, -1, np.where(go_hi, 1, side))
            nside = np.where(rel_lo | rel_hi | rel_mid, 0, nside)
            nside = np.where(tiny, 1, nside)
            nside = np.where(box, nside, 0)
            moving = (nact != act) | (nside != side)
            count = int(moving.sum())
            moved = count > 0
            # the safeguard (no boxed row): block flips while the count
            # falls below its least, else the first moving row alone
            stall = 0 if count < best else stall + 1
            best = min(best, count)
            if not box.any() and stall >= lcp.STALL_ROUNDS and moved:
                first = int(np.argmax(moving))
                keep = np.arange(v) != first
                nact = np.where(keep, act, nact)
                nside = np.where(keep, side, nside)
            chg = np.abs(new - lam).max(initial=0.0)
            scale = 1.0 + np.abs(new).max(initial=0.0)
            done = not moved and chg <= fp_tol * scale
            act, side, lam = nact, nside, new
            rnd += 1
        hi = bounds(lam)
        out = solve(act, hi)
        last_active[w] = act.sum()
        out = np.where(tog, np.maximum(out, 0.0), out)
        out = np.where(box, np.clip(out, -hi, hi), out)
        lam_out[w, rows] = out
        rounds_out[w] = rnd
    return lam_out, rounds_out, tiers, blocked, last_active


def _torch(*arrays):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in arrays]


@pytest.mark.parametrize("mu", [None, 0.4, "mixed"],
                         ids=["mu_inf", "mu_finite", "mu_per_contact"])
@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_model_matches_the_plain_pivot_solve(seed, mu):
    """The kernel's algorithm against the plain batched loop in float64:
    the same λ to roundoff and the same rounds a world, on random contact
    LCPs and on one world of every row valid (V = R = 36: past the stage,
    the kernel's medium tier). A random world under a finite μ
    may cycle to the cap of 128 rounds; both then run it to the cap."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        seed, worlds=5, bodies=24, mu=mu)
    valid[-1] = True
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), True, *_torch(mu_row))
    got_lam, got_rounds, _, _, _ = _kernel_model(a_mat, b, valid,
                                                 is_normal, True, mu_row)
    assert want_rounds.dtype == torch.int32 and want_rounds.shape == (5,)
    assert got_rounds.tolist() == want_rounds.tolist()
    assert int(want_rounds.min()) < lcp.MAX_PIVOT_ROUNDS
    scale = float(want_lam.abs().max())
    err = float(np.abs(got_lam - want_lam.numpy()).max())
    assert err <= MODEL_RTOL * scale, (err, scale)
    print(f"[lcp-kernel] model against plain ({mu}): rounds "
          f"{want_rounds.tolist()}, err {err / scale:.3e} of max|λ|")


def test_safeguard_ends_block_cycles(monkeypatch):
    """On ``block_cycle_lcp``'s worlds (one in each tier) flipping every
    violating row at once cycles to the cap; with the safeguard the plain
    loop and the kernel's model end each in the same rounds, at the plain
    Dantzig reference's λ."""
    a_mat, b, valid, is_normal = block_cycle_lcp()
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), True)
    got_lam, got_rounds, tiers, _, _ = _kernel_model(a_mat, b, valid,
                                                     is_normal, True)
    assert tiers == ["staged", "medium", "large"]
    assert got_rounds.tolist() == want_rounds.tolist()
    assert int(want_rounds.max()) < 32
    for w in range(3):
        rows = np.nonzero(valid[w])[0]
        ref = dantzig_reference.solve_lcp(
            *_torch(a_mat[w][np.ix_(rows, rows)], b[w][rows]),
            ~torch.from_numpy(is_normal[w][rows])).numpy()
        scale = np.abs(ref).max()
        assert np.abs(want_lam[w].numpy()[rows] - ref).max() <= 1e-12 * scale
        assert np.abs(got_lam[w][rows] - ref).max() <= MODEL_RTOL * scale
    monkeypatch.setattr(lcp, "STALL_ROUNDS", 10 ** 6)
    _, rounds = lcp._pivot_solve(*_torch(a_mat, b, valid, is_normal), True)
    assert rounds.tolist() == [lcp.MAX_PIVOT_ROUNDS] * 3


@pytest.mark.parametrize("mu", [0.4, "mixed"], ids=["mu_finite",
                                                    "mu_per_contact"])
def test_safeguard_spares_worlds_with_boxed_rows(mu, monkeypatch):
    """A world with a boxed friction row (a finite μ) pivots as block
    flips alone do: the same λ and rounds with the safeguard off, capped
    worlds among them (the bounds move with λ_n, and the least-index
    rule, which cured some of them and capped others, has no finiteness
    there). 48 contacts a world, where the rule took single pivots."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        8, worlds=6, contacts=48, bodies=24, mu=mu)
    system = _torch(a_mat, b, valid, is_normal)
    lam, rounds = lcp._pivot_solve(*system, True, *_torch(mu_row))
    monkeypatch.setattr(lcp, "STALL_ROUNDS", 10 ** 6)
    want_lam, want_rounds = lcp._pivot_solve(*system, True, *_torch(mu_row))
    assert rounds.tolist() == want_rounds.tolist()
    assert int(rounds.max()) == lcp.MAX_PIVOT_ROUNDS
    assert torch.equal(lam, want_lam)


def test_kernel_model_without_friction():
    """Without friction the friction rows, valid or not, stay inactive at
    0: the pure normal LCP."""
    a_mat, b, valid, is_normal, _ = random_contact_lcp(5, worlds=3,
                                                       bodies=24)
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), False)
    got_lam, got_rounds, _, _, _ = _kernel_model(a_mat, b, valid,
                                                 is_normal, False)
    assert got_rounds.tolist() == want_rounds.tolist()
    assert bool((want_lam[:, 12:] == 0).all())
    np.testing.assert_allclose(got_lam, want_lam.numpy(), rtol=0,
                               atol=MODEL_RTOL * float(want_lam.abs().max()))


@pytest.mark.parametrize("mu", [None, "mixed"], ids=["mu_inf", "mixed"])
def test_plain_rounds_are_each_worlds_own(mu):
    """``_pivot_solve``'s (B,) rounds: each world's are those it takes
    alone, the batch's loop runs its slowest world's, and a world that is
    done early keeps its λ."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        6, worlds=6, bodies=24, mu=mu)
    args = _torch(a_mat, b, valid, is_normal)
    mu_t = _torch(mu_row)[0]
    lam, rounds = lcp._pivot_solve(*args, True, mu_t)
    alone = []
    for w in range(6):
        one = [x[w:w + 1] for x in args]
        lam_w, r_w = lcp._pivot_solve(
            *one, True, None if mu_t is None else mu_t[w:w + 1])
        alone.append(int(r_w[0]))
        torch.testing.assert_close(lam_w[0], lam[w], rtol=0,
                                   atol=1e-12 * float(lam.abs().max()))
    assert rounds.tolist() == alone
    assert len(set(alone)) > 1, alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [None, "mixed"], ids=["mu_inf", "mixed"])
def test_wrapper_takes_the_plain_version_on_cpu(mu, dtype):
    """A CPU tensor runs the plain loop, bit for bit, and counts no
    launch."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(8, mu=mu)
    a_mat, b = (torch.from_numpy(x).to(dtype) for x in (a_mat, b))
    valid, is_normal, mu_t = _torch(valid, is_normal, mu_row)
    before = lcp_kernel.lcp_pivot_solve.launches
    got = lcp_kernel.lcp_pivot_solve(a_mat, b, valid, is_normal, True, mu_t)
    want = lcp._pivot_solve(a_mat, b, valid, is_normal, True, mu_t)
    assert lcp_kernel.lcp_pivot_solve.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == dtype and got[1].dtype == torch.int32
    assert float(got[0].abs().max()) > 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(9, mu=0.4)
    a_mat, b, valid, is_normal, mu = _torch(a_mat, b, valid, is_normal,
                                            mu_row)
    solve = lcp_kernel.lcp_pivot_solve
    with pytest.raises(TypeError):
        solve(a_mat.half(), b.half(), valid, is_normal, True, mu)
    with pytest.raises(TypeError):
        solve(a_mat, b.float(), valid, is_normal, True, mu)
    with pytest.raises(TypeError):
        solve(a_mat, b, valid.to(torch.uint8), is_normal, True, mu)
    with pytest.raises(ValueError):
        solve(a_mat[:, :, :-1], b, valid, is_normal, True, mu)
    with pytest.raises(ValueError):            # R not 3C
        solve(a_mat[:, :-1, :-1], b[:, :-1], valid[:, :-1],
              is_normal[:, :-1], True, mu)
    with pytest.raises(ValueError):
        solve(a_mat, b[:, :-3], valid, is_normal, True, mu)
    with pytest.raises(ValueError):
        solve(a_mat, b, valid, is_normal, True, mu[:, :-1])
    with pytest.raises(ValueError):            # not contiguous
        solve(a_mat.transpose(1, 2), b, valid, is_normal, True, mu)
    with pytest.raises(ValueError):            # no worlds
        solve(a_mat[:0], b[:0], valid[:0], is_normal[:0], True, mu[:0])
    with pytest.raises(ValueError):            # two devices
        solve(a_mat, b.to("meta"), valid, is_normal, True, mu)
    with pytest.raises(ValueError):            # not a card, not the CPU
        solve(*(x.to("meta") for x in (a_mat, b, valid, is_normal)), True,
              mu.to("meta"))


def test_launch_is_sized_from_the_shapes():
    """The staged tier holds up to ``STAGED_ROWS`` (32) valid rows, the
    medium tier ``MEDIUM_ROWS`` (64) in persistent blocks at least 8 an SM
    (their shared memory is what the card reports, held in
    ``tests/test_torch_cuda.py``); the large tier one block an SM within
    the 227 KB opt-in, an active block of up to ``shared_rows`` rows in
    shared memory and a slot of R × (R + 1) for the blocked elimination
    past it; its panel and vectors beside the region while they fit, else
    (``far``) in the slot, at any R: past 597 rows in float64 and 1,146 in
    float32, and at the default ``max_contacts`` (R = 6,144); no worklist
    where every world fits the stage, no slot where every active block fits
    shared memory."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    default_rows = 3 * EngineConfig().max_contacts
    for dtype in (torch.float32, torch.float64):
        size = dtype.itemsize
        shape = lcp_kernel.launch_shape(dtype, 1024, 288)
        assert shape.staged_rows == lcp_kernel.STAGED_ROWS == 32
        assert shape.medium_rows == lcp_kernel.MEDIUM_ROWS == 64
        assert shape.medium_blocks == min(1024, 8 * lcp_kernel.SMS)
        assert shape.large_blocks == lcp_kernel.SMS
        assert shape.large_bytes == lcp_kernel.MAX_SHARED
        assert shape.large_bytes == lcp_kernel.shared_bytes(
            size, 288, shape.large_region, False)
        nm = shape.shared_rows
        assert nm * ((nm + 1) | 1) <= shape.large_region
        assert (nm + 1) * ((nm + 2) | 1) > shape.large_region
        assert lcp_kernel.panel_elems(288) <= shape.large_region
        assert lcp_kernel.PANEL <= nm < 288 and not shape.far
        assert shape.slot_bytes == 288 * 289 * size
        assert shape.launches == 4
        small = lcp_kernel.launch_shape(dtype, 1024, 30)
        assert small.staged_rows == 30 and small.medium_rows == 0
        assert small.large_blocks == 0 and small.launches == 1
        few = lcp_kernel.launch_shape(dtype, 3, 288)
        assert few.medium_blocks == 3 and few.large_blocks == 3
        assert few._replace(medium_blocks=0, large_blocks=0) \
            == shape._replace(medium_blocks=0, large_blocks=0)
        mid = lcp_kernel.launch_shape(dtype, 1024, 3 * 40)
        assert mid.slot_bytes == 0 and mid.shared_rows == 120
        # far: the panel and the vectors in the slot, all of shared memory
        # for the region; the last R that holds them beside it, and past it
        last = 597 if dtype == torch.float64 else 1146
        near = lcp_kernel.launch_shape(dtype, 8, last)
        assert not near.far and near.shared_rows < last
        assert lcp_kernel.panel_elems(last) <= near.large_region
        for rows in (last + 3, default_rows):
            far = lcp_kernel.launch_shape(dtype, 8, rows)
            assert far.far and far.launches == 4
            assert far.large_region == lcp_kernel.MAX_SHARED // size
            assert far.large_bytes == lcp_kernel.MAX_SHARED
            assert far.shared_rows == (169 if size == 8 else 240)
            assert far.slot_bytes == lcp_kernel.slot_bytes(size, rows, True)
            assert far.slot_bytes >= (
                rows * (rows + 1) + lcp_kernel.panel_elems(rows)) * size \
                + lcp_kernel.vector_bytes(size, rows)
            assert far.slot_bytes % 16 == 0
    assert lcp_kernel.launch_shape(torch.float64, 8, 288).shared_rows == 158
    assert lcp_kernel.launch_shape(torch.float32, 8, 288).shared_rows == 230


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tiers_follow_the_valid_count(dtype):
    """``tier_of`` at ``boundary_counts``: the stage's cap and one more,
    the medium tier's and one more, the large tier's shared rows ± 1, all
    288; ``tier_counts`` reads the kernel's counters (the worklists'
    lengths, the blocked solves), every world staged where a solve needs
    no worklist."""
    shape = lcp_kernel.launch_shape(dtype, 8, 288)
    counts = lcp_kernel.boundary_counts(dtype, 288)
    cap, cap_m, nm = (shape.staged_rows, shape.medium_rows,
                      shape.shared_rows)
    assert counts == [cap, cap + 1, cap_m, cap_m + 1, nm - 1, nm + 1, 288]
    tiers = [lcp_kernel.tier_of(288, v) for v in counts]
    assert tiers == ["staged", "medium", "medium"] + ["large"] * 4
    assert lcp_kernel.tier_of(30, 30) == "staged"
    counters = torch.tensor([2, 2, 4, 4, 9, 0, 0, 0], dtype=torch.int32)
    assert lcp_kernel.tier_counts(7, counters) == dict(
        staged=1, medium=2, large=4, blocked_solves=9)
    assert lcp_kernel.tier_counts(5, None) == dict(
        staged=5, medium=0, large=0, blocked_solves=0)


@pytest.mark.parametrize("n, nm", [(40, 33), (100, 40), (288, 158)])
def test_blocked_elimination_is_the_unblocked_one(n, nm):
    """The large tier's blocked elimination (panels of 32 with their
    multipliers kept, U12 by forward substitution, the trailing update in
    the panel's column order) takes each element through the same
    operations as the unblocked one: the same bits, in numpy as on the card
    (there with the same fused multiply-adds). Back substitution in blocks
    of 32 solves the system to roundoff."""
    rng = np.random.default_rng(n)
    m = rng.normal(size=(n, n)) + n * np.eye(n) * rng.choice([0.0, 1.0])
    x = rng.normal(size=n)
    aug = np.concatenate([m, x[:, None]], 1)
    one, two = aug.copy(), aug.copy()
    d1 = _eliminate(one)
    d2, panels = _eliminate_blocked(two, nm)
    assert panels == -(-(n - nm) // lcp_kernel.PANEL)
    assert np.array_equal(d1, d2)
    assert np.array_equal(np.triu(one[:, :n]), np.triu(two[:, :n]))
    assert np.array_equal(one[:, n], two[:, n])
    z = _back_substitute(two, d2)
    want = np.linalg.solve(m, x)
    assert np.abs(z - want).max() <= 1e-10 * np.abs(want).max()


def _hold_model(system, friction=True, dtype=torch.float64):
    """The model against the plain loop: λ within ``MODEL_RTOL`` of max
    |λ|, the same rounds a world. Returns the model's tiers and each
    world's blocked solves."""
    a_mat, b, valid, is_normal, mu_row = system
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), friction, *_torch(mu_row))
    got_lam, got_rounds, tiers, blocked, _ = _kernel_model(
        a_mat, b, valid, is_normal, friction, mu_row, dtype)
    assert got_rounds.tolist() == want_rounds.tolist()
    scale = float(want_lam.abs().max())
    err = float(np.abs(got_lam - want_lam.numpy()).max())
    assert err <= MODEL_RTOL * scale, (err, scale)
    return tiers, blocked, want_rounds.tolist(), err / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_model_at_the_tier_boundaries(dtype):
    """One world at each tier boundary of the dtype (``boundary_counts``,
    ``testing/lcp_systems.tier_boundary_lcp``), μ = ∞ and every row active
    in the first round: each in the tier of its count, the world of the
    large tier's shared rows − 1 eliminated whole in every solve, those of
    its shared rows + 1 and of 288 rows blocked in at least one, the model
    within 1e-10 of the plain loop with its rounds."""
    counts = lcp_kernel.boundary_counts(dtype, 288)
    nm = lcp_kernel.launch_shape(dtype, 1, 288).shared_rows
    tiers, blocked, rounds, err = _hold_model(tier_boundary_lcp(counts),
                                              dtype=dtype)
    assert tiers == [lcp_kernel.tier_of(288, v) for v in counts]
    assert set(tiers) == set(lcp_kernel.TIERS)
    by_count = dict(zip(counts, blocked.tolist()))
    assert by_count[nm - 1] == 0
    assert by_count[nm + 1] > 0 and by_count[288] > 0
    print(f"[lcp-kernel] tier boundaries {counts} ({dtype}): rounds "
          f"{rounds}, blocked solves {blocked}, err {err:.3e} of max|λ|")


@pytest.mark.parametrize("mu", [0.4, "mixed"], ids=["mu_finite", "mixed"])
def test_kernel_model_past_the_stage_with_friction(mu):
    """Boxed rows past the stage and past the medium tier (the stage's
    cap + 1 and the large tier's shared rows + 1 in float64), at μ = 0.4
    and per contact."""
    shape = lcp_kernel.launch_shape(torch.float64, 2, 288)
    counts = [shape.staged_rows + 1, shape.shared_rows + 1]
    tiers, _, rounds, err = _hold_model(tier_boundary_lcp(counts, mu=mu))
    assert tiers == ["medium", "large"]
    assert min(rounds) < lcp.MAX_PIVOT_ROUNDS
    print(f"[lcp-kernel] past the stage ({mu}): rounds {rounds}, err "
          f"{err:.3e} of max|λ|")


# the referee's DANTZIG configuration (tests/_traj_engine.py:make_cfg)
REFEREE_DANTZIG = dict(max_bodies=16, max_pair_candidates=128,
                       max_contacts=96, dtype="float64",
                       exact_box_clip=True, max_contacts_per_pair=8,
                       matmul_precision="highest")
PILE_SETTLE = 40


@pytest.fixture(scope="module")
def capsule_pile_system():
    """``_build_lcp``'s system of the capsule pile settled ``PILE_SETTLE``
    substeps under the referee's DANTZIG configuration on the port's CPU
    (float64): 14 contacts, 42 valid rows, past the float64 stage."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, narrowphase)
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    config = EngineConfig(**REFEREE_DANTZIG, solver=SolverKind.DANTZIG)
    world = scenes.capsule_pile_world(config, device="cpu")
    world = make_batched_step_fn(config, PILE_SETTLE, device="cpu")(world)
    contacts = narrowphase.narrowphase(
        world, broadphase.broadphase(world, config), config)
    state = integrator.apply_external_forces(world, config)
    _, a_mat, b, valid, is_normal, mu_row = lcp._build_lcp(
        state, contacts, config)
    return tuple(x.numpy() for x in (a_mat, b, valid, is_normal, mu_row))


@pytest.mark.parametrize("mu", [None, 0.4, "mixed"],
                         ids=["mu_inf", "mu_finite", "mu_per_contact"])
def test_kernel_model_on_the_capsule_pile(capsule_pile_system, mu):
    """The capsule pile's own system (``_build_lcp``), its μ (∞ in the
    configuration), 0.4, or a μ a contact in [0.2, 1] with a third ∞: the
    medium tier."""
    a_mat, b, valid, is_normal, mu_row = capsule_pile_system
    v = int(valid.sum())
    assert v > lcp_kernel.STAGED_ROWS, v
    if mu == 0.4:
        mu_row = np.full_like(mu_row, 0.4)
    elif mu == "mixed":
        mu_row = np.random.default_rng(17).uniform(0.2, 1.0, mu_row.shape)
        mu_row[:, ::3] = np.inf
    tiers, _, rounds, err = _hold_model((a_mat, b, valid, is_normal, mu_row))
    assert tiers == [lcp_kernel.tier_of(288, v)] == ["medium"]
    print(f"[lcp-kernel] capsule pile ({mu}): {v} valid rows, rounds "
          f"{rounds}, err {err:.3e} of max|λ|")


def test_chain_floor_of_the_pivot_kernel():
    """``lcp_pivot_bound``'s ``chain_ms``: the longest world's solves ×
    its active rows (else its valid rows) × the dependent operations of a
    pivot and a back-substitution step, at 4 cycles each at 1.98 GHz; not
    part of the bound."""
    from rl_ode_physics_tpu_torch.utils import bounds
    valid = torch.zeros((3, 288), dtype=torch.bool)
    valid[0, :27] = True
    valid[1, :42] = True
    valid[2, :30] = True
    rounds = torch.tensor([4, 3, 9], dtype=torch.int32)
    per = bounds.LCP_CHAIN_PER_PIVOT_STEP + bounds.LCP_CHAIN_PER_BACK_STEP
    for active, steps in ((None, max(5 * 27, 4 * 42, 10 * 30)),
                          (torch.tensor([27, 40, 11]),
                           max(5 * 27, 4 * 40, 10 * 11))):
        got = bounds.lcp_pivot_bound(valid, rounds, torch.float64,
                                     active=active)
        assert got["chain_ms"] == pytest.approx(
            steps * per * bounds.CYCLES_PER_DEPENDENT_OP
            / bounds.BOOST_CLOCK_HZ * 1e3)
        assert got["bound_ms"] == max(got["bytes_ms"], got["ops_ms"])


@pytest.mark.parametrize("mu", [None, 0.4, "mixed"],
                         ids=["mu_inf", "mu_finite", "mu_per_contact"])
def test_active_rows_of_the_last_solve(mu, monkeypatch):
    """``bounds.lcp_active_rows`` reads each world's active rows in its
    last solve from λ alone: the model's own count of them, on random
    contact LCPs. Each world takes the rounds that block flips alone take
    (the safeguard off), a capped one among them."""
    from rl_ode_physics_tpu_torch.utils import bounds
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        21, worlds=6, bodies=24, mu=mu)
    lam, rounds, _, _, active = _kernel_model(a_mat, b, valid, is_normal,
                                              True, mu_row)
    got = bounds.lcp_active_rows(*_torch(lam, valid, is_normal), True,
                                 *_torch(mu_row))
    assert got.tolist() == active.tolist()
    assert int(active.min()) < int(valid.sum(1).max())
    monkeypatch.setattr(lcp, "STALL_ROUNDS", 10 ** 6)
    _, block_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), True, *_torch(mu_row))
    assert rounds.tolist() == block_rounds.tolist()
