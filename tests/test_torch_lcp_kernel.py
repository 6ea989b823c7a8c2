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
  the valid rows gathered, each round's active block eliminated with
  partial pivoting, the pivots and the fixed-point test on local rows),
  against the plain ``_pivot_solve`` in float64: λ within 1e-10 of max |λ|
  and each world's rounds equal, at μ = ∞, a finite μ and per-contact μ.
* The plain ``_pivot_solve`` returns each world's rounds, those the world
  takes alone.
* ``lcp_pivot_solve`` on CPU tensors is the plain version, bit for bit, and
  counts no launch; it raises on what the kernel does not take; its launch
  is sized from the shapes alone.

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
from rl_ode_physics_tpu_torch.testing.lcp_systems import random_contact_lcp

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


def _gauss(m, x):
    """Gaussian elimination with partial pivoting (the first largest
    |pivot|) on x as it goes, then back substitution: the kernel's
    ``gauss``."""
    m, x = m.copy(), x.copy()
    n = len(x)
    for k in range(n):
        at = k + int(np.argmax(np.abs(m[k:, k])))
        if at != k:
            m[[k, at], k:] = m[[at, k], k:]
            x[[k, at]] = x[[at, k]]
        f = m[k + 1:, k] / m[k, k]
        m[k + 1:, k + 1:] -= np.outer(f, m[k, k + 1:])
        x[k + 1:] -= f * x[k]
    for k in range(n - 1, -1, -1):
        x[k] = x[k] / m[k, k]
        x[:k] -= m[:k, k] * x[k]
    return x


def _kernel_model(a_mat, b, valid, is_normal, friction, mu_row=None):
    """``csrc/lcp_pivot.cu``'s algorithm per world in numpy float64: the
    valid rows gathered (local indices), each row's normal row found among
    them, the rounds on the active block alone. Returns (λ (B, R), rounds
    (B,))."""
    bsz, r = b.shape
    c = r // 3
    tol = lcp._TOL
    fp_tol = 1e3 * tol
    lam_out = np.zeros((bsz, r))
    rounds_out = np.zeros(bsz, np.int32)
    for w in range(bsz):
        rows = np.nonzero(valid[w])[0]
        v = len(rows)
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
            out[ai] = _gauss(a[np.ix_(ai, ai)], rhs)
            return out

        done, rnd = False, 0
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
            moved = bool(((nact != act) | (nside != side)).any())
            chg = np.abs(new - lam).max(initial=0.0)
            scale = 1.0 + np.abs(new).max(initial=0.0)
            done = not moved and chg <= fp_tol * scale
            act, side, lam = nact, nside, new
            rnd += 1
        hi = bounds(lam)
        out = solve(act, hi)
        out = np.where(tog, np.maximum(out, 0.0), out)
        out = np.where(box, np.clip(out, -hi, hi), out)
        lam_out[w, rows] = out
        rounds_out[w] = rnd
    return lam_out, rounds_out


def _torch(*arrays):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in arrays]


@pytest.mark.parametrize("mu", [None, 0.4, "mixed"],
                         ids=["mu_inf", "mu_finite", "mu_per_contact"])
@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_model_matches_the_plain_pivot_solve(seed, mu):
    """The kernel's algorithm against the plain batched loop in float64:
    the same λ to roundoff and the same rounds a world, on random contact
    LCPs and on one world of every row valid (V = R, the kernel's
    device-memory branch at these shapes). A random world under a finite μ
    may cycle to the cap of 128 rounds; both then run it to the cap."""
    a_mat, b, valid, is_normal, mu_row = random_contact_lcp(
        seed, worlds=5, bodies=24, mu=mu)
    valid[-1] = True
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), True, *_torch(mu_row))
    got_lam, got_rounds = _kernel_model(a_mat, b, valid, is_normal, True,
                                        mu_row)
    assert want_rounds.dtype == torch.int32 and want_rounds.shape == (5,)
    assert got_rounds.tolist() == want_rounds.tolist()
    assert int(want_rounds.min()) < lcp.MAX_PIVOT_ROUNDS
    scale = float(want_lam.abs().max())
    err = float(np.abs(got_lam - want_lam.numpy()).max())
    assert err <= MODEL_RTOL * scale, (err, scale)
    print(f"[lcp-kernel] model against plain ({mu}): rounds "
          f"{want_rounds.tolist()}, err {err / scale:.3e} of max|λ|")


def test_kernel_model_without_friction():
    """Without friction the friction rows, valid or not, stay inactive at
    0: the pure normal LCP."""
    a_mat, b, valid, is_normal, _ = random_contact_lcp(5, worlds=3,
                                                       bodies=24)
    want_lam, want_rounds = lcp._pivot_solve(
        *_torch(a_mat, b, valid, is_normal), False)
    got_lam, got_rounds = _kernel_model(a_mat, b, valid, is_normal, False)
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
    """The kernel stages up to ``STAGED_ROWS`` valid rows in under 48 KB
    of shared memory a block (no opt-in); past them a world takes one of
    ``POOL_WORLDS`` device-memory slots of R rows, none where every world
    fits."""
    for dtype in (torch.float32, torch.float64):
        cap = lcp_kernel.STAGED_ROWS[dtype]
        shape = lcp_kernel.launch_shape(dtype, 1024, 288)
        assert shape.cap == cap and shape.shared_bytes <= 48 * 1024
        assert shape.pool_worlds == lcp_kernel.POOL_WORLDS
        assert shape.slot_bytes == lcp_kernel.world_bytes(dtype, 288, False)
        assert shape.slot_bytes >= 288 * 289 * dtype.itemsize
        small = lcp_kernel.launch_shape(dtype, 1024, 30)
        assert small.cap == 30 and small.pool_worlds == 0
        assert lcp_kernel.launch_shape(dtype, 3, 288).pool_worlds == 3
