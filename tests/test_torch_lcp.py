"""The port's direct LCP solver (DANTZIG) against the JAX package's.

On the contact states of ``tests/test_lcp.py`` (``bench_world`` of 10
bodies settled under ``EngineConfig(max_bodies=16, max_pair_candidates=64,
max_contacts=64)``), three worlds that take different numbers of pivot
rounds, held to ``jax.vmap(solve_dantzig)``: in float32 within 1e-5
relative to the largest velocity change, and in float64 (the JAX side in a
subprocess, its x64 mode being process-global) within 1e-10, at μ = ∞,
finite μ and per-body surfaces. Then ``lcp_residuals``, the LCP's own
conditions on each world's λ, and the quickstep limit of ``tests/test_lcp.py``: DANTZIG within 1e-3 of PGS
at 800 sweeps under finite μ.
"""

import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.ops import broadphase as jax_bp
from rl_ode_physics_tpu.ops import integrator as jax_integrator
from rl_ode_physics_tpu.ops import lcp as jax_lcp
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.ops import lcp, solver
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    SUBPROCESS_ENV, jax_state, single_cpu_thread, to_numpy)

REPO = pathlib.Path(__file__).resolve().parent.parent
CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=64)
F32_RTOL = 1e-5
F64_ATOL = 1e-10

CASES = {
    "mu_inf": dict(),
    "mu_finite": dict(mu=0.4),
    "per_body_surface": dict(per_body_surface=True),
}


@functools.lru_cache(maxsize=None)
def _worlds():
    """Three worlds as numpy arrays (B = 3): the settled bench world of
    ``tests/test_lcp.py`` (300 substeps), the same kicked, and the world
    after 120 substeps; per-body friction and restitution drawn from a
    seed, used only by the per-body case."""
    cfg = JaxConfig(**CAPS)
    step = jax_make_step_fn(cfg, substeps=1, donate=False)
    w = jax_scenes.bench_world(cfg, num_bodies=10, seed=42)
    early = None
    for i in range(300):
        w = step(w)
        if i == 119:
            early = to_numpy(w)
    late = to_numpy(w)
    batch = {k: np.stack([late[k], late[k], early[k]]) for k in late}
    rng = np.random.default_rng(21)
    dyn = batch["inv_mass"][1] > 0
    kick = rng.normal(scale=0.4, size=batch["linvel"][1].shape)
    batch["linvel"][1] = (batch["linvel"][1]
                          + np.where(dyn[:, None], kick, 0)).astype(np.float32)
    n = batch["friction"].shape[1]
    fr = rng.uniform(0.2, 1.0, (3, n)).astype(np.float32)
    fr[:, ::3] = np.inf
    return batch, fr, rng.uniform(0.0, 0.6, (3, n)).astype(np.float32)


def _arrays(jcfg):
    batch, fr, rest = _worlds()
    batch = dict(batch)
    if jcfg.per_body_surface:
        batch["friction"], batch["restitution"] = fr, rest
    return batch


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """The three worlds' classic contacts and states after external forces
    under ``CASES[case]``, as JAX batches."""
    jcfg = JaxConfig(**CAPS, **CASES[case])
    return _jax_inputs(jcfg, _arrays(jcfg))


def _jax_inputs(jcfg, arrays):
    """Contacts of the classic pipeline and the state after external
    forces, as JAX batches."""
    jstate = jax_state(arrays)

    def contacts_of(s):
        return jax_np.narrowphase(s, jax_bp.broadphase(s, jcfg), jcfg)

    contacts = jax.jit(jax.vmap(contacts_of))(jstate)
    jstate = jax.vmap(
        lambda s: jax_integrator.apply_external_forces(s, jcfg))(jstate)
    return jstate, contacts


def _ported(jstate, contacts):
    return (bridge.world_from_numpy(to_numpy(jstate), device="cpu"),
            bridge.contacts_from_numpy(to_numpy(contacts), device="cpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_solve_dantzig_matches_jax_vmap(case):
    jcfg, tcfg = JaxConfig(**CAPS, **CASES[case]), EngineConfig(
        **CAPS, **CASES[case])
    jstate, jcontacts = _inputs(case)
    counts = np.asarray(jcontacts.count)
    assert (counts >= 4).all(), counts
    ref = jax.jit(jax.vmap(
        lambda s, c: jax_lcp.solve_dantzig(s, c, jcfg)))(jstate, jcontacts)
    tstate, tcontacts = _ported(jstate, jcontacts)
    got = lcp.solve_dantzig(tstate, tcontacts, tcfg)
    change = 0.0
    worst = 0.0
    for name in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, name))
        change = max(change, float(np.abs(
            r - np.asarray(getattr(jstate, name))).max()))
        worst = max(worst, float(np.abs(getattr(got, name).numpy()
                                        - r).max()))
    assert change > 1e-3                 # the contacts did something
    assert worst <= F32_RTOL * change, (worst, change)
    print(f"[lcp:{case}] float32 max abs err {worst:.3e} of a velocity "
          f"change {change:.3e}")


def _in_float64(obj):
    """A state or contacts with its float32 tensors in float64."""
    return type(obj)(**{
        f.name: (v.double() if v.dtype == torch.float32 else v)
        for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]})


@pytest.mark.parametrize("case", ["mu_inf", "mu_finite"])
def test_each_world_freezes_at_its_own_round(case):
    """In float64, the three worlds take different numbers of pivot rounds
    alone, the batch runs as many rounds as the slowest of them, and gives
    each world the λ (to roundoff) it gets alone: a world that is done
    early stays frozen. (In float32 a world's rounds can depend on the batch's
    summation order: under finite μ one world reaches the cap of 128 in
    the batch, as in the JAX package, and 14 alone.)"""
    tcfg = EngineConfig(**CAPS, dtype="float64", **CASES[case])
    jstate, jcontacts = _inputs(case)
    tstate, tcontacts = map(_in_float64, _ported(jstate, jcontacts))
    _, a_mat, b, valid, is_normal, mu_row = lcp._build_lcp(tstate, tcontacts,
                                                           tcfg)
    lam, rounds = lcp._pivot_solve(a_mat, b, valid, is_normal, True, mu_row)
    alone_rounds = []
    for w in range(3):
        alone, r_w = lcp._pivot_solve(
            a_mat[w:w + 1], b[w:w + 1], valid[w:w + 1], is_normal[w:w + 1],
            True, mu_row[w:w + 1])
        alone_rounds.append(int(r_w[0]))
        torch.testing.assert_close(alone[0], lam[w], rtol=0,
                                   atol=1e-12 * float(lam.abs().max()))
    assert len(set(alone_rounds)) > 1, alone_rounds
    # each world's rounds in the batch are those it takes alone
    assert rounds.tolist() == alone_rounds, (rounds, alone_rounds)
    print(f"[lcp:{case}] float64 pivot rounds alone {alone_rounds}, "
          f"batched {rounds}")


# the JAX side of the float64 comparison, run in its own process
_F64_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from rl_ode_physics_tpu.core.config import EngineConfig
from rl_ode_physics_tpu.core.state import WorldState
from rl_ode_physics_tpu.ops import broadphase, integrator, lcp, narrowphase
data = dict(np.load(sys.argv[1]))
out = {}
for case, kw in (("mu_inf", {}), ("mu_finite", {"mu": 0.4}),
                 ("per_body_surface", {"per_body_surface": True})):
    cfg = EngineConfig(max_bodies=16, max_pair_candidates=64,
                       max_contacts=64, dtype="float64", **kw)
    arrays = {k[len(case) + 1:]: v for k, v in data.items()
              if k.startswith(case + ":")}
    state = WorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert state.pos.dtype == jnp.float64
    contacts = jax.vmap(lambda s: narrowphase.narrowphase(
        s, broadphase.broadphase(s, cfg), cfg))(state)
    state = jax.vmap(lambda s: integrator.apply_external_forces(s, cfg))(
        state)
    solved = jax.vmap(lambda s, c: lcp.solve_dantzig(s, c, cfg))(state,
                                                                  contacts)
    for name, tree in (("state", state), ("contacts", contacts),
                       ("solved", solved)):
        for f in tree.__dataclass_fields__:
            out[f"{case}:{name}:{f}"] = np.asarray(getattr(tree, f))
np.savez(sys.argv[2], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_float64(tmp_path_factory):
    """The JAX float64 DANTZIG solves of every case: {case: (state,
    contacts, solved)} as numpy dicts."""
    tmp = tmp_path_factory.mktemp("lcp64")
    inputs = {}
    for case, kw in CASES.items():
        arrays = _arrays(JaxConfig(**CAPS, **kw))
        for k, v in arrays.items():
            inputs[f"{case}:{k}"] = (v.astype(np.float64)
                                     if v.dtype == np.float32 else v)
    np.savez(tmp / "in.npz", **inputs)
    r = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=SUBPROCESS_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    data = np.load(tmp / "out.npz")
    out = {}
    for case in CASES:
        out[case] = tuple(
            {k.split(":")[2]: data[k] for k in data.files
             if k.startswith(f"{case}:{name}:")}
            for name in ("state", "contacts", "solved"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_solve_dantzig_float64_matches_jax(case, jax_float64):
    state, contacts, solved = jax_float64[case]
    assert state["pos"].dtype == np.float64
    tcfg = EngineConfig(**CAPS, dtype="float64", **CASES[case])
    got = lcp.solve_dantzig(bridge.world_from_numpy(state, device="cpu"),
                            bridge.contacts_from_numpy(contacts,
                                                       device="cpu"), tcfg)
    assert got.linvel.dtype == torch.float64
    worst = max(float(np.abs(getattr(got, n).numpy() - solved[n]).max())
                for n in ("linvel", "angvel"))
    assert worst <= F64_ATOL, worst
    change = np.abs(solved["linvel"] - state["linvel"]).max()
    assert change > 1e-3
    print(f"[lcp64:{case}] max abs err {worst:.3e}")


def test_lcp_residuals_match_jax():
    jcfg, tcfg = JaxConfig(**CAPS, mu=0.4), EngineConfig(**CAPS, mu=0.4)
    jstate, jcontacts = _inputs("mu_finite")
    solved = jax.vmap(lambda s, c: jax_lcp.solve_dantzig(s, c, jcfg))(
        jstate, jcontacts)
    ref = jax.vmap(lambda s, c, o: jax_lcp.lcp_residuals(s, c, jcfg, o))(
        jstate, jcontacts, solved)
    tstate, tcontacts = _ported(jstate, jcontacts)
    tsolved = bridge.world_from_numpy(to_numpy(solved), device="cpu")
    got = lcp.lcp_residuals(tstate, tcontacts, tcfg, tsolved)
    for g, r in zip(got, ref):
        assert g.shape == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    assert float(got[0].max()) > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_pivot_solve_meets_the_lcp_conditions(case):
    """In float64, each world's λ solves its LCP: with w = Aλ + b, normal
    rows λ ≥ 0, w ≥ 0 and λ·w = 0; friction rows with μ = ∞ w = 0; boxed
    rows |λ| ≤ μ·λ_n, w = 0 inside the box, w ≤ 0 at +μ·λ_n and w ≥ 0 at
    −μ·λ_n; invalid rows λ = 0. w and λ·w within 1e-12 of (1 + max |λ|)
    · max |A| (measured ≤ 7e-16 absolute); the box edges within 1e-8 of
    1 + max |λ|: the bounds are those of the last round's λ_n, which the
    final solve moves within the loop's fixed-point test (1e-7 relative;
    measured ≤ 1e-9)."""
    tcfg = EngineConfig(**CAPS, dtype="float64", **CASES[case])
    tstate, tcontacts = map(_in_float64, _ported(*_inputs(case)))
    _, a_mat, b, valid, is_normal, mu_row = lcp._build_lcp(tstate, tcontacts,
                                                           tcfg)
    lam, rounds = lcp._pivot_solve(a_mat, b, valid, is_normal, True, mu_row)
    rounds = int(rounds.max())
    assert rounds < lcp.MAX_PIVOT_ROUNDS
    w = torch.bmm(a_mat, lam[..., None])[..., 0] + b
    c = lam.shape[1] // 3
    scale = 1.0 + float(lam.abs().max())
    tol = 1e-12 * scale * float(a_mat.abs().max())
    box_tol = 1e-8 * scale
    assert bool((lam[~valid] == 0).all())
    live_n = valid[:, :c]
    lam_n, w_n = lam[:, :c], w[:, :c]
    assert float(lam_n[live_n].min()) >= -tol
    assert float(w_n[live_n].min()) >= -tol
    assert float((lam_n * w_n)[live_n].abs().max()) <= tol
    mu2 = mu_row.repeat(1, 2)
    live_t = valid[:, c:]
    lam_t, w_t = lam[:, c:], w[:, c:]
    bilateral = live_t & torch.isinf(mu2)
    boxed = live_t & ~torch.isinf(mu2)
    if bool(bilateral.any()):
        assert float(w_t[bilateral].abs().max()) <= tol
    if case == "mu_inf":
        assert bool(bilateral.any()) and not bool(boxed.any())
    else:
        hi = mu2 * torch.clamp_min(lam_n, 0.0).repeat(1, 2)
        assert float((lam_t.abs() - hi)[boxed].max()) <= box_tol
        at_hi = boxed & (lam_t >= hi - box_tol)
        at_lo = boxed & (lam_t <= -hi + box_tol)
        inside = boxed & ~at_hi & ~at_lo
        assert bool(inside.any()) and bool((at_hi ^ at_lo).any())
        for rows, ok in ((inside, w_t.abs() <= tol),
                         (at_hi & ~at_lo, w_t <= tol),
                         (at_lo & ~at_hi, w_t >= -tol)):
            assert bool(ok[rows].all()), (case, int(rows.sum()))
    print(f"[lcp:{case}] float64 LCP conditions hold at tol {tol:.3e} "
          f"({rounds} pivot rounds)")


def test_dantzig_is_the_finite_mu_quickstep_limit():
    """``tests/test_lcp.py:84`` in the port: under μ = 0.4, DANTZIG is the
    many-sweep PGS fixed point, within 1e-3 of 800 sweeps and closer to it
    than 40, and every friction impulse lies in its box."""
    tcfg = EngineConfig(**CAPS, mu=0.4)
    jcfg = JaxConfig(**CAPS, mu=0.4)
    arrays = {k: v[:1] for k, v in _arrays(jcfg).items()}
    jstate, jcontacts = _jax_inputs(jcfg, arrays)
    tstate, tcontacts = _ported(jstate, jcontacts)
    d = lcp.solve_dantzig(tstate, tcontacts, tcfg)

    def dist(x):
        return float(torch.cat([x.linvel - d.linvel,
                                x.angvel - d.angvel], -1).abs().max())

    err_40 = dist(solver.solve_pgs(tstate, tcontacts,
                                   tcfg.replace(solver_iterations=40)))
    err_800 = dist(solver.solve_pgs(tstate, tcontacts,
                                    tcfg.replace(solver_iterations=800)))
    assert err_800 < err_40
    assert err_800 < 1e-3, (err_40, err_800)
    _, a_mat, b, valid, is_normal, mu_row = lcp._build_lcp(tstate, tcontacts,
                                                           tcfg)
    lam, _ = lcp._pivot_solve(a_mat, b, valid, is_normal, True, mu_row)
    lam = lam[0]
    c = tcontacts.a.shape[1]
    v = tcontacts.valid[0]
    lam_n = lam[:c]
    assert float(lam_n[v].min()) >= -1e-6
    bound = mu_row[0] * torch.clamp_min(lam_n, 0.0) + 1e-5
    assert bool((lam[c:2 * c].abs() <= bound)[v].all())
    assert bool((lam[2 * c:].abs() <= bound)[v].all())
    print(f"[lcp:quickstep] PGS 40 sweeps {err_40:.3e}, 800 {err_800:.3e}")


def test_pivot_solve_matches_jax_without_friction():
    """The pure normal LCP (``tests/test_lcp.py``'s complementarity case):
    the port's λ of every world against the JAX ``_pivot_solve``."""
    jcfg, tcfg = (JaxConfig(**CAPS, friction=False),
                  EngineConfig(**CAPS, friction=False))
    jstate, jcontacts = _jax_inputs(jcfg, _arrays(jcfg))

    def jax_lam(s, c):
        _, a_mat, b, valid, is_normal, _ = jax_lcp._build_lcp(s, c, jcfg)
        return jax_lcp._pivot_solve(a_mat, b, valid & is_normal, is_normal,
                                    False)

    ref = np.asarray(jax.jit(jax.vmap(jax_lam))(jstate, jcontacts))
    tstate, tcontacts = _ported(jstate, jcontacts)
    _, a_mat, b, valid, is_normal, _ = lcp._build_lcp(tstate, tcontacts,
                                                      tcfg)
    lam, _ = lcp._pivot_solve(a_mat, b, valid & is_normal, is_normal, False)
    np.testing.assert_allclose(lam.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    w = torch.bmm(a_mat, lam[..., None])[..., 0] + b
    live = (valid & is_normal)
    assert float(lam[live].min()) >= -1e-6
    assert float(w[live].min()) >= -1e-4
    assert float((lam * w)[live].abs().max()) < 1e-4
