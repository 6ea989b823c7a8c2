"""The port's projected Gauss-Seidel solver against the JAX package's.

``solve_pgs`` on the settled pile's classic-pipeline contacts (24 boxes,
spheres and capsules, K=8), two worlds whose velocities differ, held to
the JAX ``solve_pgs`` under ``vmap``: cold and warm started, with
``return_lam``, at μ=∞, finite μ and per-body surfaces. Velocities and
impulses at atol 1e-5 (sequential PGS carries each row's roundoff into the
next; XLA fuses multiply-adds the port rounds twice). The bounded row loop
is bitwise the full one, and the PGS and conformance steps follow the JAX
steps for 8 substeps at atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.ops import broadphase as jax_bp
from rl_ode_physics_tpu.ops import integrator as jax_integrator
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu.ops import solver as jax_solver
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.ops import solver
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (PILE, STACK, jax_state, settled_mini_stack,
                         settled_pile, to_numpy)

ATOL = 1e-5
STEP_ATOL = 1e-5
SUBSTEPS = 8

CASES = {
    "mu_inf": dict(),
    "mu_finite": dict(mu=0.4),
    "per_body_surface": dict(per_body_surface=True),
    "no_friction": dict(friction=False, sor_omega=1.0),
}


def _batch_inputs(jcfg):
    """The settled pile in two worlds (the second kicked), its classic
    contacts and the velocities after external forces, as JAX batches."""
    arrays = dict(settled_pile(90))
    n = arrays["pos"].shape[0]
    if jcfg.per_body_surface:
        rng = np.random.default_rng(5)
        fr = rng.uniform(0.2, 1.0, n).astype(np.float32)
        fr[::3] = np.inf
        arrays["friction"] = fr
        arrays["restitution"] = rng.uniform(0.0, 0.6, n).astype(np.float32)
    batch = {k: np.stack([v, v]) for k, v in arrays.items()}
    rng = np.random.default_rng(11)
    dyn = batch["inv_mass"][1] > 0
    kick = rng.normal(scale=0.1, size=(n, 3))
    batch["linvel"][1] = (batch["linvel"][1]
                          + np.where(dyn[:, None], kick, 0)).astype(np.float32)
    jstate = jax_state(batch)

    def contacts_of(s):
        return jax_np.narrowphase(s, jax_bp.broadphase(s, jcfg), jcfg)

    contacts = jax.jit(jax.vmap(contacts_of))(jstate)
    jstate = jax.vmap(
        lambda s: jax_integrator.apply_external_forces(s, jcfg))(jstate)
    return jstate, contacts


def _ported(jstate, contacts):
    return (bridge.world_from_numpy(to_numpy(jstate), device="cpu"),
            bridge.contacts_from_numpy(to_numpy(contacts), device="cpu"))


def _lam0(contacts, seed=3):
    """Random (B, C, 3) initial impulses: normal ≥ 0, friction either
    sign; the solver masks the dead rows itself."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(contacts.valid).shape + (3,)
    lam = rng.uniform(-0.02, 0.02, shape).astype(np.float32)
    lam[..., 0] = np.abs(lam[..., 0])
    return lam


def _configs(**kw):
    return (JaxConfig(**PILE, solver=JaxSolverKind.PGS, **kw),
            EngineConfig(**PILE, solver=SolverKind.PGS, **kw))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_pgs_matches_jax(case, warm):
    jcfg, tcfg = _configs(**CASES[case])
    jstate, jcontacts = _batch_inputs(jcfg)
    counts = np.asarray(jcontacts.count)
    assert (counts >= 10).all(), counts
    lam0 = _lam0(jcontacts) if warm else None

    def jax_solve(s, c, l0):
        return jax_solver.solve_pgs(s, c, jcfg, lam0=l0, return_lam=True)

    ref, ref_lam = jax.jit(jax.vmap(jax_solve))(
        jstate, jcontacts, None if lam0 is None else jnp.asarray(lam0))
    tstate, tcontacts = _ported(jstate, jcontacts)
    got, lam = solver.solve_pgs(
        tstate, tcontacts, tcfg,
        lam0=None if lam0 is None else torch.from_numpy(lam0),
        return_lam=True)
    moved = 0.0
    for name in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, atol=ATOL,
                                   rtol=0, err_msg=name)
        moved += float(np.abs(r - np.asarray(getattr(jstate, name))).max())
    assert moved > 1e-3                  # the contacts did something
    np.testing.assert_allclose(lam.numpy(), np.asarray(ref_lam), atol=ATOL,
                               rtol=0, err_msg="lam")
    dead = ~np.asarray(jcontacts.valid)
    assert (lam.numpy()[dead] == 0).all()


def test_bounded_row_loop_is_bitwise_the_full_loop(monkeypatch):
    """The sweep stops at the batch's last live row; visiting every row
    (all 320) gives the same bits, warm started and with its impulses."""
    jcfg, tcfg = _configs(mu=0.4)
    jstate, jcontacts = _batch_inputs(jcfg)
    tstate, tcontacts = _ported(jstate, jcontacts)
    c = tcontacts.a.shape[1]
    bound = solver.live_row_bound(tcontacts.valid)
    assert 0 < bound < c
    assert bound == int(tcontacts.count.max())
    lam0 = torch.from_numpy(_lam0(jcontacts))
    short, lam_s = solver.solve_pgs(tstate, tcontacts, tcfg, lam0=lam0,
                                    return_lam=True)
    monkeypatch.setattr(solver, "live_row_bound", lambda valid: c)
    full, lam_f = solver.solve_pgs(tstate, tcontacts, tcfg, lam0=lam0,
                                   return_lam=True)
    for name in ("linvel", "angvel"):
        assert torch.equal(getattr(short, name), getattr(full, name)), name
    assert torch.equal(lam_s, lam_f)


def test_live_row_bound():
    valid = torch.zeros((3, 6), dtype=torch.bool)
    assert solver.live_row_bound(valid) == 0
    valid[1, :2] = True
    valid[2, 4] = True
    assert solver.live_row_bound(valid) == 5
    assert solver.live_row_bound(torch.zeros((2, 0), dtype=torch.bool)) == 0


def _step_both(jcfg, tcfg, substeps=SUBSTEPS):
    arrays = settled_mini_stack()
    jbatch = jax_state(arrays)
    tbatch = bridge.world_from_numpy(arrays, device="cpu")
    jfn = jax.jit(jax.vmap(jax_make_step_fn(jcfg, substeps=1, donate=False)))
    tfn = make_step_fn(tcfg, substeps=1)
    for _ in range(substeps):
        jbatch = jfn(jbatch)
        tbatch = tfn(tbatch)
    return to_numpy(jbatch), bridge.world_to_numpy(tbatch)


@pytest.mark.parametrize("policy", ["pgs", "conformance"])
def test_pgs_step_matches_jax(policy):
    """mini_stack_world in 2 kicked worlds: the classic pipeline with PGS,
    and ``EngineConfig.conformance`` (PGS, exact box clip, K=8), 8
    substeps on each side."""
    if policy == "pgs":
        jcfg = JaxConfig(**STACK, solver=JaxSolverKind.PGS)
        tcfg = EngineConfig(**STACK, solver=SolverKind.PGS)
    else:
        jcfg = JaxConfig.conformance(**STACK)
        tcfg = EngineConfig.conformance(**STACK)
    ref, got = _step_both(jcfg, tcfg)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=STEP_ATOL,
                                   rtol=0, err_msg=name)
    for name in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[name], ref[name]), name
