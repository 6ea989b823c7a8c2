"""The port's Jacobi solver against the JAX package's, on the same bridged
state and contacts: the throughput policy (heavy-ball, 8 sweeps) at μ=∞,
finite μ and per-body surface parameters. Velocities at atol 1e-5 (the
selector scatter sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.ops import integrator as jax_integrator
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu.ops import solver as jax_solver
from rl_ode_physics_tpu.ops import warmstart as jax_warmstart
from rl_ode_physics_tpu_torch.core.config import SolverKind
from rl_ode_physics_tpu_torch.ops import integrator, solver, warmstart
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import configs, settled_state, to_numpy

ATOL = 1e-5

CASES = {
    "mu_inf": dict(),
    "mu_finite": dict(mu=0.4),
    "per_body_surface": dict(per_body_surface=True),
    "plain_jacobi_no_friction": dict(jacobi_beta=0.0, jacobi_omega=1.0,
                                     solver_iterations=20, friction=False),
}


def _inputs(jcfg, substeps=90):
    arrays = dict(settled_state(substeps))
    if jcfg.per_body_surface:
        rng = np.random.default_rng(5)
        n = arrays["friction"].shape[0]
        fr = rng.uniform(0.2, 1.0, n).astype(np.float32)
        fr[::3] = np.inf
        arrays["friction"] = fr
        arrays["restitution"] = rng.uniform(0.0, 0.6, n).astype(np.float32)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    contacts, _ = jax.jit(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    jstate = jax_integrator.apply_external_forces(jstate, jcfg)
    return jstate, contacts


@pytest.mark.parametrize("case", list(CASES))
def test_solve_jacobi_matches(case):
    jcfg, tcfg = configs(**CASES[case])
    jstate, jcontacts = _inputs(jcfg)
    assert int(jcontacts.count) >= 6
    ref = jax.jit(lambda s, c: jax_solver.solve_jacobi(s, c, jcfg))(
        jstate, jcontacts)
    tstate = bridge.world_from_numpy(to_numpy(jstate), device="cpu")
    tcontacts = bridge.contacts_from_numpy(to_numpy(jcontacts), device="cpu")
    got = solver.solve(tstate, tcontacts, tcfg)
    moved = 0.0
    for name in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), r,
                                   atol=ATOL, rtol=0, err_msg=name)
        moved += float(np.abs(r - np.asarray(getattr(jstate, name))).max())
    assert moved > 1e-3                  # the contacts did something


def test_apply_external_forces_and_integrate_match():
    jcfg, tcfg = configs()
    arrays = settled_state(90)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jstate = jstate.replace(torque=jnp.ones_like(jstate.torque) * 0.3,
                            force=jnp.ones_like(jstate.force) * -0.7)
    tstate = bridge.world_from_numpy(to_numpy(jstate), device="cpu")
    ref = jax_integrator.integrate_positions(
        jax_integrator.apply_external_forces(jstate, jcfg), jcfg)
    got = integrator.integrate_positions(
        integrator.apply_external_forces(tstate, tcfg), tcfg)
    ref, got = to_numpy(ref), bridge.world_to_numpy(got, 0)
    for name in ("pos", "quat", "linvel", "angvel", "force", "torque"):
        np.testing.assert_allclose(got[name], ref[name], atol=1e-6, rtol=0,
                                   err_msg=name)
    assert got["tick"] == ref["tick"]


@pytest.mark.parametrize("override", [
    dict(solver=SolverKind.PGS, solver_cm=True),
    dict(solver=SolverKind.DANTZIG),
    dict(solver_cm=True), dict(solver_matmul_dtype="bfloat16")])
def test_unported_solver_options_raise(override):
    """DANTZIG, the component-major loop (with either solver) and bf16
    solver products raise; JACOBI and PGS solve."""
    _, tcfg = configs(**override)
    arrays = settled_state(30)
    tstate = bridge.world_from_numpy(arrays, device="cpu")
    jcfg, _ = configs()
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    contacts, _ = jax.jit(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    tcontacts = bridge.contacts_from_numpy(to_numpy(contacts), device="cpu")
    with pytest.raises(NotImplementedError):
        solver.solve(tstate, tcontacts, tcfg)


def test_warm_start_raises():
    """Warm starting takes PGS and JACOBI, as in the JAX package; the warm
    step of another solver raises when it is made."""
    _, tcfg = configs(solver=SolverKind.DANTZIG)
    with pytest.raises(ValueError):
        warmstart.make_warm_step_fn(tcfg)
    with pytest.raises(ValueError):
        jax_warmstart.make_warm_step_fn(configs(solver=SolverKind.DANTZIG)[0])


def test_solver_kinds_share_values():
    assert ({k.name: k.value for k in SolverKind}
            == {k.name: k.value for k in JaxSolverKind})
