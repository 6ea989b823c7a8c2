"""The port's component-major Jacobi loop (``solver_cm``) and bf16 solver
products (``solver_matmul_dtype="bfloat16"``), the bench's A/B levers,
against the JAX ``solve_jacobi`` under ``vmap``.

Inputs: the small bench world settled 90 substeps, in two worlds whose
velocities differ, its component-major typed contacts and the velocities
after external forces, at μ = ∞, finite μ and per-body surfaces.
Tolerances:
- ``solver_cm`` in float32: atol 2e-5, the tolerance
  ``tests/test_typed_buckets.py:122-127`` puts between the JAX package's
  two loops (the products sum in another order);
- bf16: one bf16 spacing of the velocities, 2⁻⁸ of the largest |v| of the
  field: both sides round the gathered velocities and the scattered
  impulses to bf16 at the same points, but a different summation order
  can carry a value across a rounding boundary. The largest error is
  printed.
The port's component-major loop is also held to its row-major loop, and
the loop choice to the JAX package's (joints, warm starts and impulse
outputs take the row-major loop; PGS ignores ``solver_cm``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.ops import integrator as jax_integrator
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu.ops import solver as jax_solver
from rl_ode_physics_tpu.parallel.batch import replicate as jax_replicate
from rl_ode_physics_tpu_torch.core.config import SolverKind
from rl_ode_physics_tpu_torch.ops import solver
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    configs, settled_state, single_cpu_thread, to_numpy)

CM_ATOL = 2e-5
BF16_SPACING = 2.0 ** -8

LEVERS = {
    "solver_cm": dict(solver_cm=True),
    "bf16": dict(solver_matmul_dtype="bfloat16"),
    "solver_cm_bf16": dict(solver_cm=True, solver_matmul_dtype="bfloat16"),
}
SURFACES = {
    "mu_inf": dict(),
    "mu_finite": dict(mu=0.4),
    "per_body_surface": dict(per_body_surface=True),
}


@functools.lru_cache(maxsize=None)
def _inputs(surface):
    """Two worlds of the settled small bench world, the second kicked; its
    contacts and the state after external forces under
    ``SURFACES[surface]``, as JAX batches."""
    jcfg, _ = configs(**SURFACES[surface])
    arrays = dict(settled_state(90))
    if jcfg.per_body_surface:
        rng = np.random.default_rng(5)
        n = arrays["friction"].shape[0]
        fr = rng.uniform(0.2, 1.0, n).astype(np.float32)
        fr[::3] = np.inf
        arrays["friction"] = fr
        arrays["restitution"] = rng.uniform(0.0, 0.6, n).astype(np.float32)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = to_numpy(jax_replicate(jstate, 2))
    rng = np.random.default_rng(13)
    dyn = batch["inv_mass"] > 0
    kick = rng.normal(scale=0.1, size=batch["linvel"].shape)
    batch["linvel"] = (batch["linvel"]
                       + np.where(dyn[..., None], kick, 0)).astype(np.float32)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in batch.items()})
    contacts = jax.jit(jax.vmap(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg)[0]))(jstate)
    jstate = jax.vmap(
        lambda s: jax_integrator.apply_external_forces(s, jcfg))(jstate)
    return jstate, contacts


def _ported(jstate, contacts):
    return (bridge.world_from_numpy(to_numpy(jstate), device="cpu"),
            bridge.contacts_from_numpy(to_numpy(contacts), device="cpu"))


@pytest.mark.parametrize("surface", list(SURFACES))
@pytest.mark.parametrize("lever", list(LEVERS))
def test_lever_matches_jax_vmap(lever, surface):
    jcfg, tcfg = configs(**LEVERS[lever], **SURFACES[surface])
    jstate, jcontacts = _inputs(surface)
    assert (np.asarray(jcontacts.count) >= 6).all()
    ref = jax.jit(jax.vmap(
        lambda s, c: jax_solver.solve_jacobi(s, c, jcfg)))(jstate, jcontacts)
    tstate, tcontacts = _ported(jstate, jcontacts)
    got = solver.solve(tstate, tcontacts, tcfg)
    bf16 = tcfg.solver_matmul_dtype == "bfloat16"
    worst = {}
    for name in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.dtype == np.float32
        tol = BF16_SPACING * float(np.abs(r).max()) if bf16 else CM_ATOL
        worst[name] = float(np.abs(g - r).max())
        assert worst[name] <= tol, (name, worst[name], tol)
        assert float(np.abs(r - np.asarray(getattr(jstate, name))).max()) > 0
    if bf16:
        # the lever took effect: the float32 products give other bits
        plain = solver.solve(tstate, tcontacts,
                             tcfg.replace(solver_matmul_dtype="float32"))
        assert not torch.equal(plain.linvel, got.linvel)
    print(f"[{lever}:{surface}] largest error {worst} "
          f"({'one bf16 spacing' if bf16 else f'atol {CM_ATOL}'})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("surface", list(SURFACES))
def test_component_major_loop_matches_row_major(surface, dtype):
    """The port's two loops on the same inputs: float32 within CM_ATOL, bf16
    within one bf16 spacing."""
    _, tcfg = configs(solver_matmul_dtype=dtype, **SURFACES[surface])
    tstate, tcontacts = _ported(*_inputs(surface))
    row = solver.solve_jacobi(tstate, tcontacts, tcfg)
    cm = solver.solve_jacobi(tstate, tcontacts, tcfg.replace(solver_cm=True))
    for name in ("linvel", "angvel"):
        r = getattr(row, name)
        tol = (BF16_SPACING * float(r.abs().max()) if dtype == "bfloat16"
               else CM_ATOL)
        err = float((getattr(cm, name) - r).abs().max())
        assert err <= tol, (name, err, tol)


def test_warm_and_lambda_solves_take_the_row_major_loop():
    """With ``lam0`` or ``return_lam`` the row-major loop runs under
    ``solver_cm``, as in the JAX package: the same bits as without it."""
    _, tcfg = configs(mu=0.4)
    tstate, tcontacts = _ported(*_inputs("mu_finite"))
    rng = np.random.default_rng(3)
    lam0 = torch.from_numpy(rng.uniform(0.0, 0.02, tuple(
        tcontacts.valid.shape) + (3,)).astype(np.float32))
    for kw in (dict(lam0=lam0, return_lam=True), dict(return_lam=True)):
        a, la = solver.solve_jacobi(tstate, tcontacts, tcfg, **kw)
        b, lb = solver.solve_jacobi(tstate, tcontacts,
                                    tcfg.replace(solver_cm=True), **kw)
        assert torch.equal(a.linvel, b.linvel) and torch.equal(la, lb)


def test_pgs_ignores_solver_cm():
    """``solve`` under PGS runs ``solve_pgs`` whatever ``solver_cm`` says,
    as the JAX ``solve`` does: the same bits."""
    _, tcfg = configs(solver=SolverKind.PGS)
    tstate, tcontacts = _ported(*_inputs("mu_inf"))
    a = solver.solve(tstate, tcontacts, tcfg)
    b = solver.solve(tstate, tcontacts, tcfg.replace(solver_cm=True))
    for name in ("linvel", "angvel"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_bf16_products_keep_float32_results():
    """The product helper returns the state's dtype from bf16 operands
    (one rounding fewer than a bf16 ``bmm``) and equals the float32
    product of the rounded operands."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn((2, 5, 7), generator=gen).to(torch.bfloat16)
    b = torch.randn((2, 7, 3), generator=gen).to(torch.bfloat16)
    got = solver._mm(a, b, torch.float32)
    assert got.dtype == torch.float32
    assert solver.bf16_product_route("cpu") == "upcast"
    assert torch.equal(got, torch.bmm(a.float(), b.float()))
    assert not torch.equal(got, torch.bmm(a, b).float())
