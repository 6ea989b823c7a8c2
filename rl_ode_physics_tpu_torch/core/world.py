"""The substep: collide, apply forces, solve, integrate.

The port of ``rl_ode_physics_tpu/core/world.py:_step_impl`` (``:262-336``),
``step_with_diagnostics`` and ``_base_metrics`` (``:339-366``) and
``make_step_fn`` (``:369-410``), every pipeline of the JAX step:
the dense pipeline, the typed narrowphase (component-major or row-major)
and the classic broadphase + narrowphase, each with an optional static
trimesh (the dense pipeline hands a mesh step to the classic one, as the
JAX step does). Every function takes a batch of worlds ``(B, …)``; the JAX
package's ``vmap`` is the leading world axis here, and a diagnostics
counter is a (B,) tensor, one value per world.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops import broadphase, dense, integrator
from rl_ode_physics_tpu_torch.ops import narrowphase
from rl_ode_physics_tpu_torch.ops import solver as solver_ops
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh, mesh_narrowphase


def _check_supported(config: EngineConfig, trimesh=None) -> None:
    """Raise for a config whose step the port does not have yet: the
    DANTZIG solver, the component-major solver loop and bf16 selector
    products (a dense step without a mesh runs its own solver)."""
    config.validate()
    if config.dense_pipeline and trimesh is None:
        return
    if config.solver not in (SolverKind.JACOBI, SolverKind.PGS):
        raise NotImplementedError(
            f"solver {config.solver.value!r} is not ported (JACOBI and PGS)")
    if config.solver_cm:
        raise NotImplementedError("the component-major solver loop "
                                  "(solver_cm) is not ported")
    if config.solver_matmul_dtype != "float32":
        raise NotImplementedError(
            f"solver_matmul_dtype={config.solver_matmul_dtype!r}: the port "
            f"runs the selector products in float32")


def step(state: WorldState, config: EngineConfig,
         trimesh: TriMesh | None = None) -> WorldState:
    """One fixed substep for every world of the batch.

    Contacts come from the current positions; forces and gravity advance
    the velocities, the solver corrects them, positions integrate with the
    corrected velocities. Pairs and contacts dropped at a full capacity
    accumulate on ``state.overflow``. ``trimesh``: an optional static mesh,
    shared by every world, whose contacts merge into the same rows; its
    sweep runs the hand-written kernel on CUDA tensors.
    """
    _check_supported(config, trimesh)
    return _step_impl(state, config, trimesh)


def step_with_diagnostics(state: WorldState, config: EngineConfig,
                          trimesh: TriMesh | None = None):
    """``step`` that also returns the per-tick counters of every world:
    (state, {name: (B,) tensor}). The same ``_step_impl`` as ``step``, so
    diagnostics never run another pipeline. Counters: ``num_pairs``,
    ``num_contacts``, ``pair_overflow``, ``contact_overflow`` (int32),
    ``max_penetration``, ``kinetic_energy`` (the state's dtype) and
    ``num_bodies`` (int32)."""
    _check_supported(config, trimesh)
    return _step_impl(state, config, trimesh, with_metrics=True)


def _step_impl(state: WorldState, config: EngineConfig,
               trimesh: TriMesh | None, with_metrics: bool = False):
    if config.dense_pipeline and trimesh is None:
        manifold = dense.dense_narrowphase(state, config)
        state = integrator.apply_external_forces(state, config)
        state = dense.dense_solve(state, manifold, config)
        state = integrator.integrate_positions(state, config)
        if not with_metrics:
            return state
        _, _, depths, valid = manifold
        zero = torch.zeros_like(state.overflow)
        return state, _base_metrics(
            state,
            num_pairs=valid.any(-1).flatten(1).sum(1, dtype=torch.int32),
            num_contacts=valid.flatten(1).sum(1, dtype=torch.int32),
            pair_overflow=zero,        # the dense pipeline drops nothing
            contact_overflow=zero,
            max_penetration=torch.where(valid, depths, 0.0).flatten(1)
            .amax(1))

    extra = None
    if trimesh is not None:
        extra = mesh_narrowphase(state, trimesh, config)
    if config.typed_buckets:
        # bucket drops are folded into contacts.overflow
        contacts, num_pairs = narrowphase.narrowphase_typed(state, config,
                                                            extra)
        pair_overflow = torch.zeros_like(state.overflow)
    else:
        cand = broadphase.broadphase(state, config)
        contacts = narrowphase.narrowphase(state, cand, config, extra)
        num_pairs, pair_overflow = cand.count, cand.overflow
    # dropped pairs and rows accumulate on the state itself
    state = state.replace(
        overflow=state.overflow + contacts.overflow + pair_overflow)
    state = integrator.apply_external_forces(state, config)
    state = solver_ops.solve(state, contacts, config)
    state = integrator.integrate_positions(state, config)
    if not with_metrics:
        return state
    if not torch.is_tensor(num_pairs):        # no bucket enabled
        num_pairs = torch.full_like(state.overflow, num_pairs)
    return state, _base_metrics(
        state,
        num_pairs=num_pairs.to(torch.int32),
        num_contacts=contacts.count,
        pair_overflow=pair_overflow.to(torch.int32),
        contact_overflow=contacts.overflow,
        max_penetration=torch.where(contacts.valid, contacts.depth,
                                    0.0).amax(1))


def _base_metrics(state: WorldState, **counters):
    """The per-tick counters shared by every pipeline, per world: the
    kinetic energy of the dynamic bodies' linear motion and their count."""
    dyn = state.dynamic
    m = torch.where(state.inv_mass > 0,
                    1.0 / torch.clamp_min(state.inv_mass, 1e-30), 0.0)
    kinetic = 0.5 * torch.sum(
        m * torch.where(dyn, torch.sum(state.linvel ** 2, -1), 0.0), -1)
    counters.update(kinetic_energy=kinetic,
                    num_bodies=dyn.sum(-1, dtype=torch.int32))
    return counters


def make_step_fn(config: EngineConfig, substeps: int = 1,
                 trimesh: TriMesh | None = None):
    """A function state → state that runs ``substeps`` substeps, with
    ``trimesh`` as static scene geometry when given."""
    _check_supported(config, trimesh)
    if substeps < 1:
        raise ValueError(f"substeps={substeps} must be at least 1")

    def fn(state: WorldState) -> WorldState:
        for _ in range(substeps):
            state = _step_impl(state, config, trimesh)
        return state

    return fn
