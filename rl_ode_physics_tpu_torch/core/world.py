"""The substep: collide, apply forces, solve, integrate.

The port of ``rl_ode_physics_tpu/core/world.py:_step_impl`` (``:262-336``),
``step_with_diagnostics`` and ``_base_metrics`` (``:339-366``) and
``make_step_fn`` (``:369-410``), every pipeline of the JAX step:
the dense pipeline, the typed narrowphase (component-major or row-major)
and the classic broadphase + narrowphase, each with an optional static
trimesh (the dense pipeline hands a mesh step to the classic one, as the
JAX step does) and an optional ``JointSet`` (``ops/joints.py``), whose
connected pairs every pair phase excludes and whose rows the solver
relaxes beside the contacts. Every function takes a batch of worlds
``(B, …)``; the JAX package's ``vmap`` is the leading world axis here, and
a diagnostics counter is a (B,) tensor, one value per world.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops import broadphase, dense, integrator
from rl_ode_physics_tpu_torch.ops import joints as joint_ops
from rl_ode_physics_tpu_torch.ops import narrowphase
from rl_ode_physics_tpu_torch.ops import solver as solver_ops
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh, mesh_narrowphase


def step(state: WorldState, config: EngineConfig,
         trimesh: TriMesh | None = None, joints=None) -> WorldState:
    """One fixed substep for every world of the batch.

    Contacts come from the current positions; forces and gravity advance
    the velocities, the solver corrects them, positions integrate with the
    corrected velocities. Pairs and contacts dropped at a full capacity
    accumulate on ``state.overflow``. ``trimesh``: an optional static mesh,
    shared by every world, whose contacts merge into the same rows; its
    sweep runs the hand-written kernel on CUDA tensors. ``joints``: an
    optional ``ops.joints.JointSet`` of bilateral constraints.
    """
    config.validate()
    return _step_impl(state, config, trimesh, joints=joints)


def step_with_diagnostics(state: WorldState, config: EngineConfig,
                          trimesh: TriMesh | None = None, joints=None):
    """``step`` that also returns the per-tick counters of every world:
    (state, {name: (B,) tensor}). The same ``_step_impl`` as ``step``, so
    diagnostics never run another pipeline. Counters: ``num_pairs``,
    ``num_contacts``, ``pair_overflow``, ``contact_overflow`` (int32),
    ``max_penetration``, ``kinetic_energy`` (the state's dtype) and
    ``num_bodies`` (int32); with joints under JACOBI also
    ``joint_force_a``, ``joint_torque_a``, ``joint_force_b`` and
    ``joint_torque_b`` (B, J, 3), ODE's joint feedback."""
    config.validate()
    return _step_impl(state, config, trimesh, with_metrics=True,
                      joints=joints)


def _step_impl(state: WorldState, config: EngineConfig,
               trimesh: TriMesh | None, with_metrics: bool = False,
               joints=None):
    if config.dense_pipeline and trimesh is None:
        # the dense pipeline has its own positional solve and no joints
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

    exclude = None
    if joints is not None:
        exclude = joint_ops.connected_mask(joints, state.num_slots)
    extra = None
    if trimesh is not None:
        extra = mesh_narrowphase(state, trimesh, config)
    if config.typed_buckets:
        # bucket drops are folded into contacts.overflow
        contacts, num_pairs = narrowphase.narrowphase_typed(
            state, config, extra, exclude=exclude)
        pair_overflow = torch.zeros_like(state.overflow)
    else:
        cand = broadphase.broadphase(state, config, exclude=exclude)
        contacts = narrowphase.narrowphase(state, cand, config, extra)
        num_pairs, pair_overflow = cand.count, cand.overflow
    joints_rows = None
    if joints is not None:
        joints_rows = joint_ops.joint_rows(state, joints, config)
    # dropped pairs and rows accumulate on the state itself
    state = state.replace(
        overflow=state.overflow + contacts.overflow + pair_overflow)
    state = integrator.apply_external_forces(state, config)
    joint_fb = None
    if (joints_rows is not None and with_metrics
            and config.solver is SolverKind.JACOBI):
        # joint feedback from the solved joint impulses
        state, jlam = solver_ops.solve_jacobi(
            state, contacts, config, joints_rows=joints_rows,
            return_joint_lam=True)
        joint_fb = joint_ops.feedback(joints_rows, jlam, config.dt)
    else:
        state = solver_ops.solve(state, contacts, config, joints_rows)
    state = integrator.integrate_positions(state, config)
    if not with_metrics:
        return state
    if not torch.is_tensor(num_pairs):        # no bucket enabled
        num_pairs = torch.full_like(state.overflow, num_pairs)
    metrics = _base_metrics(
        state,
        num_pairs=num_pairs.to(torch.int32),
        num_contacts=contacts.count,
        pair_overflow=pair_overflow.to(torch.int32),
        contact_overflow=contacts.overflow,
        max_penetration=torch.where(contacts.valid, contacts.depth,
                                    0.0).amax(1))
    if joint_fb is not None:
        metrics.update({f"joint_{k}": v for k, v in joint_fb.items()})
    return state, metrics


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
                 trimesh: TriMesh | None = None, joints=None):
    """A function state → state that runs ``substeps`` substeps, with
    ``trimesh`` as static scene geometry and ``joints`` as the joint table
    when given."""
    config.validate()
    if substeps < 1:
        raise ValueError(f"substeps={substeps} must be at least 1")

    def fn(state: WorldState) -> WorldState:
        for _ in range(substeps):
            state = _step_impl(state, config, trimesh, joints=joints)
        return state

    return fn
