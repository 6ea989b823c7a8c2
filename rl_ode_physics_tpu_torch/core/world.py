"""The substep: collide, apply forces, solve, integrate.

The port of ``rl_ode_physics_tpu/core/world.py:_step_impl`` (``:262-336``)
and of ``make_step_fn`` (``:369-410``), every pipeline of the JAX step:
the dense pipeline, the typed narrowphase (component-major or row-major)
and the classic broadphase + narrowphase, each with an optional static
trimesh (the dense pipeline hands a mesh step to the classic one, as the
JAX step does). Every function takes a batch of worlds ``(B, …)``; the JAX
package's ``vmap`` is the leading world axis here.
"""

from __future__ import annotations

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops import broadphase, dense, integrator
from rl_ode_physics_tpu_torch.ops import narrowphase
from rl_ode_physics_tpu_torch.ops import solver as solver_ops
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh, mesh_narrowphase


def _check_supported(config: EngineConfig, trimesh=None) -> None:
    """Raise for a config whose step the port does not have yet: the
    solvers other than JACOBI, its component-major loop and bf16 selector
    products (a dense step without a mesh runs its own solver)."""
    config.validate()
    if config.dense_pipeline and trimesh is None:
        return
    if config.solver is not SolverKind.JACOBI:
        raise NotImplementedError(
            f"solver {config.solver.value!r} is not ported (JACOBI only)")
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


def _step_impl(state: WorldState, config: EngineConfig,
               trimesh: TriMesh | None) -> WorldState:
    if config.dense_pipeline and trimesh is None:
        manifold = dense.dense_narrowphase(state, config)
        state = integrator.apply_external_forces(state, config)
        state = dense.dense_solve(state, manifold, config)
        return integrator.integrate_positions(state, config)

    extra = None
    if trimesh is not None:
        extra = mesh_narrowphase(state, trimesh, config)
    if config.typed_buckets:
        # bucket drops are folded into contacts.overflow
        contacts, _ = narrowphase.narrowphase_typed(state, config, extra)
        pair_overflow = 0
    else:
        cand = broadphase.broadphase(state, config)
        contacts = narrowphase.narrowphase(state, cand, config, extra)
        pair_overflow = cand.overflow
    # dropped pairs and rows accumulate on the state itself
    state = state.replace(
        overflow=state.overflow + contacts.overflow + pair_overflow)
    state = integrator.apply_external_forces(state, config)
    state = solver_ops.solve(state, contacts, config)
    return integrator.integrate_positions(state, config)


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
