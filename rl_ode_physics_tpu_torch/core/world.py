"""The substep: collide, apply forces, solve, integrate.

The port of ``rl_ode_physics_tpu/core/world.py:_step_impl`` (``:262-336``) on
the typed component-major path, and of ``make_step_fn`` (``:369-410``).
Every function takes a batch of worlds ``(B, …)``; the JAX package's
``vmap`` is the leading world axis here.
"""

from __future__ import annotations

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops import integrator
from rl_ode_physics_tpu_torch.ops import narrowphase_cm
from rl_ode_physics_tpu_torch.ops import solver as solver_ops


def _check_supported(config: EngineConfig) -> None:
    """Raise for a config whose step the port does not have."""
    config.validate()
    if config.dense_pipeline:
        raise NotImplementedError("the dense pipeline is not ported")
    if not config.typed_buckets or not config.cm_narrowphase:
        raise NotImplementedError(
            "the port steps through the typed component-major narrowphase "
            "only (typed_buckets=True, cm_narrowphase=True)")


def step(state: WorldState, config: EngineConfig) -> WorldState:
    """One fixed substep for every world of the batch.

    Contacts come from the current positions; forces and gravity advance
    the velocities, the solver corrects them, positions integrate with the
    corrected velocities. Pairs and contacts dropped at a full capacity
    accumulate on ``state.overflow``.
    """
    _check_supported(config)
    return _step_impl(state, config)


def _step_impl(state: WorldState, config: EngineConfig) -> WorldState:
    contacts, _ = narrowphase_cm.narrowphase_typed_cm(state, config)
    state = state.replace(overflow=state.overflow + contacts.overflow)
    state = integrator.apply_external_forces(state, config)
    state = solver_ops.solve(state, contacts, config)
    return integrator.integrate_positions(state, config)


def make_step_fn(config: EngineConfig, substeps: int = 1):
    """A function state → state that runs ``substeps`` substeps."""
    _check_supported(config)
    if substeps < 1:
        raise ValueError(f"substeps={substeps} must be at least 1")

    def fn(state: WorldState) -> WorldState:
        for _ in range(substeps):
            state = _step_impl(state, config)
        return state

    return fn
