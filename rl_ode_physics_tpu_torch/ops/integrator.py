"""Semi-implicit (symplectic) Euler integrator.

The port of ``rl_ode_physics_tpu/ops/integrator.py``: velocities absorb
external forces and gravity, the solver corrects them, positions advance
with the corrected velocities. Masked elementwise math over ``(B, N, …)``.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState, similarity_diag
from rl_ode_physics_tpu_torch.utils import graphs
from rl_ode_physics_tpu_torch.utils import quat as quat_m


def apply_external_forces(state: WorldState,
                          config: EngineConfig) -> WorldState:
    """v ← v + dt·(g + M⁻¹f);  ω ← ω + dt·I⁻¹(τ − ω×(Iω)).

    Gravity applies to dynamic, non-kinematic bodies only; ω×(Iω) is ODE's
    default gyroscopic term.
    """
    dt = config.dt
    dyn = (state.dynamic & ~state.is_kinematic)[..., None]

    g = graphs.constant(tuple(config.gravity), state.pos.dtype,
                        state.device)
    linvel = state.linvel + dt * (
        torch.where(dyn, g, 0.0) + state.inv_mass[..., None] * state.force
    )

    r = quat_m.to_matrix(state.quat)
    inv_i_world = similarity_diag(r, state.inv_inertia)
    i_body = torch.where(state.inv_inertia > 0,
                         1.0 / torch.clamp_min(state.inv_inertia, 1e-30), 0.0)
    i_world = similarity_diag(r, i_body)

    ang_mom = torch.sum(i_world * state.angvel[..., None, :], dim=-1)
    gyro = torch.linalg.cross(state.angvel, ang_mom, dim=-1)
    torque = state.torque - gyro
    angvel = state.angvel + dt * torch.sum(
        inv_i_world * torque[..., None, :], dim=-1)
    return state.replace(linvel=linvel, angvel=angvel)


def integrate_positions(state: WorldState,
                        config: EngineConfig) -> WorldState:
    """x ← x + dt·v;  q ← normalize(q + dt/2·ω⊗q). Clears the force
    accumulators and advances ``tick``."""
    dt = config.dt
    moving = (state.active & ~state.is_static)[..., None]

    pos = state.pos + torch.where(moving, dt * state.linvel, 0.0)
    new_quat = quat_m.integrate(state.quat, state.angvel, dt)
    quat = torch.where(moving, new_quat, state.quat)

    return state.replace(
        pos=pos,
        quat=quat,
        force=torch.zeros_like(state.force),
        torque=torch.zeros_like(state.torque),
        tick=state.tick + 1,
    )
