"""Dense all-pairs pipeline: no candidate list, no compaction, no capacity.

The port of ``rl_ode_physics_tpu/ops/dense.py`` (``EngineConfig.
dense_pipeline``). The narrowphase evaluates every (i, j) body pair of a
world as an (N, N, K) manifold by broadcasting, the pair tests masking all
but the upper triangle's eligible pairs; the solver's contact↔body data
movement is broadcasting and row/column sums, since a contact at (i, j)
acts on bodies i and j by its position in the grid. Memory is O(N²K) per
world: ``parallel.batch.make_batched_step_fn`` refuses a batch whose
intermediates would not fit on the card.

The JAX package keeps this pipeline as an independent cross-check of the
sparse paths (no compaction, no selectors, no caps), and so does the port.
"""

from __future__ import annotations

import math

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState, world_inv_inertia
from rl_ode_physics_tpu_torch.ops.broadphase import pair_filter
from rl_ode_physics_tpu_torch.ops.pair_kernels import (
    _enabled_kernels, collide_pair)
from rl_ode_physics_tpu_torch.ops.solver import _tangent_basis

# (B, N, N, K, 3) f32 tensors' worth of memory that a dense substep holds
# at its peak, for the memory check of parallel.batch: 28.05 measured on
# the card at 4 worlds x 12 slots, K=8 (chip_smoke.py), rounded up
LIVE_PAIR_TENSORS = 30


def dense_narrowphase(state: WorldState, config: EngineConfig):
    """(B, N, N, K) manifolds of every body pair (i, j): point, normal
    (i → j), depth, valid."""
    b, n = state.num_worlds, state.num_slots

    def rows(x):                           # body i along axis 1
        return x[:, :, None].expand((b, n, n) + x.shape[2:])

    def cols(x):                           # body j along axis 2
        return x[:, None, :].expand((b, n, n) + x.shape[2:])

    points, normals, depths, valid = collide_pair(
        rows(state.pos), rows(state.quat), rows(state.body_type),
        rows(state.size), cols(state.pos), cols(state.quat),
        cols(state.body_type), cols(state.size),
        config.max_contacts_per_pair, _enabled_kernels(config))
    return points, normals, depths, valid & pair_filter(state)[..., None]


def dense_solve(state: WorldState, manifold, config: EngineConfig
                ) -> WorldState:
    """Mass-splitting projected Jacobi on the (B, N, N, K) manifold: the
    math of ``solver.solve_jacobi`` (plain Jacobi, no momentum) with
    positional connectivity."""
    points, normals, depths, valid = manifold
    f = state.linvel.dtype
    dt = config.dt
    validf = valid.to(f)

    inv_m = state.inv_mass                                # (B, N)
    inv_i = world_inv_inertia(state)                      # (B, N, 3, 3)
    pos = state.pos
    r_a = points - pos[:, :, None, None, :]               # arm at body i
    r_b = points - pos[:, None, :, None, :]               # arm at body j

    n_ax = normals
    t1_ax, t2_ax = _tangent_basis(n_ax)

    def matvec_i(m, v):
        return torch.sum(m[:, :, None, None, :, :] * v[..., None, :], -1)

    def matvec_j(m, v):
        return torch.sum(m[:, None, :, None, :, :] * v[..., None, :], -1)

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    def eff_mass(axis):
        rxn_a = cross(r_a, axis)
        rxn_b = cross(r_b, axis)
        ang_a = matvec_i(inv_i, rxn_a)
        ang_b = matvec_j(inv_i, rxn_b)
        return (inv_m[:, :, None, None] + inv_m[:, None, :, None]
                + torch.sum(rxn_a * ang_a, -1) + torch.sum(rxn_b * ang_b, -1))

    cfm_term = config.cfm / dt
    # mass splitting: live contacts per body
    kappa = torch.clamp_min(torch.sum(validf, dim=(2, 3))
                            + torch.sum(validf, dim=(1, 3)), 1.0)
    split = torch.maximum(kappa[:, :, None, None], kappa[:, None, :, None])

    d_n = eff_mass(n_ax) * split + cfm_term
    d_t1 = eff_mass(t1_ax) * split + cfm_term
    d_t2 = eff_mass(t2_ax) * split + cfm_term

    def rel_v(linvel, angvel, axis, rxn_a, rxn_b):
        dlin = linvel[:, None, :, None, :] - linvel[:, :, None, None, :]
        return (torch.sum(dlin * axis, -1)
                + torch.sum(angvel[:, None, :, None, :] * rxn_b, -1)
                - torch.sum(angvel[:, :, None, None, :] * rxn_a, -1))

    rxn_a_n, rxn_b_n = cross(r_a, n_ax), cross(r_b, n_ax)
    rxn_a_1, rxn_b_1 = cross(r_a, t1_ax), cross(r_b, t1_ax)
    rxn_a_2, rxn_b_2 = cross(r_a, t2_ax), cross(r_b, t2_ax)

    # rhs: ERP bias capped, bounce from the pre-solve normal velocity
    v_n0 = rel_v(state.linvel, state.angvel, n_ax, rxn_a_n, rxn_b_n)
    bias = torch.clamp_max(config.erp * depths / dt, config.max_correcting_vel)
    bounce = torch.where(-v_n0 > config.bounce_vel, -config.bounce * v_n0, 0.0)
    target = torch.where(valid, torch.maximum(bias, bounce), 0.0)

    omega = config.jacobi_omega
    mu_inf = math.isinf(config.mu)
    linvel, angvel = state.linvel, state.angvel
    lam_n = lam_1 = lam_2 = torch.zeros(valid.shape, dtype=f,
                                        device=state.device)
    for _ in range(config.solver_iterations):
        # residuals include ODE's CFM softening −cfm/h·λ
        dl_n = omega * (target - rel_v(linvel, angvel, n_ax, rxn_a_n, rxn_b_n)
                        - cfm_term * lam_n) / d_n
        new_n = torch.clamp_min(lam_n + dl_n, 0.0)
        dl_n = torch.where(valid, new_n - lam_n, 0.0)
        lam_n = lam_n + dl_n

        if config.friction:
            bound = (torch.full_like(lam_n, torch.inf) if mu_inf
                     else config.mu * lam_n)
            dl_1 = omega * (-rel_v(linvel, angvel, t1_ax, rxn_a_1, rxn_b_1)
                            - cfm_term * lam_1) / d_t1
            new_1 = torch.clamp(lam_1 + dl_1, -bound, bound)
            dl_1 = torch.where(valid, new_1 - lam_1, 0.0)
            lam_1 = lam_1 + dl_1

            dl_2 = omega * (-rel_v(linvel, angvel, t2_ax, rxn_a_2, rxn_b_2)
                            - cfm_term * lam_2) / d_t2
            new_2 = torch.clamp(lam_2 + dl_2, -bound, bound)
            dl_2 = torch.where(valid, new_2 - lam_2, 0.0)
            lam_2 = lam_2 + dl_2
            imp = (n_ax * dl_n[..., None] + t1_ax * dl_1[..., None]
                   + t2_ax * dl_2[..., None])             # (B, N, N, K, 3)
        else:
            imp = n_ax * dl_n[..., None]

        # body ← contact by position: row sums take the −imp side (body i),
        # column sums the +imp side (body j)
        dlin = (inv_m[..., None] * (torch.sum(imp, dim=(2, 3)) * -1.0)
                + inv_m[..., None] * torch.sum(imp, dim=(1, 3)))
        torque = (torch.sum(cross(r_a, -imp), dim=(2, 3))
                  + torch.sum(cross(r_b, imp), dim=(1, 3)))   # (B, N, 3)
        dang = torch.sum(inv_i * torque[:, :, None, :], -1)
        linvel, angvel = linvel + dlin, angvel + dang
    return state.replace(linvel=linvel, angvel=angvel)
