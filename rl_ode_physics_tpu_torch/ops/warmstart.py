"""Opt-in warm starting: impulses cached across substeps.

The port of ``rl_ode_physics_tpu/ops/warmstart.py``. The default step keeps
ODE's transient contacts and cold-starts its solver; this module is the
opt-in alternative. Each substep's accumulated impulses are cached, keyed
on the stable contact identity ``Contacts.key`` ((ia·N + ib)·K + manifold
slot), and re-applied as the next substep's initial guess. Mesh rows carry
key −1 and always cold-start: their buffer position is a deepest-k rank,
not a feature identity. Matching is a batched (C_new, C_old) one-hot
key-equality product, no scatter and no sort.

Usage::

    cache = warmstart.init_cache(config, num_worlds, device=...)
    step = warmstart.make_warm_step_fn(config)
    state, cache = step(state, cache)
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts


@dataclasses.dataclass
class WarmCache:
    """Per-world impulse cache from the previous substep's solve."""

    key: torch.Tensor   # (B, C) int32 contact identities (−1 = empty row)
    lam: torch.Tensor   # (B, C, 3) accumulated (normal, t1, t2) impulses


def init_cache(config: EngineConfig, num_worlds: int = 1,
               dtype=torch.float32, device="cuda") -> WarmCache:
    """An empty cache: every key −1, every impulse 0."""
    c = config.max_contacts
    return WarmCache(
        key=torch.full((num_worlds, c), -1, dtype=torch.int32, device=device),
        lam=torch.zeros((num_worlds, c, 3), dtype=dtype, device=device))


def match_lam(cache: WarmCache, contacts: Contacts) -> torch.Tensor:
    """(B, C_new, 3) initial impulses: the cached λ where the contact
    identity persists, zero for new contacts. One one-hot product a world;
    each new key matches at most one cached key, so the product is exact."""
    new_key = contacts.key
    hit = ((new_key[:, :, None] == cache.key[:, None, :])
           & (new_key[:, :, None] >= 0))                  # (B, Cn, Co)
    return torch.bmm(hit.to(cache.lam.dtype), cache.lam)


def make_warm_step_fn(config: EngineConfig, trimesh=None):
    """(state, cache) → (state, cache): one substep with warm starting.

    The pipeline of the JAX package's warm step: the classic broadphase
    and narrowphase whatever ``typed_buckets`` says, the mesh rows of
    ``trimesh`` appended, the solver (PGS or JACOBI) started from the
    matched cached impulses, the cache refreshed from the solve. Like the
    JAX warm step it leaves ``state.overflow`` as it was.
    """
    from rl_ode_physics_tpu_torch.ops import broadphase, integrator
    from rl_ode_physics_tpu_torch.ops import narrowphase as np_ops
    from rl_ode_physics_tpu_torch.ops import solver as solver_ops
    from rl_ode_physics_tpu_torch.ops.trimesh import mesh_narrowphase

    if config.solver not in (SolverKind.PGS, SolverKind.JACOBI):
        raise ValueError("warm starting supports PGS and JACOBI solvers")
    config.validate()
    solve = (solver_ops.solve_pgs if config.solver is SolverKind.PGS
             else solver_ops.solve_jacobi)

    def step(state: WorldState, cache: WarmCache):
        cand = broadphase.broadphase(state, config)
        extra = None
        if trimesh is not None:
            extra = mesh_narrowphase(state, trimesh, config)
        contacts = np_ops.narrowphase(state, cand, config, extra)
        state = integrator.apply_external_forces(state, config)
        lam0 = match_lam(cache, contacts)
        state, lam = solve(state, contacts, config, lam0=lam0,
                           return_lam=True)
        state = integrator.integrate_positions(state, config)
        return state, WarmCache(key=contacts.key, lam=lam)

    return step
