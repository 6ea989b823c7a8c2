"""Contact rows, the pair-type table and pair eligibility.

The port of the parts of ``rl_ode_physics_tpu/ops/narrowphase.py`` that the
typed component-major path uses (``:86``, ``:666-763``). Conventions: the
contact normal points from body a toward body b; ``depth > 0`` is
penetration.
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.ops.broadphase import compute_aabbs


@dataclasses.dataclass
class Contacts:
    """Static-capacity contact rows for the solver, C rows per world."""

    point: torch.Tensor     # (B, C, 3) f32
    normal: torch.Tensor    # (B, C, 3) f32, from body a toward body b
    depth: torch.Tensor     # (B, C) f32
    a: torch.Tensor         # (B, C) int32 body slot
    b: torch.Tensor         # (B, C) int32 body slot
    valid: torch.Tensor     # (B, C) bool
    count: torch.Tensor     # (B,) int32
    overflow: torch.Tensor  # (B,) int32 — rows dropped at capacity
    # stable identity (a·N + b)·K + manifold slot; −1 when invalid
    key: torch.Tensor       # (B, C) int32


_SPHERE, _BOX = int(BodyType.SPHERE), int(BodyType.BOX)
_CAPSULE, _PLANE = int(BodyType.CAPSULE), int(BodyType.PLANE)

# canonical (type_a <= type_b) pairs in the JAX package's table order
_PAIR_TYPES = (
    (_SPHERE, _SPHERE), (_SPHERE, _BOX), (_SPHERE, _CAPSULE),
    (_SPHERE, _PLANE), (_BOX, _BOX), (_BOX, _CAPSULE), (_BOX, _PLANE),
    (_CAPSULE, _CAPSULE), (_CAPSULE, _PLANE),
)

# intrinsic manifold capacity per pair kernel
_KERNEL_K = {
    (_SPHERE, _SPHERE): 1,
    (_SPHERE, _BOX): 1,
    (_SPHERE, _CAPSULE): 1,
    (_SPHERE, _PLANE): 1,
    (_BOX, _BOX): 8,
    (_BOX, _CAPSULE): 3,
    (_BOX, _PLANE): 8,
    (_CAPSULE, _CAPSULE): 2,
    (_CAPSULE, _PLANE): 2,
}


def _enabled_kernels(config: EngineConfig):
    """The canonical pair types the config enables, in table order.

    The port has the sphere and box kernels only: a config that enables
    capsules or planes, or asks for exact box clipping, raises.
    """
    if config.exact_box_clip:
        raise NotImplementedError(
            "exact_box_clip (Sutherland-Hodgman box clipping) is not ported")
    if config.enable_capsules or config.enable_planes:
        raise NotImplementedError(
            "the port has the sphere/box pair kernels only: set "
            "enable_capsules=False and enable_planes=False")
    return [p for p in _PAIR_TYPES
            if _CAPSULE not in p and _PLANE not in p]


def _pair_eligibility(state: WorldState):
    """(B, N, N) eligibility mask (AABB overlap, ODE category/collide
    filter, both active, at least one movable, no trimesh, upper triangle)
    plus the canonical per-pair type codes tmin/tmax."""
    n = state.num_slots
    aabb = compute_aabbs(state)
    lo, hi = aabb[..., 0, :], aabb[..., 1, :]
    overlap = torch.all(
        (lo[:, :, None, :] <= hi[:, None, :, :])
        & (lo[:, None, :, :] <= hi[:, :, None, :]), dim=-1)
    cat, col = state.category, state.collide
    mask_ok = (((cat[:, :, None] & col[:, None, :]) != 0)
               | ((cat[:, None, :] & col[:, :, None]) != 0))
    active = state.active
    movable = state.inv_mass > 0
    not_mesh = state.body_type != int(BodyType.TRIMESH)
    idx = torch.arange(n, device=state.device)
    upper = idx[:, None] < idx[None, :]
    hit = (overlap & mask_ok & (active[:, :, None] & active[:, None, :])
           & (movable[:, :, None] | movable[:, None, :])
           & (not_mesh[:, :, None] & not_mesh[:, None, :]) & upper)
    t = state.body_type
    tmin = torch.minimum(t[:, :, None], t[:, None, :])
    tmax = torch.maximum(t[:, :, None], t[:, None, :])
    return hit, tmin, tmax
