"""World-frame AABBs for the pair eligibility test.

The port of ``rl_ode_physics_tpu/ops/broadphase.py:compute_aabbs``.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.utils import quat as quat_m


def compute_aabbs(state: WorldState, margin: float = 0.0) -> torch.Tensor:
    """(B, N, 2, 3) world-frame AABBs (min, max) for every slot.

    Box extents use the |R|·h bound; capsules their local box (r, r, L/2+r)
    through |R|; planes and trimeshes a huge box. NULL slots get an inverted
    box, so they overlap nothing.
    """
    r = quat_m.to_matrix(state.quat)           # (B, N, 3, 3)
    abs_r = torch.abs(r)
    t = state.body_type[..., None]
    sz = state.size

    half_sphere = sz[..., 0:1].expand(sz.shape)
    half_box = 0.5 * sz
    cap_r, cap_l = sz[..., 0], sz[..., 1]
    half_capsule = torch.stack([cap_r, cap_r, 0.5 * cap_l + cap_r], dim=-1)
    big = torch.full_like(sz, 1e9)

    half_local = torch.where(
        t == int(BodyType.SPHERE), half_sphere,
        torch.where(
            t == int(BodyType.BOX), half_box,
            torch.where(
                t == int(BodyType.CAPSULE), half_capsule,
                torch.where((t == int(BodyType.PLANE))
                            | (t == int(BodyType.TRIMESH)),
                            big, torch.zeros_like(sz)))))

    ext = torch.sum(abs_r * half_local[..., None, :], dim=-1) + margin
    lo = state.pos - ext
    hi = state.pos + ext
    null = t == int(BodyType.NULL)
    lo = torch.where(null, 1.0, lo)
    hi = torch.where(null, -1.0, hi)
    return torch.stack([lo, hi], dim=-2)
