"""Broadphase: world-frame AABBs, the pair tests and the classic
candidate list.

The port of ``rl_ode_physics_tpu/ops/broadphase.py``. A pair (i, j), i < j,
is tested iff both slots are active, at least one is movable, neither is a
trimesh, ODE's category/collide filter ``(cat_i & col_j) || (cat_j &
col_i)`` passes, the AABBs overlap and no joint connects them. The classic
pipeline compacts the surviving pairs of each world into
``max_pair_candidates`` slots; the typed narrowphase bucket-compacts the
same mask itself.
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.ops.compaction import compact_mask
from rl_ode_physics_tpu_torch.utils import quat as quat_m


@dataclasses.dataclass
class PairCandidates:
    """Static-capacity broadphase output, CP candidates per world."""

    ia: torch.Tensor        # (B, CP) int32 first body slot of the pair
    ib: torch.Tensor        # (B, CP) int32 second body slot (ia < ib)
    valid: torch.Tensor     # (B, CP) bool
    count: torch.Tensor     # (B,) int32 valid candidates (<= CP)
    overflow: torch.Tensor  # (B,) int32 pairs dropped at capacity


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


def pair_filter(state: WorldState) -> torch.Tensor:
    """(B, N, N) the pair tests other than AABB overlap: upper triangle,
    both active, ODE's category/collide filter, at least one movable
    (a contact between two infinite-mass bodies has no impulse), no
    trimesh slot (those collide through the mesh narrowphase)."""
    n = state.num_slots
    cat, col = state.category, state.collide
    mask_ok = (((cat[:, :, None] & col[:, None, :]) != 0)
               | ((cat[:, None, :] & col[:, :, None]) != 0))
    active = state.active
    movable = state.inv_mass > 0
    not_mesh = state.body_type != int(BodyType.TRIMESH)
    idx = torch.arange(n, device=state.device)
    upper = idx[:, None] < idx[None, :]
    return (mask_ok & (active[:, :, None] & active[:, None, :])
            & (movable[:, :, None] | movable[:, None, :])
            & (not_mesh[:, :, None] & not_mesh[:, None, :]) & upper)


def pair_mask(state: WorldState, margin: float = 0.0,
              exclude=None) -> torch.Tensor:
    """(B, N, N) pairs to test: AABB overlap and ``pair_filter``, less the
    joint-connected pairs of ``exclude`` ((N, N) or (B, N, N) bool, ODE's
    ``dAreConnected``)."""
    aabb = compute_aabbs(state, margin)
    lo, hi = aabb[..., 0, :], aabb[..., 1, :]
    overlap = torch.all(
        (lo[:, :, None, :] <= hi[:, None, :, :])
        & (lo[:, None, :, :] <= hi[:, :, None, :]), dim=-1)
    hit = overlap & pair_filter(state)
    if exclude is not None:
        hit = hit & ~exclude
    return hit


def broadphase(state: WorldState, config: EngineConfig, margin: float = 0.0,
               exclude=None) -> PairCandidates:
    """The pairs of ``pair_mask`` of each world, compacted in flat (i·N + j)
    order into ``max_pair_candidates`` slots; pairs past the capacity are
    counted in ``overflow``."""
    n = state.num_slots
    hit = pair_mask(state, margin, exclude).reshape(state.num_worlds, n * n)
    idx, valid, count, overflow = compact_mask(hit,
                                               config.max_pair_candidates)
    return PairCandidates(ia=torch.where(valid, idx // n, 0),
                          ib=torch.where(valid, idx % n, 0),
                          valid=valid, count=count, overflow=overflow)
