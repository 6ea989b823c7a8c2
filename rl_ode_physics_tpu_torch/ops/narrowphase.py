"""Narrowphase: contact rows and the classic and row-major typed
pipelines.

The port of ``rl_ode_physics_tpu/ops/narrowphase.py``; its pair kernels and
``collide_pair`` are in ``ops/pair_kernels.py``.

Pipelines:
* ``narrowphase``: the classic path, after ``broadphase.broadphase``: each
  candidate's manifold from ``collide_kernel.collide_pairs`` (on the card
  one hand kernel running each candidate's own pair kernel; on the CPU
  every enabled kernel on every candidate, selected by type); rows keep
  global pair order; compaction by ``compaction.compact_rows``, which the
  JAX package also runs outside any kernel.
* ``narrowphase_typed``: one candidate list per pair type, each running
  only its own kernel at its own manifold size. It hands over to the
  component-major twin (``ops/narrowphase_cm.py``) when that covers the
  config; its own row-major body serves ``exact_box_clip``, manifold sizes
  that need a deepest-k pick and ``cm_narrowphase=False``. Its contact
  compaction is the hand-written kernel on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, jnp_dtype_is_bf16
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops import (
    collide_kernel, compaction, compaction_kernel)
from rl_ode_physics_tpu_torch.ops.broadphase import PairCandidates, pair_mask
from rl_ode_physics_tpu_torch.ops.pair_kernels import (
    _KERNEL_K, _collide_rows, _enabled_kernels, _gather_rows)
from rl_ode_physics_tpu_torch.utils import tracing


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


# ---------------------------------------------------------------------------
# Pair eligibility and the pipelines
# ---------------------------------------------------------------------------

def _pair_eligibility(state: WorldState, exclude=None):
    """(B, N, N) pairs to test (``broadphase.pair_mask``, less the
    joint-connected pairs of ``exclude``) plus the canonical per-pair type
    codes tmin/tmax."""
    hit = pair_mask(state, exclude=exclude)
    t = state.body_type
    tmin = torch.minimum(t[:, :, None], t[:, None, :])
    tmax = torch.maximum(t[:, :, None], t[:, None, :])
    return hit, tmin, tmax


def _check_key_space(n: int, k: int) -> None:
    if n * n * k >= 2 ** 24:
        raise ValueError(
            f"contact-key space {n * n * k} (max_bodies={n}, K={k}) exceeds "
            f"the f32 exact-integer range 2^24")


def _selector_dtype(config: EngineConfig, n: int, state_dtype):
    """The dtype the typed paths round their feature table and payload to,
    as the JAX package's selector matmuls in ``selector_dtype`` do; None
    where it is the state's own dtype (no rounding). A float64 state with
    float32 selectors rounds to float32, as the JAX package does."""
    if jnp_dtype_is_bf16(config.selector_dtype):
        if n > 256:
            raise ValueError(
                "selector_dtype='bfloat16' requires max_bodies <= 256")
        return torch.bfloat16
    dtype = getattr(torch, str(config.selector_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"selector_dtype={config.selector_dtype!r} is not "
                         f"a floating-point dtype")
    return None if dtype == state_dtype else dtype


def _bucket_pairs(mask: torch.Tensor, cap: int):
    """The first ``cap`` set entries of each world's (R, C) pair mask in
    row-major order → (row (B, cap), col (B, cap), bvalid, count,
    overflow): the pairs the JAX package's closed-form bucket compaction
    selects; row and col are 0 where not valid."""
    b, _, c = mask.shape
    idx, bvalid, count, overflow = compaction.compact_mask(
        mask.reshape(b, -1), cap)
    return idx // c, idx % c, bvalid, count, overflow


def _compact_typed(packed_t, flat_valid, extra, config: EngineConfig, n: int,
                   sel, overflow) -> Contacts:
    """The typed paths' tail: mesh rows of ``extra`` appended with slot −1,
    the (B, 10, M) payload rounded to the selector dtype ``sel`` and
    compacted into ``max_contacts`` rows (the hand-written kernel on CUDA
    tensors), keys recomputed in int32;
    ``overflow`` adds the bucket (and window) drops to the row drops."""
    f = packed_t.dtype
    if extra is not None:
        # mesh rows: slot −1 → key −1, excluded from warm-start matching
        e_pts, e_nrm, e_dep, e_a, e_b, e_val = extra
        e_packed_t = torch.cat([
            e_pts.transpose(1, 2), e_nrm.transpose(1, 2), e_dep[:, None],
            e_a.to(f)[:, None], e_b.to(f)[:, None],
            torch.full_like(e_dep, -1.0)[:, None],
        ], dim=1)                                             # (B, 10, R)
        packed_t = torch.cat([packed_t, e_packed_t], dim=2)
        flat_valid = torch.cat([flat_valid, e_val], dim=1)

    k_glob = config.max_contacts_per_pair
    if sel not in (None, torch.bfloat16, torch.float32):
        # the kernel rounds to bf16 and float32 itself; another dtype
        # rounds here
        packed_t, sel = compaction.round_to(packed_t, sel), None
    tracing.count("candidate_rows", flat_valid,
                  also=("candidate_slots", flat_valid.numel()))
    rows_t, cvalid, count, row_overflow = compaction_kernel.compact_rows_t(
        flat_valid, packed_t, config.max_contacts, sel_dtype=sel)
    a_out = rows_t[:, 7].to(torch.int32)
    b_out = rows_t[:, 8].to(torch.int32)
    slot_out = torch.round(rows_t[:, 9]).to(torch.int32)
    key = torch.where(cvalid & (slot_out >= 0),
                      (a_out * n + b_out) * k_glob + slot_out, -1)
    return Contacts(
        point=rows_t[:, 0:3].transpose(1, 2).contiguous(),
        normal=rows_t[:, 3:6].transpose(1, 2).contiguous(),
        depth=rows_t[:, 6].contiguous(),
        a=a_out, b=b_out, valid=cvalid, count=count,
        overflow=row_overflow + overflow, key=key)


def _features(state: WorldState) -> torch.Tensor:
    """(B, N, 11) pos ‖ quat ‖ size ‖ type."""
    return torch.cat([state.pos, state.quat, state.size,
                      state.body_type.to(state.pos.dtype)[..., None]], -1)


def narrowphase_typed(state: WorldState, config: EngineConfig, extra=None,
                      exclude=None):
    """Typed-bucket narrowphase: (Contacts, pairs tested per world).

    One compacted candidate list per pair type, each through its own
    kernel at min(its slots, K) rows a pair; rows come out grouped by
    bucket, pair-major within one. When ``cm_narrowphase`` is on and the
    component-major twin covers every bucket, that twin runs instead.
    ``extra``: the trimesh narrowphase's rows; ``exclude``: (N, N) or
    (B, N, N) joint-connected pairs, never tested.
    """
    if config.cm_narrowphase:
        from rl_ode_physics_tpu_torch.ops import narrowphase_cm
        if narrowphase_cm.supports_cm(config):
            return narrowphase_cm.narrowphase_typed_cm(state, config, extra,
                                                       exclude)
    if config.sap_window:
        raise ValueError(
            "sap_window is implemented in the component-major typed path "
            "only; this config falls back to the row-major narrowphase "
            "(exact_box_clip or an un-CM-able manifold size)")
    n = state.num_slots
    k_glob = config.max_contacts_per_pair
    f = state.pos.dtype
    _check_key_space(n, k_glob)
    sel = _selector_dtype(config, n, f)

    hit, tmin, tmax = _pair_eligibility(state, exclude)
    # the JAX package rounds the feature table to the selector dtype before
    # its one-hot gather matmuls; the gathers here are exact
    feats = _features(state)
    if sel is not None:
        feats = compaction.round_to(feats, sel)

    packed_parts, valid_parts = [], []
    total_pairs = pair_overflow = 0
    for (t1, t2), kernel in _enabled_kernels(config).items():
        cp_b = config.bucket_capacity(t1, t2)
        k_b = min(_KERNEL_K[(t1, t2)], k_glob)
        ia, ib, bvalid, count, over = _bucket_pairs(
            hit & (tmin == t1) & (tmax == t2), cp_b)
        total_pairs = total_pairs + count
        pair_overflow = pair_overflow + over
        tracing.stamp("pairs")
        points, normals, depths, valid = _collide_rows(
            _gather_rows(feats, ia), _gather_rows(feats, ib), k_b,
            {(t1, t2): kernel})
        valid = valid & bvalid[..., None]

        # (10, cp_b·k_b) payload part, pair-major: body ids and the slot
        # ride as exact small integers; keys are recomputed after
        # compaction
        b, mk = valid.shape[0], cp_b * k_b
        slot_k = torch.arange(k_b, dtype=f, device=state.device).repeat(cp_b)
        packed_parts.append(torch.cat([
            points.reshape(b, mk, 3).transpose(1, 2),
            normals.reshape(b, mk, 3).transpose(1, 2),
            depths.reshape(b, 1, mk),
            ia.repeat_interleave(k_b, 1).to(f)[:, None],
            ib.repeat_interleave(k_b, 1).to(f)[:, None],
            slot_k.expand(b, 1, mk),
        ], dim=1))
        valid_parts.append(valid.reshape(b, mk))
        tracing.stamp("collide")

    contacts = _compact_typed(torch.cat(packed_parts, 2).contiguous(),
                              torch.cat(valid_parts, 1), extra, config, n,
                              sel, pair_overflow)
    return contacts, total_pairs


def narrowphase(state: WorldState, cand: PairCandidates, config: EngineConfig,
                extra=None) -> Contacts:
    """The classic narrowphase: each broadphase candidate's manifold at K
    slots (``collide_kernel.collide_pairs``: the hand kernel on the card,
    every enabled kernel selected by type on the CPU), compacted in global
    pair order into ``max_contacts`` rows with ``compaction.compact_rows``.
    Keys are (ia·N + ib)·K + slot; ``extra`` (trimesh) rows carry key −1."""
    k = config.max_contacts_per_pair
    n = state.num_slots
    f = state.pos.dtype
    ia, ib = cand.ia, cand.ib
    b, cp = ia.shape
    _check_key_space(n, k)

    points, normals, depths, valid = collide_kernel.collide_pairs(
        _features(state), ia, ib, cand.valid, k, config)
    tracing.stamp("collide")

    slot_k = torch.arange(k, dtype=torch.int32, device=state.device).repeat(cp)
    keys = ((ia * n + ib).repeat_interleave(k, 1) * k + slot_k).to(f)
    packed = torch.cat([
        points.reshape(b, cp * k, 3), normals.reshape(b, cp * k, 3),
        depths.reshape(b, cp * k, 1),
        ia.repeat_interleave(k, 1).to(f)[..., None],
        ib.repeat_interleave(k, 1).to(f)[..., None], keys[..., None],
    ], dim=-1)                                         # (B, CP·K, 10)
    flat_valid = valid.reshape(b, cp * k)
    if extra is not None:
        e_pts, e_nrm, e_dep, e_a, e_b, e_val = extra
        packed = torch.cat([packed, torch.cat([
            e_pts, e_nrm, e_dep[..., None], e_a.to(f)[..., None],
            e_b.to(f)[..., None], torch.full_like(e_dep, -1.0)[..., None],
        ], dim=-1)], dim=1)
        flat_valid = torch.cat([flat_valid, e_val], dim=1)

    tracing.count("candidate_rows", flat_valid,
                  also=("candidate_slots", flat_valid.numel()))
    rows, cvalid, count, overflow = compaction.compact_rows(
        flat_valid, packed, config.max_contacts)
    return Contacts(
        point=rows[..., 0:3].contiguous(), normal=rows[..., 3:6].contiguous(),
        depth=rows[..., 6].contiguous(), a=rows[..., 7].to(torch.int32),
        b=rows[..., 8].to(torch.int32), valid=cvalid, count=count,
        overflow=overflow,
        key=torch.where(cvalid, rows[..., 9].to(torch.int32), -1))
