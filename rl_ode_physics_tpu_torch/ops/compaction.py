"""Stream compaction: the plain PyTorch versions.

The port of ``rl_ode_physics_tpu/ops/compaction.py``. ``compact_rows_t``:
per world, the valid columns of a component-major payload ``(D, M)`` move,
in order, into the first columns of ``(D, k)``; the other columns are zero.
It is the plain version of the hand-written kernel in
``ops/compaction_kernel.py``: the CPU path runs it, and ``chip_smoke.py``
holds the kernel to it on the card. ``compact_mask`` (the first k set
entries of a mask) and ``compact_rows`` (its row-major payload form) serve
the classic pipeline, which the JAX package runs outside any Pallas kernel.

Every function selects by index (a rank-scatter or a gather), which is
exact, so each equals its JAX one-hot selection bit for bit.
"""

from __future__ import annotations

import torch


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` (round-to-nearest-even) and widen back."""
    return x.to(dtype).to(x.dtype)


def compact_rows_t(mask: torch.Tensor, payload_t: torch.Tensor, k: int,
                   sel_dtype=None):
    """mask (B, M) bool, payload_t (B, D, M) f32 → (rows_t (B, D, k),
    valid (B, k) bool, count (B,) int32, overflow (B,) int32).

    ``rank`` is the exclusive cumsum of the mask; ``rows_t[:, :, j]`` is the
    payload column whose rank is j. ``sel_dtype=torch.bfloat16`` rounds the
    payload to bf16 first, as the JAX bf16 selection matmul does.
    """
    b, d, m = payload_t.shape
    mi = mask.to(torch.int32)
    csum = torch.cumsum(mi, dim=1, dtype=torch.int32)     # inclusive
    rank = csum - mi                                      # exclusive
    total = csum[:, -1]
    pay = payload_t if sel_dtype is None else round_to(payload_t, sel_dtype)
    # invalid columns and ranks past k land in a discarded column k
    dest = torch.where(mask & (rank < k), rank, k).to(torch.int64)
    rows_t = torch.zeros((b, d, k + 1), dtype=payload_t.dtype,
                         device=payload_t.device)
    rows_t.scatter_(2, dest[:, None, :].expand(b, d, m), pay)
    valid = torch.arange(k, device=mask.device)[None, :] < total[:, None]
    return (rows_t[:, :, :k], valid, torch.clamp_max(total, k),
            torch.clamp_min(total - k, 0))


def compact_mask(mask: torch.Tensor, k: int):
    """Indices of the first k set entries of each world's mask (B, M), in
    ascending order → (idx (B, k) int32, valid (B, k) bool, count (B,)
    int32, overflow (B,) int32); ``idx`` is 0 where not valid."""
    b, m = mask.shape
    csum = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    total = csum[:, -1] if m else torch.zeros((b,), dtype=torch.int32,
                                                 device=mask.device)
    dest = torch.where(mask & (csum <= k), csum - 1, k).to(torch.int64)
    src = torch.arange(m, dtype=torch.int32, device=mask.device).expand(b, m)
    idx = torch.zeros((b, k + 1), dtype=torch.int32, device=mask.device)
    idx.scatter_(1, dest, src)
    valid = (torch.arange(k, device=mask.device)[None, :]
             < total[:, None])
    return (torch.where(valid, idx[:, :k], 0), valid,
            torch.clamp_max(total, k), torch.clamp_min(total - k, 0))


def compact_rows(mask: torch.Tensor, payload: torch.Tensor, k: int):
    """The rows of ``payload`` (B, M, D) where ``mask`` (B, M) is set, in
    order, in the first of k rows → (rows (B, k, D), valid (B, k), count
    (B,), overflow (B,)); rows past the count are zero."""
    idx, valid, count, overflow = compact_mask(mask, k)
    rows = torch.gather(
        payload, 1, idx.to(torch.int64)[..., None].expand(
            -1, -1, payload.shape[-1]))
    return torch.where(valid[..., None], rows, 0.0), valid, count, overflow


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, the lower
    index first among ties: ``jax.lax.top_k(x, k)[1]`` (``torch.topk`` does
    not promise that order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]
