"""Contact-payload compaction: the plain PyTorch version.

The port of ``rl_ode_physics_tpu/ops/compaction.py:compact_rows_t``. Per
world, the valid columns of a component-major payload ``(D, M)`` move, in
order, into the first columns of ``(D, k)``; the other columns are zero.

This is the plain version of the hand-written kernel in
``ops/compaction_kernel.py``: the CPU path runs it, and ``chip_smoke.py``
holds the kernel to it on the card. It computes with a rank-scatter, which
is exact, so it equals the JAX one-hot selection matmul bit for bit.
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
