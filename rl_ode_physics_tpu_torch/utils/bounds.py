"""The card's bound model: the least time a piece of work could take on an
H100 SXM, from its data sheet.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the device-memory rate,
and the operations it does over the peak rate for their type, FP32 or
FP64 outside the tensor cores (TF32 is off throughout the port).
``chip_smoke.py``, ``utils/device_probe.py`` and ``utils/roofline.py``
read their peaks and bounds from here.
"""

from __future__ import annotations

# H100 SXM data-sheet peaks: device-memory rate (bytes/s) and the FP32 and
# FP64 rates outside the tensor cores (operations/s)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# FP32 operations per (probe, triangle) pair, counted from the reference
# arithmetic (rl_ode_physics_tpu/ops/pallas_kernels.py:89-105 with
# trimesh._tri_vw), not from what csrc/sphere_mesh_d2.cu executes: 78 for the
# squared distance, +1 for the tile kernel's minimum
D2_OPS_PER_PAIR = 78


def _kept(mask, k: int):
    """The columns ``compact_rows_t`` keeps: the first k live ones of each
    world."""
    return mask & (mask.cumsum(1) <= k)


def compaction_bytes(mask, d: int, k: int, size: int = 4) -> int:
    """The bytes ``compact_rows_t`` must move on this (B, M) mask, for
    payload values of ``size`` bytes: the mask read, each kept value of the
    D payload rows read, and the outputs written (rows, valid, count,
    overflow)."""
    b, m = mask.shape
    n_kept = int(_kept(mask, k).sum())
    return b * m + b * (size * d * k + k + 8) + size * d * n_kept


def compaction_floors(mask, d: int, k: int, size: int = 4) -> dict:
    """The least device-memory time of ``compact_rows_t`` on this mask, for
    payload values of ``size`` bytes: ``bound_ms`` moves
    ``compaction_bytes``; ``sector_floor_ms`` reads 32 bytes per payload row
    and group of 32 / ``size`` columns that holds a kept column instead,
    since a column's values lie M values apart; ``floor_64b_ms`` does the
    same with 64 bytes per group of 64 / ``size`` columns, should device
    memory serve no less than that at once."""
    import torch
    b, m = mask.shape
    kept = _kept(mask, k)

    def groups_with_a_kept_column(width):
        groups = torch.nn.functional.pad(kept, (0, -m % width))
        return int(groups.reshape(b, -1, width).any(-1).sum())

    n_kept = int(kept.sum())
    fixed = b * m + b * (size * d * k + k + 8)

    def ms(payload_bytes):
        return (fixed + payload_bytes) / HBM_BYTES_PER_S * 1e3

    return dict(density=float(mask.float().mean()), kept=n_kept,
                bound_ms=compaction_bytes(mask, d, k, size)
                / HBM_BYTES_PER_S * 1e3,
                sector_floor_ms=ms(32 * d * groups_with_a_kept_column(
                    32 // size)),
                floor_64b_ms=ms(64 * d * groups_with_a_kept_column(
                    64 // size)))


def _rates(dtype):
    """(bytes a value, operations/s) of the card's data sheet for a dtype:
    FP32 or FP64 outside the tensor cores."""
    import torch
    if dtype == torch.float64:
        return 8, FP64_OPS_PER_S
    return 4, FP32_OPS_PER_S


def tiles_bound(p: int, t: int, dtype=None) -> dict:
    """The least time of ``sphere_mesh_d2_tiles`` on P probes and T
    triangles: 79 operations a pair, against the probes and triangles read
    and one minimum per (probe, tile) written."""
    size, rate = _rates(dtype)
    ops_ms = p * t * (D2_OPS_PER_PAIR + 1) / rate * 1e3
    bytes_ms = (size * (3 * p + 9 * t + p * (t // 128))
                / HBM_BYTES_PER_S * 1e3)
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def d2_bound(c: int, t: int, dtype=None) -> dict:
    """The least time of one ``sphere_mesh_d2`` query of C centres: 78
    operations a pair, against the centres and triangles read and every
    distance written."""
    size, rate = _rates(dtype)
    ops_ms = c * t * D2_OPS_PER_PAIR / rate * 1e3
    bytes_ms = size * (3 * c + 9 * t + c * t) / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
