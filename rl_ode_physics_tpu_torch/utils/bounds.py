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



def collide_bound(b: int, n: int, cp: int, k: int, dtype=None,
                  live: int | None = None) -> dict:
    """The least time of ``collide_pairs`` on B worlds of N bodies and CP
    candidate slots at k manifold slots: the bytes device memory must
    carry, each slot's indices and validity read (9 bytes), its k points,
    normals, depths and valid flags written, and the (B, N, 11) feature
    table read once. Its operations (a few thousand FP64 for the heaviest
    pair) lie well under that time. A live slot's two feature rows come
    from the table in L2 and are not device-memory bytes; with ``live``
    (the live slots) ``l2_bytes`` counts them."""
    size, _ = _rates(dtype)
    per_slot = 9 + k * (6 * size + size + 1)
    hbm = b * cp * per_slot + b * n * 11 * size
    out = dict(bytes=hbm, bound_ms=hbm / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    if live is not None:
        out["l2_bytes"] = live * 2 * 11 * size
    return out

# csrc/pgs_solve.cu's operations, counted from its arithmetic (an FMA as
# 2): a contact axis (relative velocity 32, the update 9, the impulse on
# both bodies 69), a joint row (59); and the dependent operations of one
# axis or joint row, the chain a world's thread waits through (velocity,
# cross, 3-sum, residual, division, clamp, impulse, cross, 3-sum, store)
PGS_OPS_PER_AXIS = 110
PGS_OPS_PER_JOINT_ROW = 59
PGS_CHAIN_PER_AXIS = 22
PGS_CHAIN_PER_JOINT_ROW = 20
# the least latency of a dependent FP32/FP64 operation, in cycles, at the
# H100 SXM's highest boost clock: the chain's floor
CYCLES_PER_DEPENDENT_OP = 4
BOOST_CLOCK_HZ = 1.98e9


def pgs_bound(valid, jlive, num_slots: int, iterations: int, dtype=None,
              friction: bool = True) -> dict:
    """The least time of one ``pgs_solve`` launch on these rows: ``valid``
    (B, C) the live contact rows, ``jlive`` (B, R) the live joint rows or
    None. Bytes: every row's live flag (a bool), each live row's fields
    and bodies, the velocities in and out, every contact row's impulses in
    and out (the output is a new (B, C, 3) tensor, dead rows passed
    through);
    operations: ``iterations`` sweeps of each live row's axes and joint
    rows. ``chain_ms``, not part of the bound: the longest world's chain of
    dependent operations (iterations × its live rows × axes) at
    ``CYCLES_PER_DEPENDENT_OP`` cycles each."""
    size, rate = _rates(dtype)
    axes = 3 if friction else 1
    b, c = valid.shape
    rows = valid.sum(1)
    jrows = (jlive.sum(1) if jlive is not None
             else rows.new_zeros(rows.shape))
    r = 0 if jlive is None else jlive.shape[1]
    live, jl = int(rows.sum()), int(jrows.sum())
    n_bytes = (b * (c + r) + live * (40 * size + 8) + jl * (21 * size + 8)
               + 2 * b * num_slots * 6 * size + 2 * b * c * 3 * size)
    ops = iterations * (live * (axes * PGS_OPS_PER_AXIS + int(friction))
                        + jl * PGS_OPS_PER_JOINT_ROW)
    chain = iterations * int((rows * axes * PGS_CHAIN_PER_AXIS
                              + jrows * PGS_CHAIN_PER_JOINT_ROW).max())
    ops_ms = ops / rate * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                chain_ms=chain * CYCLES_PER_DEPENDENT_OP / BOOST_CLOCK_HZ
                * 1e3, live_rows=live, live_joint_rows=jl)


# csrc/lcp_pivot.cu's dependent operations of one pivot step (the
# permutation's and the column's loads, |·| and compare, 5 levels of the
# warp's argmax tree at a shuffle and a select each, the pivot's load, its
# reciprocal, the multiplier, the update's FMA and store, the barrier) and
# of one back-substitution step (a shuffle, a multiply, an FMA): a count
# from the source, not a measurement of the kernel's cycles
LCP_CHAIN_PER_PIVOT_STEP = 20
LCP_CHAIN_PER_BACK_STEP = 3


def lcp_active_rows(lam, valid, is_normal, friction: bool, mu_row=None):
    """(B,) each world's active rows in the last solve of a pivot solve
    that reached its fixed point, read from its λ (B, R): a valid normal
    row with λ > 0, a valid friction row (with ``friction``) whose μ is ∞,
    or whose λ lies inside its box by more than the fixed point's
    tolerance lets the box move, |λ| < μ·(max(λ_n, 0) − tol·(1 + max|λ|))
    (a clamped row sits on the box of the round before). ``mu_row`` (B,
    C), or None (all ∞)."""
    c = lam.shape[1] // 3
    normal = valid & is_normal
    fric = valid & ~is_normal & bool(friction)
    if mu_row is None:
        boxed_in = valid.new_ones(valid.shape)
    else:
        # ops/lcp._pivot_solve's fixed-point tolerance
        tol = 1e-7 if lam.dtype.itemsize == 8 else 30 * 2.0 ** -23
        slack = tol * (1 + lam.abs().amax(1, keepdim=True))
        mu3 = mu_row.to(lam.dtype).repeat(1, 3)
        ln = lam[:, :c].clamp_min(0).repeat(1, 3)
        boxed_in = mu3.isinf() | (lam.abs() < mu3 * (ln - slack))
    return ((normal & (lam > 0)) | (fric & boxed_in)).sum(1)


def lcp_pivot_bound(valid, rounds, dtype=None, mu_given: bool = True,
                    active=None) -> dict:
    """The least time of one ``lcp_pivot_solve`` launch on these worlds:
    ``valid`` (B, R) the valid rows, ``rounds`` (B,) the pivot rounds each
    world took. Bytes: every row's valid flag (a bool), each world's V × V
    block of A, b and the normal flag of its V valid rows, μ of its V / 3
    contacts (``mu_given``), λ (B, R) and the rounds (int32) out.
    Operations: each world's rounds and final solve, each an elimination
    of its active block (2/3·n³) and two products of its V valid rows
    (4·V²), with every valid row taken as active (the bilateral friction
    rows always are, and a resting stack's normal rows are). ``chain_ms``,
    not part of the bound, an estimate: the longest world's chain, its
    solves × n pivot and n back-substitution steps at
    ``CYCLES_PER_DEPENDENT_OP`` cycles a dependent operation, each solve
    taken at n = ``active`` (B,), the active rows of the world's last solve
    (``lcp_active_rows``), or, where None, at n = V (an upper estimate)."""
    size, rate = _rates(dtype)
    b, r = valid.shape
    v = valid.sum(1).double()
    n = v if active is None else active.double()
    solves = rounds.double() + 1
    n_bytes = (b * r + float((v * v * size + v * (size + 1)).sum())
               + (float((v / 3).ceil().sum()) * size if mu_given else 0)
               + b * r * size + 4 * b)
    ops = float((solves * (2.0 / 3.0 * v ** 3 + 4 * v * v)).sum())
    chain = float((solves * n).max()) * (LCP_CHAIN_PER_PIVOT_STEP
                                         + LCP_CHAIN_PER_BACK_STEP)
    ops_ms = ops / rate * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                chain_ms=chain * CYCLES_PER_DEPENDENT_OP / BOOST_CLOCK_HZ
                * 1e3, valid_rows=int(v.sum()), rounds=int(rounds.sum()))
