"""Wire-format 4×4 transform helpers.

The port of ``rl_ode_physics_tpu/utils/transforms.py``: the same formulas on
tensors with any leading axes.

The reference game snapshots each body as a flat 16-float column-major 4×4
transform (OpenGL layout): ``GetTransformMat`` (``src/main.c:602-622``) writes
the ODE row-major 3×4 rotation's *columns* into elements 0..10 and the
position into elements 12..14. ``BodyState.transform`` on the wire
(``inc/body.h:26-31``) is exactly this layout.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.utils import quat as quat_m


def mat16_from_pos_rot(pos: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """(pos(...,3), R(...,3,3)) → flat (...,16) column-major transform.

    Equivalent of the reference's ``GetTransformMat`` (``src/main.c:602``):
    ``out[4*c + r] = R[r, c]`` for r,c < 3; ``out[12..14] = pos``;
    ``out[15] = 1``.
    """
    batch = torch.broadcast_shapes(pos.shape[:-1], rot.shape[:-2])
    pos = pos.expand(batch + (3,))
    rot = rot.expand(batch + (3, 3))
    zero = torch.zeros(batch, dtype=pos.dtype, device=pos.device)
    one = torch.ones(batch, dtype=pos.dtype, device=pos.device)
    cols = [
        rot[..., 0, 0], rot[..., 1, 0], rot[..., 2, 0], zero,
        rot[..., 0, 1], rot[..., 1, 1], rot[..., 2, 1], zero,
        rot[..., 0, 2], rot[..., 1, 2], rot[..., 2, 2], zero,
        pos[..., 0], pos[..., 1], pos[..., 2], one,
    ]
    return torch.stack(cols, dim=-1)


def mat16_from_pos_quat(pos: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(pos, quaternion) → flat 16 wire transform."""
    return mat16_from_pos_rot(pos, quat_m.to_matrix(q))


def pos_from_mat16(m: torch.Tensor) -> torch.Tensor:
    """Extract position — reference ``GetTransMatPos`` (``src/main.c:653``)."""
    return m[..., 12:15]


def rot_from_mat16(m: torch.Tensor) -> torch.Tensor:
    """Extract the 3×3 rotation — ``GetTransMatRot`` (``src/main.c:659``).

    Wire layout is column-major, so ``R[r, c] = m[4*c + r]``.
    """
    return torch.stack([m[..., 0:3], m[..., 4:7], m[..., 8:11]], dim=-1)


def quat_from_mat16(m: torch.Tensor) -> torch.Tensor:
    """Extract orientation quaternion from the wire transform."""
    return quat_m.from_matrix(rot_from_mat16(m))


def mat16_from_pos_euler(pos: torch.Tensor,
                         rot_xyz: torch.Tensor) -> torch.Tensor:
    """Position + Euler XYZ angles → wire transform (column-major layout)."""
    return mat16_from_pos_quat(pos, quat_m.from_euler_xyz(rot_xyz))


# ---------------------------------------------------------------------------
# Row-major variants (the reference's *other* convention)
# ---------------------------------------------------------------------------
# The reference mixes two layouts for the same flat-16 array:
#   * broadcast path (``GetTransformMat``, src/main.c:602) writes ODE's
#     rotation COLUMN-major (OpenGL style) — handled above;
#   * spawn/map path (``GetTransformMatV`` src/main.c:624 writes, and
#     ``GetTransMatRot`` src/main.c:659 reads, the first 12 floats as ODE's
#     ROW-major dMatrix3 rows).


def mat16_rowmajor_from_pos_euler(pos: torch.Tensor,
                                  rot_xyz: torch.Tensor) -> torch.Tensor:
    """``GetTransformMatV`` layout (row-major R = Rz·Ry·Rx, with the
    src/main.c:639 typo corrected): ``out[4r + c] = R[r, c]``, position
    still at 12..14. Used for MsgNewBody spawn payloads."""
    r = quat_m.to_matrix(quat_m.from_euler_xyz(rot_xyz))
    batch = torch.broadcast_shapes(pos.shape[:-1], r.shape[:-2])
    pos = pos.expand(batch + (3,))
    r = r.expand(batch + (3, 3))
    zero = torch.zeros(batch, dtype=pos.dtype, device=pos.device)
    one = torch.ones(batch, dtype=pos.dtype, device=pos.device)
    rows = [
        r[..., 0, 0], r[..., 0, 1], r[..., 0, 2], zero,
        r[..., 1, 0], r[..., 1, 1], r[..., 1, 2], zero,
        r[..., 2, 0], r[..., 2, 1], r[..., 2, 2], zero,
        pos[..., 0], pos[..., 1], pos[..., 2], one,
    ]
    return torch.stack(rows, dim=-1)


def rot_from_mat16_rowmajor(m: torch.Tensor) -> torch.Tensor:
    """Row-major read: ``R[r, c] = m[4r + c]`` — the ``GetTransMatRot`` →
    ``dBodySetRotation`` interpretation (src/main.c:659,709) applied to
    spawn-message transforms."""
    return torch.stack([m[..., 0:3], m[..., 4:7], m[..., 8:11]], dim=-2)


def quat_from_mat16_rowmajor(m: torch.Tensor) -> torch.Tensor:
    return quat_m.from_matrix(rot_from_mat16_rowmajor(m))
