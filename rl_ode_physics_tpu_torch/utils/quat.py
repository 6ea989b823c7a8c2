"""Quaternion and rotation utilities, ``(w, x, y, z)`` layout like ODE's
``dQuaternion``.

The port of ``rl_ode_physics_tpu/utils/quat.py``: the same formulas in the
same order, on tensors of shape ``(..., 4)`` / ``(..., 3)`` with any leading
axes (a world axis, a body axis).
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The identity quaternion (w=1), in ``dtype`` (float32 by default, as
    in the JAX package; a float64 world passes its dtype)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to a unit quaternion; guards the zero quaternion."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp_min(n, eps)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, (..., 4) × (..., 4) → (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (two cross products)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of unit quaternion q (world → body frame)."""
    return rotate(conj(q), v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix, (..., 4) → (..., 3, 3);
    ``R @ v_body`` is the world-frame vector (ODE's ``dRfromQ``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → unit quaternion, (..., 3, 3) → (..., 4).

    Branch-free Shepperd extraction: all four candidates are computed and
    the one whose pivot of (tr, m00, m11, m22) is largest is kept, the
    first on ties (``torch.argmax`` keeps the first maximum, as
    ``jnp.argmax`` does).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    qw = torch.sqrt(torch.clamp_min(qw, 1e-12)) * 0.5

    c0 = torch.stack([qw[..., 0],
                      (m21 - m12) / (4.0 * qw[..., 0]),
                      (m02 - m20) / (4.0 * qw[..., 0]),
                      (m10 - m01) / (4.0 * qw[..., 0])], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4.0 * qw[..., 1]),
                      qw[..., 1],
                      (m01 + m10) / (4.0 * qw[..., 1]),
                      (m02 + m20) / (4.0 * qw[..., 1])], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4.0 * qw[..., 2]),
                      (m01 + m10) / (4.0 * qw[..., 2]),
                      qw[..., 2],
                      (m12 + m21) / (4.0 * qw[..., 2])], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4.0 * qw[..., 3]),
                      (m02 + m20) / (4.0 * qw[..., 3]),
                      (m12 + m21) / (4.0 * qw[..., 3]),
                      qw[..., 3]], dim=-1)

    piv = torch.stack([tr, m00, m11, m22], dim=-1)
    best = torch.argmax(piv, dim=-1)[..., None]
    out = torch.where(best == 0, c0,
          torch.where(best == 1, c1,
          torch.where(best == 2, c2, c3)))
    return normalize(out)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle (rad) → quaternion."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]],
                     dim=-1)


def from_euler_xyz(rot: torch.Tensor) -> torch.Tensor:
    """Euler angles (X then Y then Z, extrinsic: R = Rz·Ry·Rx) → quat."""
    rx, ry, rz = rot[..., 0], rot[..., 1], rot[..., 2]
    hx, hy, hz = 0.5 * rx, 0.5 * ry, 0.5 * rz
    cx, sx = torch.cos(hx), torch.sin(hx)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cz, sz = torch.cos(hz), torch.sin(hz)
    return torch.stack(
        [
            cz * cy * cx + sz * sy * sx,
            cz * cy * sx - sz * sy * cx,
            cz * sy * cx + sz * cy * sx,
            sz * cy * cx - cz * sy * sx,
        ],
        dim=-1,
    )


def integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """ODE's infinitesimal update q ← normalize(q + dt/2·(ω ⊗ q)), with ω
    the world-frame angular velocity as a pure quaternion."""
    omega_q = torch.cat(
        [torch.zeros_like(omega_world[..., :1]), omega_world], dim=-1)
    dq = 0.5 * mul(omega_q, q)
    return normalize(q + dt * dq)
