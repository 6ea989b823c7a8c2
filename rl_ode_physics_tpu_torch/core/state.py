"""World state: the structure-of-arrays batch of worlds.

The port of ``rl_ode_physics_tpu/core/state.py``. Every tensor carries an
explicit leading world axis: ``pos`` is ``(B, N, 3)``, ``tick`` is ``(B,)``.
A slot ``0..N-1`` stands for one body/geom; ``body_type == NULL`` marks a free
slot, static map geoms are slots with ``is_static`` and zero inverse mass.

Field dtypes are the JAX package's, with one exception: ``category``,
``collide`` and ``rng_state`` are uint32 there and ``int64`` here, holding the
same values in 0..2^32-1 (``CollMask.ALL`` is 0xFFFFFFFF). The bitwise tests
on them then stay exact on every device, where uint32 bitwise operations are
not available on CUDA.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.utils import quat as quat_m

U32_MASK = 0xFFFFFFFF


class BodyType(enum.IntEnum):
    """Geometry type codes (the JAX package's values)."""

    NULL = 0
    SPHERE = 1
    BOX = 2
    CAPSULE = 3
    PLANE = 4
    TRIMESH = 5


class CollMask(enum.IntEnum):
    """Category/collide bitmask values."""

    MAP = 1
    OBJ = 2
    ALL = 0xFFFFFFFF


@dataclasses.dataclass
class WorldState:
    """A batch of B worlds of N slots each."""

    pos: torch.Tensor          # (B, N, 3) f32
    quat: torch.Tensor         # (B, N, 4) f32 (w, x, y, z)
    linvel: torch.Tensor       # (B, N, 3) f32
    angvel: torch.Tensor       # (B, N, 3) f32 world-frame
    force: torch.Tensor        # (B, N, 3) f32 accumulator, cleared per step
    torque: torch.Tensor       # (B, N, 3) f32
    inv_mass: torch.Tensor     # (B, N) f32
    inv_inertia: torch.Tensor  # (B, N, 3) f32 body-frame diagonal of I^-1
    body_type: torch.Tensor    # (B, N) int32 BodyType codes
    size: torch.Tensor         # (B, N, 3) f32
    category: torch.Tensor     # (B, N) int64, values of a uint32
    collide: torch.Tensor      # (B, N) int64, values of a uint32
    is_static: torch.Tensor    # (B, N) bool
    is_kinematic: torch.Tensor  # (B, N) bool
    friction: torch.Tensor     # (B, N) f32
    restitution: torch.Tensor  # (B, N) f32
    color: torch.Tensor        # (B, N, 4) uint8
    tick: torch.Tensor         # (B,) int32
    rng_state: torch.Tensor    # (B,) int64, values of a uint32
    # cumulative count of pair candidates / contact rows dropped at a full
    # capacity (bucket_caps, max_contacts); 0 = nothing was ever dropped
    overflow: torch.Tensor     # (B,) int32

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)

    @property
    def num_worlds(self) -> int:
        return self.pos.shape[0]

    @property
    def num_slots(self) -> int:
        return self.pos.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def active(self) -> torch.Tensor:
        """(B, N) bool — slot occupied."""
        return self.body_type != int(BodyType.NULL)

    @property
    def dynamic(self) -> torch.Tensor:
        """(B, N) bool — integrated by the stepper (active, non-static)."""
        return self.active & ~self.is_static


def create_world(config: EngineConfig, seed: int = 0,
                 device="cuda") -> WorldState:
    """One empty world (B=1): every slot free."""
    n = config.max_bodies
    f = getattr(torch, config.dtype)
    kw = dict(device=device)

    def zeros3():
        return torch.zeros((1, n, 3), dtype=f, **kw)

    return WorldState(
        pos=zeros3(),
        quat=quat_m.identity(f, device).repeat(1, n, 1),
        linvel=zeros3(),
        angvel=zeros3(),
        force=zeros3(),
        torque=zeros3(),
        inv_mass=torch.zeros((1, n), dtype=f, **kw),
        inv_inertia=zeros3(),
        body_type=torch.zeros((1, n), dtype=torch.int32, **kw),
        size=zeros3(),
        category=torch.zeros((1, n), dtype=torch.int64, **kw),
        collide=torch.zeros((1, n), dtype=torch.int64, **kw),
        is_static=torch.zeros((1, n), dtype=torch.bool, **kw),
        is_kinematic=torch.zeros((1, n), dtype=torch.bool, **kw),
        friction=torch.full((1, n), config.mu, dtype=f, **kw),
        restitution=torch.full((1, n), config.bounce, dtype=f, **kw),
        color=torch.zeros((1, n, 4), dtype=torch.uint8, **kw),
        tick=torch.zeros((1,), dtype=torch.int32, **kw),
        rng_state=torch.tensor([seed & U32_MASK], dtype=torch.int64, **kw),
        overflow=torch.zeros((1,), dtype=torch.int32, **kw),
    )


# ---------------------------------------------------------------------------
# Mass helpers (ODE dMass* equivalents)
# ---------------------------------------------------------------------------

def default_mass(dtype=torch.float32, device="cpu"):
    """ODE ``dBodyCreate`` default: total mass 1, unit inertia."""
    return (torch.tensor(1.0, dtype=dtype, device=device),
            torch.ones((3,), dtype=dtype, device=device))


def sphere_mass(radius, density=1.0):
    """dMassSetSphere: m = 4/3 π ρ r³, I = 2/5 m r² (diagonal)."""
    m = (4.0 / 3.0) * torch.pi * density * radius ** 3
    i = 0.4 * m * radius ** 2
    return m, torch.stack([i, i, i], dim=-1)


def box_mass(sides, density=1.0):
    """dMassSetBox: m = ρ·lx·ly·lz, I = m/12 · diag(ly²+lz², lx²+lz², lx²+ly²)."""
    lx, ly, lz = sides[..., 0], sides[..., 1], sides[..., 2]
    m = density * lx * ly * lz
    k = m / 12.0
    return m, torch.stack(
        [k * (ly**2 + lz**2), k * (lx**2 + lz**2), k * (lx**2 + ly**2)],
        dim=-1,
    )


def capsule_mass(radius, length, density=1.0):
    """dMassSetCapsule for a capsule along local Z: a cylinder of the given
    length plus two hemispherical caps."""
    r2 = radius * radius
    m_cyl = density * torch.pi * r2 * length
    m_caps = density * (4.0 / 3.0) * torch.pi * radius ** 3
    m = m_cyl + m_caps
    i_axial = m_cyl * 0.5 * r2 + m_caps * 0.4 * r2
    i_trans = (
        m_cyl * (0.25 * r2 + length ** 2 / 12.0)
        + m_caps * (0.4 * r2 + 0.375 * radius * length + 0.25 * length ** 2)
    )
    return m, torch.stack([i_trans, i_trans, i_axial], dim=-1)


def similarity_diag(r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """R · diag(d) · Rᵀ as a broadcast-sum over the 3×3 dims."""
    tmp = r * d[..., None, :]
    return torch.sum(tmp[..., :, None, :] * r[..., None, :, :], dim=-1)


def world_inv_inertia(state: WorldState) -> torch.Tensor:
    """(B, N, 3, 3) world-frame inverse inertia: R · diag(invI_body) · Rᵀ."""
    r = quat_m.to_matrix(state.quat)
    return similarity_diag(r, state.inv_inertia)
