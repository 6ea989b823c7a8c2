"""Host-side world builder: assemble the SoA state in numpy, upload once.

The port of ``rl_ode_physics_tpu/models/builder.py``: the same numpy
arrays built the same way, so a scene built here is bitwise the JAX
package's. ``finish`` returns a batch of one world on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, CollMask, WorldState
from rl_ode_physics_tpu_torch.utils import quat as quat_m


class WorldBuilder:
    def __init__(self, config: EngineConfig, seed: int = 0):
        self.config = config
        self.seed = seed
        n = config.max_bodies
        f = np.dtype(config.dtype)
        self.pos = np.zeros((n, 3), f)
        self.quat = np.tile(np.array([1.0, 0, 0, 0], f), (n, 1))
        self.linvel = np.zeros((n, 3), f)
        self.angvel = np.zeros((n, 3), f)
        self.inv_mass = np.zeros((n,), f)
        self.inv_inertia = np.zeros((n, 3), f)
        self.body_type = np.zeros((n,), np.int32)
        self.size = np.zeros((n, 3), f)
        self.category = np.zeros((n,), np.uint32)
        self.collide = np.zeros((n,), np.uint32)
        self.is_static = np.zeros((n,), bool)
        self.is_kinematic = np.zeros((n,), bool)
        self.color = np.zeros((n, 4), np.uint8)
        self.count = 0

    def _next(self) -> int:
        if self.count >= self.config.max_bodies:
            raise ValueError("world capacity exceeded "
                             f"({self.config.max_bodies} slots)")
        i = self.count
        self.count += 1
        return i

    def add_body(self, body_type: int, pos, size, quat=None, *,
                 category=int(CollMask.OBJ),
                 collide=int(CollMask.OBJ) | int(CollMask.MAP),
                 kinematic=False, color=(255, 255, 255, 255),
                 linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0),
                 mass: float = 1.0, inertia=(1.0, 1.0, 1.0)) -> int:
        """AddBody semantics with ODE's default mass (m=1, I=identity)."""
        i = self._next()
        self.pos[i] = pos
        if quat is not None:
            self.quat[i] = np.asarray(quat)
        self.linvel[i] = linvel
        self.angvel[i] = angvel
        self.body_type[i] = int(body_type)
        self.size[i] = size
        self.category[i] = category
        self.collide[i] = collide
        self.is_kinematic[i] = kinematic
        self.color[i] = color
        if not kinematic:
            self.inv_mass[i] = 1.0 / mass
            self.inv_inertia[i] = 1.0 / np.asarray(inertia, np.float64)
        return i

    def add_body_map(self, pos, rot_euler, size,
                     color=(80, 80, 80, 255)) -> int:
        """AddBodyMap semantics: a static box geom. Its quaternion comes
        from ``from_euler_xyz`` in f32 whatever ``config.dtype`` is: the JAX
        builder computes it so (``jnp.asarray(rot_euler, jnp.float32)``),
        and a float64 world must start from the same quaternion."""
        i = self._next()
        self.pos[i] = pos
        rot = torch.tensor(rot_euler, dtype=torch.float32)
        self.quat[i] = quat_m.from_euler_xyz(rot).numpy()
        self.body_type[i] = int(BodyType.BOX)
        self.size[i] = size
        self.category[i] = int(CollMask.MAP)
        self.collide[i] = 0xFFFFFFFF
        self.is_static[i] = True
        self.color[i] = color
        return i

    def finish(self, device="cuda") -> WorldState:
        """One host→device upload of the whole world (B=1)."""
        f = getattr(torch, self.config.dtype)
        n = len(self.pos)

        def t(a, dtype=None):
            return torch.from_numpy(a[None].copy()).to(
                device=device, dtype=dtype)

        return WorldState(
            pos=t(self.pos, f),
            quat=t(self.quat, f),
            linvel=t(self.linvel, f),
            angvel=t(self.angvel, f),
            force=torch.zeros((1, n, 3), dtype=f, device=device),
            torque=torch.zeros((1, n, 3), dtype=f, device=device),
            inv_mass=t(self.inv_mass, f),
            inv_inertia=t(self.inv_inertia, f),
            body_type=t(self.body_type),
            size=t(self.size, f),
            category=t(self.category.astype(np.int64)),
            collide=t(self.collide.astype(np.int64)),
            is_static=t(self.is_static),
            is_kinematic=t(self.is_kinematic),
            friction=torch.full((1, n), self.config.mu, dtype=f,
                                device=device),
            restitution=torch.full((1, n), self.config.bounce, dtype=f,
                                   device=device),
            color=t(self.color),
            tick=torch.zeros((1,), dtype=torch.int32, device=device),
            rng_state=torch.tensor([self.seed & 0xFFFFFFFF],
                                   dtype=torch.int64, device=device),
            overflow=torch.zeros((1,), dtype=torch.int32, device=device),
        )
