"""Scene builders: the reference arena and the bench workload's world.

The port of ``rl_ode_physics_tpu/models/scenes.py:30-122``. Scenes are
drawn from the repo's own ``RandStream`` on the host, so they are bitwise
the JAX package's.
"""

from __future__ import annotations

import numpy as np

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.utils.prng import RandStream

# raylib color constants used by the reference arena
DARKGRAY = (80, 80, 80, 255)
RED = (230, 41, 55, 255)
GREEN = (0, 228, 48, 255)
BLUE = (0, 121, 241, 255)


def _arena(config: EngineConfig, seed: int) -> WorldBuilder:
    b = WorldBuilder(config, seed)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                   (100.0, 1.0, 100.0), DARKGRAY)
    b.add_body_map((4.0, 3.0, 0.0), (0.0, 0.0, -0.5), (0.5, 8.0, 12.0), RED)
    b.add_body_map((0.0, 3.0, 6.0), (0.0, 0.0, 0.0), (12.0, 8.0, 0.5), GREEN)
    b.add_body_map((0.0, 3.0, -6.0), (0.0, 0.0, 0.0), (12.0, 8.0, 0.5), BLUE)
    return b


def grass_plane_world(config: EngineConfig, seed: int = 0,
                      device="cuda") -> WorldState:
    """The reference arena: a 100×1×100 floor and three walls."""
    return _arena(config, seed).finish(device)


def bench_world(config: EngineConfig, num_bodies: int = 60, seed: int = 42,
                device="cuda") -> WorldState:
    """The bench workload's world: the arena plus ``num_bodies`` boxes and
    spheres in a dense grid above the floor, so that the steady state has
    resting stacks."""
    b = _arena(config, seed)
    rng = RandStream(seed)
    side = int(np.ceil(num_bodies ** (1.0 / 3.0)))
    n = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if n >= num_bodies:
                    break
                pos = (
                    (ix - side / 2) * 0.9 + rng.double(-0.05, 0.05),
                    1.0 + iy * 0.9,
                    (iz - side / 2) * 0.9 + rng.double(-0.05, 0.05),
                )
                if (n % 2) == 0:
                    b.add_body(BodyType.BOX, pos, (0.6, 0.6, 0.6),
                               color=rng.color())
                else:
                    b.add_body(BodyType.SPHERE, pos, (0.3, 0.0, 0.0),
                               color=rng.color())
                n += 1
    return b.finish(device)
