"""Scene builders: the reference arena, the bench workload's world and the
trimesh-conformance scene.

The port of ``rl_ode_physics_tpu/models/scenes.py:30-122`` and
``:158-203``. Scenes are drawn from the repo's own ``RandStream`` on the
host, so they are bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh, build_trimesh
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


def ridge_mesh_geometry():
    """Analytic twin-ridge heightfield (48 triangles): piecewise-linear
    ridges at x=±1.4, a valley at the center; rich enough for the face,
    vertex and edge trimesh feature classes."""
    xs = np.linspace(-3.0, 3.0, 7)
    zs = np.linspace(-2.0, 2.0, 5)

    def height(x):
        return (0.5 * max(0.0, 1.0 - abs(x - 1.4))
                + 0.5 * max(0.0, 1.0 - abs(x + 1.4)))

    verts = np.array([[x, height(x), z] for z in zs for x in xs], np.float64)
    tris = []
    nx = len(xs)
    for r in range(len(zs) - 1):
        for c in range(nx - 1):
            i = r * nx + c
            tris.append([i, i + 1, i + nx])
            tris.append([i + 1, i + nx + 1, i + nx])
    return verts, np.array(tris, np.int64)


def ridge_mesh_scene(config: EngineConfig,
                     device="cuda") -> tuple[WorldState, TriMesh]:
    """(state, mesh): a sphere, a box and a capsule dropped into the valley
    of the twin-ridge heightfield, the mesh padded to one 128-triangle
    tile."""
    b = WorldBuilder(config, 0)
    mesh_slot = b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                               (0.0, 0.0, 0.0))
    b.body_type[mesh_slot] = int(BodyType.TRIMESH)
    b.add_body(BodyType.SPHERE, (-0.6, 1.6, 0.4), (0.3, 0.0, 0.0))
    b.add_body(BodyType.BOX, (0.0, 1.2, -0.5), (0.5, 0.5, 0.5))
    s = float(np.sin(np.pi / 4))
    b.add_body(BodyType.CAPSULE, (0.6, 2.0, 0.2), (0.2, 0.8, 0.0),
               quat=(s, 0.0, s, 0.0))
    state = b.finish(device)

    verts, tris = ridge_mesh_geometry()
    mesh = build_trimesh(verts, tris, slot=mesh_slot, dtype=state.pos.dtype,
                         pad_to_multiple=128, device=device)
    return state, mesh
