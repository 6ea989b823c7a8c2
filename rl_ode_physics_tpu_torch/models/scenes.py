"""Scene builders: the reference arena, the BASELINE workloads and the
conformance scenes.

The port of ``rl_ode_physics_tpu/models/scenes.py`` but for
``hinge_chain_scene``, which needs joints. Scenes are drawn from the repo's
own ``RandStream`` on the host, so they are bitwise the JAX package's.
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


def sphere_drop_world(config: EngineConfig, height: float = 5.0,
                      radius: float = 0.15, seed: int = 0,
                      device="cuda") -> WorldState:
    """BASELINE config 1: one sphere falling onto the arena floor (the
    radius of the reference's SPACE-spawned sphere)."""
    b = _arena(config, seed)
    b.add_body(BodyType.SPHERE, (0.0, height, 0.0), (radius, 0.0, 0.0))
    return b.finish(device)


def _rain(b: WorldBuilder, rng: RandStream, count: int) -> None:
    """``count`` boxes and spheres from the reference's spawn distribution:
    x, z in [-4, 4], y in [20, 50]; half boxes with sides in [0.2, 1.0],
    half spheres with radius in [0.1, 0.4]."""
    for _ in range(count):
        pos = (rng.double(-4.0, 4.0), rng.double(20.0, 50.0),
               rng.double(-4.0, 4.0))
        if rng.randint(0, 2) == 0:
            size = (rng.double(0.2, 1.0), rng.double(0.2, 1.0),
                    rng.double(0.2, 1.0))
            b.add_body(BodyType.BOX, pos, size, color=rng.color())
        else:
            size = (rng.double(0.1, 0.4), 0.0, 0.0)
            b.add_body(BodyType.SPHERE, pos, size, color=rng.color())


def stack_world(config: EngineConfig, num_bodies: int = 64, seed: int = 1234,
                device="cuda") -> WorldState:
    """BASELINE config 2-style workload: ``num_bodies`` boxes and spheres
    raining onto the arena."""
    b = _arena(config, seed)
    _rain(b, RandStream(seed), num_bodies)
    return b.finish(device)


def capsule_stack_world(config: EngineConfig, num_bodies: int = 64,
                        seed: int = 7, device="cuda") -> WorldState:
    """BASELINE config 2: ``num_bodies - 1`` boxes and spheres raining onto
    the arena, and a kinematic player capsule standing in it."""
    b = _arena(config, seed)
    _rain(b, RandStream(seed), num_bodies - 1)
    b.add_body(BodyType.CAPSULE, (0.0, 2.0, -3.0), (0.5, 1.0, 0.0),
               kinematic=True)
    return b.finish(device)


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


def capsule_pile_world(config: EngineConfig, device="cuda") -> WorldState:
    """Five capsules in mixed orientations piling up between two boxes on
    the floor: capsule-capsule, capsule-box and capsule-floor contacts."""
    b = WorldBuilder(config, 0)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (100.0, 1.0, 100.0))
    s = float(np.sin(np.pi / 4))
    # lying capsules (local Z onto world X / world Z), staggered heights
    b.add_body(BodyType.CAPSULE, (0.0, 0.78, 0.0), (0.25, 1.0, 0.0),
               quat=(s, 0.0, s, 0.0))
    b.add_body(BodyType.CAPSULE, (0.1, 1.35, 0.05), (0.25, 0.9, 0.0))
    b.add_body(BodyType.CAPSULE, (-0.15, 1.95, -0.04), (0.22, 1.1, 0.0),
               quat=(s, 0.0, s, 0.0))
    # upright capsule dropped onto the pile
    b.add_body(BodyType.CAPSULE, (0.3, 3.0, 0.2), (0.2, 0.8, 0.0),
               quat=(s, s, 0.0, 0.0))
    # kinematic player capsule brushing the pile edge
    b.add_body(BodyType.CAPSULE, (1.6, 1.5, 0.0), (0.5, 1.0, 0.0),
               kinematic=True)
    # boxes the pile leans against
    b.add_body(BodyType.BOX, (-1.6, 0.88, 0.0), (0.7, 0.7, 0.7))
    b.add_body(BodyType.BOX, (0.0, 0.83, 1.7), (0.9, 0.6, 0.5))
    return b.finish(device)


def mini_stack_world(config: EngineConfig, seed: int = 0,
                     device="cuda") -> WorldState:
    """Reduced BASELINE config 2: a 3-box tower of distinct sizes (so that
    the SAT face choice is never a tie), two spheres, a dynamic capsule
    lying on its side and a kinematic player capsule, on the arena floor.
    ``seed`` is unused, as in the JAX package."""
    del seed
    b = WorldBuilder(config, 0)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (100.0, 1.0, 100.0))
    b.add_body(BodyType.BOX, (0.0, 0.88, 0.0), (0.7, 0.7, 0.7))
    b.add_body(BodyType.BOX, (0.05, 1.58, 0.03), (0.6, 0.6, 0.6))
    b.add_body(BodyType.BOX, (-0.04, 2.20, -0.02), (0.5, 0.5, 0.5))
    b.add_body(BodyType.SPHERE, (1.5, 0.85, 0.0), (0.3, 0.0, 0.0))
    b.add_body(BodyType.SPHERE, (-1.5, 1.5, 0.3), (0.3, 0.0, 0.0))
    s = float(np.sin(np.pi / 4))
    b.add_body(BodyType.CAPSULE, (0.0, 0.83, 2.0), (0.25, 1.0, 0.0),
               quat=(s, 0.0, s, 0.0))
    b.add_body(BodyType.CAPSULE, (3.0, 1.5, 0.0), (0.5, 1.0, 0.0),
               kinematic=True)
    return b.finish(device)
