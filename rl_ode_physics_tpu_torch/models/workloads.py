"""The workloads that ``chip_smoke.py`` drives and the measurement tools of
``utils/`` profile: their configurations, worlds and inputs, in one place.

* the trimesh workload: ``benchmarks/teapot_bench.py``'s 15 spheres of
  radius 0.25 from ``RandStream(3)`` above a mesh in slot 0
  (``mesh_world``), on ``standin_mesh``, a 9,216-triangle heightfield that
  stands in for the teapot (which is not in the repository), under the
  throughput policy with the compaction through the kernel
  (``mesh_config``);
* the rollout workload: ``benchmarks/rl_rollout_bench.py``'s environment
  (``rollout_env``) and seeded actions (``seeded_actions``);
* the capsule-stack workload: BASELINE config 2 through the classic
  pipeline (``capsule_config``, ``CAPSULE_BODIES``; ``settled_capsule_stack``
  settles it ``CAPSULE_SETTLE`` substeps as one world);
* the mini-stack workload: ``benchmarks/tpu_default_conformance.py``'s
  engine (``mini_config``) on ``scenes.mini_stack_world``.

Building a world here builds no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig

MESH_CELLS = 67              # 2·67² = 8,978 triangles, padded to 9,216
MESH_SPHERES = 15
ROLLOUT_BODIES = 60
ROLLOUT_ACTORS = [4, 5]
ROLLOUT_RAYS = 16
ROLLOUT_SUBSTEPS = 2
CAPSULE_BODIES = 64          # capsule_stack_world: 63 boxes/spheres + capsule
CAPSULE_SETTLE = 480         # one world, through the fall onto the pile


def standin_mesh(cells: int = MESH_CELLS):
    """The teapot's stand-in: a ``cells``×``cells`` heightfield over a 12 m
    square in the grid layout of ``tests/test_trimesh.py``, heights
    ``0.3·sin(x)·cos(z)``. At the default 67 cells, 8,978 triangles, which
    ``build_trimesh`` pads to the teapot's 9,216. Returns (verts (V, 3)
    float64, tris (T, 3) int64)."""
    n = cells
    xs = np.linspace(-6.0, 6.0, n + 1)
    verts = np.array([[x, 0.3 * np.sin(x) * np.cos(z), z]
                      for z in xs for x in xs], np.float64)
    tris = []
    for r in range(n):
        for c in range(n):
            i = r * (n + 1) + c
            tris.append([i, i + 1, i + n + 1])
            tris.append([i + 1, i + n + 2, i + n + 1])
    return verts, np.array(tris, np.int64)


def mesh_config() -> EngineConfig:
    """The trimesh workload's engine: the throughput policy at
    ``teapot_bench.py``'s capacities, with the compaction through the
    kernel."""
    return EngineConfig.throughput(
        max_bodies=16, max_pair_candidates=64, max_contacts=128,
        enable_planes=False, enable_capsules=False, pallas_compaction=True)


def mesh_world(config: EngineConfig, verts, tris, device="cuda"):
    """``teapot_bench.py:42-56``: the mesh in slot 0 and ``MESH_SPHERES``
    spheres of radius 0.25 from ``RandStream(3)`` above it. Returns (world,
    mesh)."""
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    from rl_ode_physics_tpu_torch.ops.trimesh import build_trimesh
    from rl_ode_physics_tpu_torch.utils.prng import RandStream

    top = float(verts[:, 1].max())
    b = WorldBuilder(config, 0)
    slot = b.add_body_map((0, 0, 0), (0, 0, 0), (0, 0, 0))
    b.body_type[slot] = int(BodyType.TRIMESH)
    rng = RandStream(3)
    for _ in range(MESH_SPHERES):
        b.add_body(BodyType.SPHERE,
                   (rng.double(-1.5, 1.5), top + rng.double(0.5, 3.0),
                    rng.double(-1.5, 1.5)),
                   (0.25, 0.0, 0.0))
    return b.finish(device), build_trimesh(verts, tris, slot=slot,
                                           device=device)


def rollout_env(config: EngineConfig, worlds: int, device="cuda",
                chunk: int = 0, lidar_rays: int = ROLLOUT_RAYS,
                substeps: int = ROLLOUT_SUBSTEPS, obs_slots="actors",
                bodies: int = ROLLOUT_BODIES):
    """``rl_rollout_bench.py``'s environment: the bench world of ``bodies``
    dynamic bodies, actor slots 4 and 5 (the first box and the first
    sphere) observed alone (``obs_slots="all"``: every slot), a horizontal
    fan of ``lidar_rays`` lidar rays on each (0: no lidar)."""
    from rl_ode_physics_tpu_torch.models.env import PhysicsEnv
    from rl_ode_physics_tpu_torch.models.scenes import bench_world

    fan = None
    if lidar_rays:
        ang = np.linspace(0, 2 * np.pi, lidar_rays, endpoint=False)
        fan = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    return PhysicsEnv(
        config,
        lambda cfg, seed: bench_world(cfg, num_bodies=bodies, seed=seed,
                                      device=device),
        actor_slots=ROLLOUT_ACTORS, num_worlds=worlds,
        substeps=substeps, lidar_dirs=fan, chunk=chunk,
        obs_slots=None if obs_slots == "all" else ROLLOUT_ACTORS,
        device=device)


def seeded_actions(shape, seed: int, device="cuda") -> torch.Tensor:
    """0.5 x standard normal forces and torques, from numpy so that every
    device gets the same ones."""
    return torch.from_numpy(0.5 * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)).to(device)


def capsule_config() -> EngineConfig:
    """BASELINE config 2 as ``tests/test_physics.py:222-238`` runs it: the
    classic pipeline at ``EngineConfig``'s defaults, capacities 1.5x the
    peaks the JAX package reaches on this scene (``tools/
    capacity_peaks.py``, ``utils/capacity_peaks.py``)."""
    return EngineConfig(max_bodies=68, max_pair_candidates=192,
                        max_contacts=192)


def settled_capsule_stack(device="cuda"):
    """(config, one world): the capsule-stack workload, its one world
    (``capsule_stack_world(num_bodies=CAPSULE_BODIES, seed=7)``) settled
    ``CAPSULE_SETTLE`` substeps on ``device``, through the fall onto the
    pile."""
    from rl_ode_physics_tpu_torch.models.scenes import capsule_stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn

    config = capsule_config()
    world = capsule_stack_world(config, num_bodies=CAPSULE_BODIES, seed=7,
                                device=device)
    return config, make_batched_step_fn(
        config, substeps=CAPSULE_SETTLE, device=device)(world)


def mini_config() -> EngineConfig:
    """``benchmarks/tpu_default_conformance.py:49-53``'s engine."""
    return EngineConfig.throughput(max_bodies=16, max_pair_candidates=128,
                                   max_contacts=256)
