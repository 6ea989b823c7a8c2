"""BASELINE config 3 on the card: trimesh narrowphase throughput.

The port of ``benchmarks/teapot_bench.py``: a batch of worlds, each with
a static triangle mesh as scene geometry and 15 spheres of radius 0.25
(from ``RandStream(3)``) raining on it, stepped 8 substeps a launch; one
warm-up launch and 6 timed ones. The mesh sweep runs the
``sphere_mesh_d2_tiles`` hand kernel on the card (the JAX script's Pallas
kernel on a TPU). Reports body-steps/s and triangle tests/s::

    python3 -m rl_ode_physics_tpu_torch.utils.teapot_bench [num_worlds] \\
        (--obj PATH | --standin) [--device cuda]

The engine is the script's own, ``EngineConfig(max_bodies=16,
max_pair_candidates=64, max_contacts=128, max_contacts_per_pair=8,
enable_planes=False, enable_capsules=False)`` (the classic pipeline at
JACOBI 20), not the throughput ``mesh_config`` of ``chip_smoke.py``'s
trimesh path. The mesh is ``--obj PATH`` (the reference's
``res/teapot.obj``, 8,884 faces, is not in the repository) or, with
``--standin``, ``models/workloads.standin_mesh`` (9,216 triangles once
padded, as the teapot's). With neither, the entry point exits with an
error that says so: it never swaps in the stand-in unasked, and it knows
no place of the teapot outside the repository. The script's second
argument
(``use_pallas``) is accepted as 1 only: the card has no plain mesh sweep
on its step path. Prints the JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.models.workloads import MESH_SPHERES

NUM_BODIES = MESH_SPHERES + 1      # the mesh and its spheres
SUBSTEPS = 8
LAUNCHES = 6


def teapot_config() -> EngineConfig:
    """``teapot_bench.py:40-42``'s engine."""
    return EngineConfig(max_bodies=NUM_BODIES, max_pair_candidates=64,
                        max_contacts=128, max_contacts_per_pair=8,
                        enable_planes=False, enable_capsules=False)


def mesh_geometry(obj: str | None = None, standin: bool = False):
    """(verts, tris) of the OBJ file ``obj`` or of the stand-in; raises
    ``FileNotFoundError`` if neither is given or the file is absent."""
    from rl_ode_physics_tpu_torch.models.workloads import standin_mesh
    from rl_ode_physics_tpu_torch.utils.objloader import load_obj
    if obj and standin:
        raise ValueError("--obj and --standin: give one")
    if standin:
        return standin_mesh()
    if obj is None or not os.path.exists(obj):
        raise FileNotFoundError(
            f"no mesh {'given' if obj is None else 'at ' + obj}: pass --obj "
            f"PATH (the reference's res/teapot.obj, which is not in the "
            f"repository) or --standin for the 9,216-triangle stand-in")
    return load_obj(obj)


def run(num_worlds: int = 64, verts=None, tris=None, device="cuda",
        launches: int = LAUNCHES) -> dict:
    """One warm-up launch and ``launches`` timed ones of ``SUBSTEPS``
    substeps: the JSON line's keys, the overflow and the tile kernel's
    launches in the timed ones."""
    from rl_ode_physics_tpu_torch.models.workloads import mesh_world
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    config = teapot_config()
    world, mesh = mesh_world(config, verts, tris, device)
    batch = replicate(world, num_worlds, device=device)
    step = make_batched_step_fn(config, substeps=SUBSTEPS, device=device,
                                trimesh=mesh)

    def sync():
        if batch.pos.is_cuda:
            torch.cuda.synchronize(batch.pos.device)

    batch = step(batch)
    sync()
    before = mesh_kernels.sphere_mesh_d2_tiles.launches
    t0 = time.perf_counter()
    for _ in range(launches):
        batch = step(batch)
    sync()
    dt = time.perf_counter() - t0
    steps = launches * SUBSTEPS
    overflow = int(batch.overflow.sum())
    if overflow or not torch.isfinite(batch.pos).all():
        raise RuntimeError(f"teapot bench: overflow {overflow} or a "
                           f"non-finite state")
    tri_tests = num_worlds * MESH_SPHERES * 12 * mesh.num_tris * steps
    return {
        "metric": f"teapot trimesh body-steps/sec ({num_worlds} worlds x "
                  f"{NUM_BODIES} bodies, {mesh.num_tris} tris, "
                  f"pallas={batch.pos.is_cuda})",
        "value": num_worlds * NUM_BODIES * steps / dt,
        "unit": "body-steps/sec",
        "triangle_tests_per_sec": tri_tests / dt,
        "overflow": overflow,
        "tile_kernel_launches":
            mesh_kernels.sphere_mesh_d2_tiles.launches - before,
    }


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_worlds", type=int, nargs="?", default=64)
    ap.add_argument("use_pallas", type=int, nargs="?", default=1,
                    choices=(1,), help="1: the mesh sweep's hand kernel")
    ap.add_argument("--obj", default=None, help="an OBJ mesh")
    ap.add_argument("--standin", action="store_true",
                    help="the 9,216-triangle stand-in heightfield")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        verts, tris = mesh_geometry(args.obj, args.standin)
    except (FileNotFoundError, ValueError) as err:
        raise SystemExit(f"teapot_bench: {err}") from None
    card = require_card("teapot_bench", args.device)
    print(json.dumps(dict(run(args.num_worlds, verts, tris, args.device),
                          card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
