#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure raises and the script exits non-zero:

0. device: a CUDA card is required; prints ``nvidia-smi``'s name and power
   limit of the card.
1. build: compiles every hand-written kernel of the main paths from the
   checkout's sources with ``nvcc`` (one ``nvcc`` per source, all started
   together) and prints the build time.
2. ``compact_rows_t`` against its plain version on the card, at the bench
   path's shapes: B=8192 worlds, D=10, M=384, k=64, mask densities 0,
   0.15, 0.5 and 1 (overflow), both selector dtypes, held exactly equal.
   Times the kernel and its plain version with CUDA events.
3. the card's bench step against the port's CPU step: the bench world in 4
   worlds, settled 40 substeps on the CPU, then 8 substeps on each device;
   pos/quat/linvel/angvel at atol 1e-4, tick and overflow exact.
4. the bench main path at full width: the bench world (60 dynamic bodies in
   64 slots) in 8192 worlds through ``make_batched_step_fn(substeps=96)``,
   one warm-up launch and 3 timed ones (384 substeps, inside the 600
   audited for this capacity signature); zero overflow, finite state,
   tick 384; prints body-steps/s. Kernel launch counts are set to 0 just
   before this phase and read just after.
5. the card's mesh step against the port's CPU step: 4 worlds of the
   trimesh scene below, settled 96 substeps on the CPU, then 8 substeps on
   each device; and 4 worlds of a sphere and a box on the twin-ridge mesh
   (``box_tri_candidates`` on the card), settled 44 substeps, so that the
   box lands during the compared ones. Both at atol 1e-4, tick and
   overflow exact.
6. the trimesh main path at full width: ``benchmarks/teapot_bench.py``'s
   workload (the mesh in slot 0, 15 spheres of radius 0.25 from
   ``RandStream(3)``) on a stand-in for the teapot of the same padded size
   (9,216 triangles), 1,024 worlds, one warm-up launch of 96 substeps and 3
   timed launches of 48; then ``sphere_mesh_contacts`` of world 0's
   spheres, the entry point of the one-probe kernel. Zero overflow, finite
   state, tick 240; prints body-steps/s, ms/substep and peak memory.
   Launch counts are set to 0 just before this phase and read just after:
   ``sphere_mesh_d2_tiles`` and ``compact_rows_t`` once per substep,
   ``sphere_mesh_d2`` once per sphere.
7. the mesh kernels against their plain versions on the card, held exactly
   equal (the library is built with ``-fmad=false``): the tile kernel on
   the settled main path's own probes and on random probes, the one-probe
   kernel on 64 centres against the 9,216-triangle mesh. Times each kernel
   and its plain version with CUDA events.
8. prints one JSON line of every kernel the run launched, then the last
   line ``{"ok": true, "device": {...}}``.

The bench configuration is ``core.config.bench_config(64)``: the values
``bench.bench_config(64)`` resolves to at its defaults, with the contact
compaction run by the kernel. The trimesh configuration is
``EngineConfig.throughput(max_bodies=16, max_pair_candidates=64,
max_contacts=128, enable_planes=False, enable_capsules=False,
pallas_compaction=True)``, three probes per body.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks: device-memory rate (bytes/s) and FP32 rate
# outside the tensor cores (operations/s)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
WORLDS = 8192
BODIES = 60
SUBSTEPS_PER_LAUNCH = 96
TIMED_LAUNCHES = 3

# the trimesh path: teapot_bench.py's workload at 16x its worlds
MESH_WORLDS = 1024
MESH_SPHERES = 15
MESH_WARMUP_SUBSTEPS = 96
MESH_SUBSTEPS_PER_LAUNCH = 48
MESH_TIMED_LAUNCHES = 3
MESH_CELLS = 67              # 2·67² = 8,978 triangles, padded to 9,216
# FP32 operations per (probe, triangle) pair, counted from
# csrc/sphere_mesh_d2.cu: 78 in pair_d2, +1 for the tile kernel's minimum
D2_OPS_PER_PAIR = 78


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` runs, after a
    warm-up, from CUDA events."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from rl_ode_physics_tpu_torch.ops import compaction_kernel, mesh_kernels
    builds = [compaction_kernel.build, mesh_kernels.build]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        libs = [f.result() for f in [pool.submit(b) for b in builds]]
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s: {[p.name for p in libs]}")


def phase_kernels():
    """compact_rows_t against its plain version at the main path's shape."""
    import torch
    from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel

    b, d, m, k = WORLDS, 10, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    timed = None
    for sel in (None, torch.bfloat16):
        for density in (0.0, 0.15, 0.5, 1.0):
            mask = torch.rand((b, m), generator=gen, device="cuda") < density
            payload = torch.randn((b, d, m), generator=gen, device="cuda")
            got = compaction_kernel.compact_rows_t(mask, payload, k, sel)
            ref = compaction.compact_rows_t(mask, payload, k, sel)
            torch.cuda.synchronize()
            for name, g, r in zip(("rows_t", "valid", "count", "overflow"),
                                  got, ref):
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"compact_rows_t differs from its plain version in "
                        f"{name} (density {density}, sel {sel})")
            max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
            if density == 1.0 and not bool((got[3] == m - k).all()):
                raise AssertionError("overflow case: wrong overflow count")
            if sel is torch.bfloat16 and density == 0.15:
                timed = (mask, payload, sel, got[2])
            log(f"compact_rows_t sel={sel} density={density}: exact "
                f"(kept {int(got[2].sum())} rows, overflow "
                f"{int(got[3].sum())})")

    mask, payload, sel, count = timed
    kernel_ms = cuda_ms(
        lambda: compaction_kernel.compact_rows_t(mask, payload, k, sel))
    plain_ms = cuda_ms(
        lambda: compaction.compact_rows_t(mask, payload, k, sel))
    # least bytes for this data: the mask, the D floats of each kept column,
    # and the outputs (rows, valid, count, overflow)
    kept = int(count.sum())
    need_bytes = b * m + 4 * d * kept + b * (4 * d * k + k + 8)
    full_bytes = b * (m + 4 * d * m) + b * (4 * d * k + k + 8)
    bound_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    log(f"compact_rows_t at B={b} D={d} M={m} k={k} (density 0.15, bf16): "
        f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={bound_ms:.5f} (bytes {need_bytes}; reading the whole "
        f"payload: {full_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms) "
        f"launches_per_substep=1 library_ms=null")
    return dict(name="compact_rows_t", route="cuda",
                source="rl_ode_physics_tpu_torch/csrc/compact_rows.cu",
                replaces="rl_ode_physics_tpu/ops/compaction_pallas.py:75",
                launches=None, max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def _card_matches_cpu(config, world, mesh, settle, label):
    """4 worlds settled ``settle`` substeps on the CPU, then 8 substeps on
    each device: pos/quat/linvel/angvel at atol 1e-4, tick and overflow
    exact. ``mesh``: the scene's static mesh on the CPU, or None."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    start = make_batched_step_fn(config, substeps=settle, device="cpu",
                                 trimesh=mesh)(replicate(world, 4,
                                                         device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu",
                               trimesh=mesh)(start)
    card = make_batched_step_fn(
        config, substeps=8, device="cuda",
        trimesh=None if mesh is None else mesh.to("cuda"))(
            _to(start, "cuda"))
    torch.cuda.synchronize()
    worst = {}
    for name in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
        worst[name] = float(diff)
        if not diff <= 1e-4:
            raise AssertionError(f"{label}: card step differs from the CPU "
                                 f"step in {name}: {float(diff)} > 1e-4")
    for name in ("tick", "overflow"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"{label}: card step {name} differs from "
                                 f"the CPU's")
    log(f"{label}: card step vs CPU step (4 worlds, {settle} "
        f"settling + 8 substeps): max abs diff {worst}, tick "
        f"{cpu.tick.tolist()}, overflow {cpu.overflow.tolist()}")


def phase_card_vs_cpu(config):
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    _card_matches_cpu(config, bench_world(config, num_bodies=BODIES,
                                          device="cpu"),
                      None, 40, "bench scene")


def _to(state, device):
    import dataclasses
    return type(state)(**{f.name: getattr(state, f.name).to(device)
                          for f in dataclasses.fields(state)})


def phase_main_path(config, card):
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = bench_world(config, num_bodies=BODIES, device="cuda")
    batch = replicate(world, WORLDS, device="cuda")
    step = make_batched_step_fn(config, substeps=SUBSTEPS_PER_LAUNCH,
                                device="cuda")
    torch.cuda.synchronize()
    compaction_kernel.compact_rows_t.launches = 0
    t0 = time.perf_counter()
    batch = step(batch)                                  # warm-up launch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = compaction_kernel.compact_rows_t.launches

    total_substeps = SUBSTEPS_PER_LAUNCH * (TIMED_LAUNCHES + 1)
    overflow = int(batch.overflow.sum())
    if overflow:
        raise AssertionError(f"contact capacity overflow: {overflow} rows")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(batch, name)).all()):
            raise AssertionError(f"non-finite {name}")
    if not bool((batch.tick == total_substeps).all()):
        raise AssertionError(f"tick {batch.tick.unique().tolist()} != "
                             f"{total_substeps}")
    dynamic = int((world.inv_mass > 0).sum())
    timed_substeps = SUBSTEPS_PER_LAUNCH * TIMED_LAUNCHES
    rate = WORLDS * dynamic * timed_substeps / secs
    log(f"main path: {WORLDS} worlds x {dynamic} dynamic bodies (of "
        f"{config.max_bodies} slots), {timed_substeps} substeps in "
        f"{secs:.3f} s ({secs / timed_substeps * 1e3:.3f} ms/substep; "
        f"warm-up launch {warm_s:.3f} s): {rate:.1f} body-steps/s on {card}; "
        f"overflow 0, tick {total_substeps}, compact_rows_t launches "
        f"{launches}")
    if launches != total_substeps:
        raise AssertionError(f"compact_rows_t launched {launches} times in "
                             f"{total_substeps} substeps")
    return {"compact_rows_t": launches}


def standin_mesh():
    """The teapot's stand-in: a 67×67-cell heightfield over a 12 m square
    in the grid layout of ``tests/test_trimesh.py``, heights
    ``0.3·sin(x)·cos(z)``: 8,978 triangles, which ``build_trimesh`` pads
    to the teapot's 9,216."""
    import numpy as np
    n = MESH_CELLS
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


def mesh_config():
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    return EngineConfig.throughput(
        max_bodies=16, max_pair_candidates=64, max_contacts=128,
        enable_planes=False, enable_capsules=False, pallas_compaction=True)


def mesh_world(config, verts, tris, device):
    """``teapot_bench.py:42-56``: the mesh in slot 0 and 15 spheres of
    radius 0.25 from ``RandStream(3)`` above it. Returns (world, mesh)."""
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


def ridge_box_world(config, device):
    """A sphere and a box dropped into the twin-ridge valley
    (``scenes.ridge_mesh_geometry``). Returns (world, mesh)."""
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    from rl_ode_physics_tpu_torch.models.scenes import ridge_mesh_geometry
    from rl_ode_physics_tpu_torch.ops.trimesh import build_trimesh

    b = WorldBuilder(config, 0)
    slot = b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    b.body_type[slot] = int(BodyType.TRIMESH)
    b.add_body(BodyType.SPHERE, (-0.6, 1.6, 0.4), (0.3, 0.0, 0.0))
    b.add_body(BodyType.BOX, (0.0, 1.2, -0.5), (0.5, 0.5, 0.5))
    verts, tris = ridge_mesh_geometry()
    return b.finish(device), build_trimesh(verts, tris, slot=slot,
                                           pad_to_multiple=128, device=device)


def phase_mesh_card_vs_cpu(config, verts, tris):
    world, mesh = mesh_world(config, verts, tris, "cpu")
    _card_matches_cpu(config, world, mesh, MESH_WARMUP_SUBSTEPS,
                      f"trimesh scene ({mesh.num_tris} triangles)")
    # the box lands in the valley at about substep 50: the 8 compared
    # substeps hold its impact
    world, mesh = ridge_box_world(config, "cpu")
    _card_matches_cpu(config, world, mesh, 44, "sphere and box on the ridge")


def phase_mesh_main_path(config, verts, tris, card):
    import torch
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.ops import compaction_kernel, mesh_kernels
    from rl_ode_physics_tpu_torch.ops.trimesh import sphere_mesh_contacts
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world, mesh = mesh_world(config, verts, tris, "cuda")
    batch = replicate(world, MESH_WORLDS, device="cuda")
    warm = make_batched_step_fn(config, substeps=MESH_WARMUP_SUBSTEPS,
                                device="cuda", trimesh=mesh)
    step = make_batched_step_fn(config, substeps=MESH_SUBSTEPS_PER_LAUNCH,
                                device="cuda", trimesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (compaction_kernel.compact_rows_t,
                mesh_kernels.sphere_mesh_d2_tiles, mesh_kernels.sphere_mesh_d2)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    batch = warm(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # the one-probe entry point on the settled spheres of world 0
    spheres = (world.body_type[0] == int(BodyType.SPHERE)).nonzero()[:, 0]
    contacts = [sphere_mesh_contacts(batch.pos[0, i].contiguous(), 0.25,
                                     mesh, k=4) for i in spheres.tolist()]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    timed_substeps = MESH_SUBSTEPS_PER_LAUNCH * MESH_TIMED_LAUNCHES
    total_substeps = MESH_WARMUP_SUBSTEPS + timed_substeps
    overflow = int(batch.overflow.sum())
    if overflow:
        raise AssertionError(f"trimesh path: capacity overflow {overflow}")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(batch, name)).all()):
            raise AssertionError(f"trimesh path: non-finite {name}")
    if not bool((batch.tick == total_substeps).all()):
        raise AssertionError(f"trimesh path: tick "
                             f"{batch.tick.unique().tolist()} != "
                             f"{total_substeps}")
    low = float(batch.pos[:, spheres, 1].min())
    if low < float(verts[:, 1].min()) - 0.5:
        raise AssertionError(f"trimesh path: a sphere fell through the "
                             f"mesh (y={low})")
    touching = 0
    for pts, nrm, dep, val in contacts:
        for x in (pts, nrm, dep):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("sphere_mesh_contacts: non-finite")
        touching += int(val.any())
    if not touching:
        raise AssertionError("sphere_mesh_contacts: no settled sphere of "
                             "world 0 touches the mesh")
    rate = MESH_WORLDS * MESH_SPHERES * timed_substeps / secs
    log(f"trimesh main path: {MESH_WORLDS} worlds x {MESH_SPHERES} spheres "
        f"(of {config.max_bodies} slots) on {mesh.num_tris} triangles, "
        f"{timed_substeps} substeps in {secs:.3f} s "
        f"({secs / timed_substeps * 1e3:.3f} ms/substep; warm-up launch of "
        f"{MESH_WARMUP_SUBSTEPS} substeps {warm_s:.3f} s): {rate:.1f} "
        f"body-steps/s on {card}; overflow 0, tick {total_substeps}, peak "
        f"memory {peak_gb:.3f} GB; sphere_mesh_contacts: {touching} of "
        f"{len(contacts)} world-0 spheres touch the mesh; launches "
        f"{launches}")
    want = {"compact_rows_t": total_substeps,
            "sphere_mesh_d2_tiles": total_substeps,
            "sphere_mesh_d2": len(contacts)}
    if launches != want:
        raise AssertionError(f"trimesh path launches {launches}, expected "
                             f"{want}")
    return launches, batch, mesh


def phase_mesh_kernels(batch, config, mesh):
    """Both mesh kernels against their plain versions on the card."""
    import torch
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    from rl_ode_physics_tpu_torch.ops import trimesh as tm

    tris = mesh.transposed()
    t = mesh.num_tris
    nt = t // tm.MESH_TILE
    probes = tm.mesh_probes(batch, config).reshape(-1, 3).contiguous()
    p = probes.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    real = mesh.v0[mesh.v0[:, 0] < 1e8]          # not the far padding
    lo, hi = real.amin(0) - 1.0, real.amax(0) + 1.0
    rand = lo + (hi - lo) * torch.rand((4096, 3), generator=gen,
                                       device="cuda")
    max_err = 0.0
    for name, sample in (("main-path probes", probes[:4096]),
                         ("random probes", rand)):
        got = mesh_kernels.sphere_mesh_d2_tiles(sample.contiguous(), *tris)
        ref = tm.sphere_mesh_d2_tiles_plain(sample, *tris)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"sphere_mesh_d2_tiles differs from its "
                                 f"plain version on {name}: max abs err "
                                 f"{max_err}")
        log(f"sphere_mesh_d2_tiles on {sample.shape[0]} {name} x {t} "
            f"triangles: exactly equal to the plain version")
    kernel_ms = cuda_ms(lambda: mesh_kernels.sphere_mesh_d2_tiles(
        probes, *tris))
    plain_ms = cuda_ms(lambda: tm.sphere_mesh_d2_tiles_plain(probes, *tris),
                       iters=3)
    pairs = p * t
    ops_ms = pairs * (D2_OPS_PER_PAIR + 1) / FP32_OPS_PER_S * 1e3
    bytes_ms = (12 * p + 36 * t + 4 * p * nt) / HBM_BYTES_PER_S * 1e3
    tiles = dict(name="sphere_mesh_d2_tiles", route="cuda",
                 source="rl_ode_physics_tpu_torch/csrc/sphere_mesh_d2.cu",
                 replaces="rl_ode_physics_tpu/ops/pallas_kernels.py:108",
                 launches=None, max_abs_err=max_err, ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                 library_ms=None)
    log(f"sphere_mesh_d2_tiles at P={p} probes x T={t} triangles "
        f"({pairs} pairs): kernel_ms={kernel_ms:.5f} plain_ms="
        f"{plain_ms:.5f} bound_ms={tiles['bound_ms']:.5f} (operations "
        f"{ops_ms:.5f}, bytes {bytes_ms:.5f}) library_ms=null")

    centers = torch.cat([probes[::p // 60][:60], rand[:4]])[:64]
    max_err = 0.0
    for c in centers:
        c = c.contiguous()
        got = mesh_kernels.sphere_mesh_d2(c, *tris)
        ref = tm.sphere_mesh_d2_plain(c, *tris)
        max_err = max(max_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"sphere_mesh_d2 differs from its plain "
                                 f"version: max abs err {max_err}")
    log(f"sphere_mesh_d2 on {centers.shape[0]} centres x {t} triangles: "
        f"exactly equal to the plain version")

    cols = [c.contiguous() for c in centers]

    def each_center(fn):
        return lambda: [fn(c, *tris) for c in cols]

    kernel_ms = cuda_ms(each_center(mesh_kernels.sphere_mesh_d2),
                        iters=5) / len(cols)
    plain_ms = cuda_ms(each_center(tm.sphere_mesh_d2_plain),
                       iters=5) / len(cols)
    ops_ms = t * D2_OPS_PER_PAIR / FP32_OPS_PER_S * 1e3
    bytes_ms = (12 + 36 * t + 4 * t) / HBM_BYTES_PER_S * 1e3
    one = dict(name="sphere_mesh_d2", route="cuda",
               source="rl_ode_physics_tpu_torch/csrc/sphere_mesh_d2.cu",
               replaces="rl_ode_physics_tpu/ops/pallas_kernels.py:136",
               launches=None, max_abs_err=max_err, ms=kernel_ms,
               plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               library_ms=None)
    log(f"sphere_mesh_d2 per centre, T={t} triangles: kernel_ms="
        f"{kernel_ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
        f"{one['bound_ms']:.6f} (operations {ops_ms:.6f}, bytes "
        f"{bytes_ms:.6f}) library_ms=null")
    return [tiles, one]


def main() -> int:
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch
    from rl_ode_physics_tpu_torch.core.config import bench_config

    config = bench_config(64)
    phase_build()
    kernels = [phase_kernels()]
    phase_card_vs_cpu(config)
    by_path = {"bench": phase_main_path(config, card)}

    mcfg = mesh_config()
    verts, tris = standin_mesh()
    phase_mesh_card_vs_cpu(mcfg, verts, tris)
    by_path["trimesh"], batch, mesh = phase_mesh_main_path(mcfg, verts, tris,
                                                           card)
    kernels += phase_mesh_kernels(batch, mcfg, mesh)
    for entry in kernels:
        counts = {path: got[entry["name"]] for path, got in by_path.items()
                  if entry["name"] in got}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never launched on a "
                                 f"main path")
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(entry[key]):
                raise AssertionError(f"{entry['name']}: {key} not finite")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
