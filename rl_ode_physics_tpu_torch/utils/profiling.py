"""Where a substep's time goes on the card.

Run on a machine with a CUDA card, from the root of the checkout::

    python3 -m rl_ode_physics_tpu_torch.utils.profiling [--worlds 8192]
    python3 -m rl_ode_physics_tpu_torch.utils.profiling --mesh [--worlds 1024]
    python3 -m rl_ode_physics_tpu_torch.utils.profiling --rollout
    python3 -m rl_ode_physics_tpu_torch.utils.profiling --classic
    python3 -m rl_ode_physics_tpu_torch.utils.profiling --mini

The default builds the bench world (``bench_config(64)``, 60 dynamic
bodies); ``--mesh`` builds the trimesh workload of ``models/workloads.py``
(``benchmarks/teapot_bench.py``'s 15 spheres above the 9,216-triangle
heightfield that stands in for the teapot, taken from that script);
``--classic`` the capsule-stack workload of ``models/workloads.py`` (BASELINE
config 2 through the classic pipeline, one world settled 480 substeps on
the card first); ``--mini`` the mini-stack workload of ``models/workloads.py``
(``benchmarks/tpu_default_conformance.py``'s engine and scene: the typed
component-major path with all nine pair kernels). Each is replicated into
``--worlds`` worlds and settled
``--settle`` substeps; then one JSON object is printed with:

* ``phases``: each stage of the substep run alone on the settled state:
  host wall time (launch to synchronize) and the CUDA-event span on the
  stream, which includes the gaps where the card waits for the host; with
  ``--mesh`` the mesh narrowphase, and its tile sweep kernel, are stages of
  their own; with ``--classic`` the broadphase, the nine pair kernels on
  every candidate and the row compaction;
* ``substep``: one whole substep under ``torch.profiler``: the wall time,
  the summed device time of its kernels, the device's idle share of the
  wall time, the number of kernel launches, and the kernels with the most
  device time.

``--rollout`` builds the rollout workload of ``models/workloads.py``
(``benchmarks/rl_rollout_bench.py``'s defaults: ``rollout_config(64)``, the
bench world, actor slots 4 and 5 observed alone, 16 lidar rays each, 2
substeps a control step), advances it ``--settle`` substeps under seeded
actions, and splits one control step of ``PhysicsEnv`` into its substeps,
``observe`` and the lidar: each with the host and event times of
``phases`` and, under ``torch.profiler``, its device time, launches and
idle share.

Nothing here runs on the main path; it calls the same functions the step
calls, except ``MetricsLog``, the server's ring buffer of per-tick
diagnostics (``net/server.SimCore(diagnostics=True)``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


def _sync(state) -> None:
    """Wait for the card that holds ``state``; nothing on the CPU."""
    import torch
    if state.pos.is_cuda:
        torch.cuda.synchronize(state.pos.device)


def phase_timings(state, config, reps: int = 5) -> Dict[str, float]:
    """Milliseconds a call of each phase of the classic substep, the port
    of ``rl_ode_physics_tpu/utils/profiling.py:33``: broadphase,
    narrowphase, external forces, solve and integration, each run once to
    warm up and then ``reps`` times between two synchronizations of the
    state's device, each phase on the previous one's output. ``state`` is a
    batch of any number of worlds (one world is a batch of 1). Keys:
    ``broadphase_ms``, ``narrowphase_ms``, ``forces_ms``, ``solve_ms``,
    ``integrate_ms`` and their sum ``total_ms``."""
    from rl_ode_physics_tpu_torch.ops import broadphase as bp
    from rl_ode_physics_tpu_torch.ops import integrator as integ
    from rl_ode_physics_tpu_torch.ops import narrowphase as nph
    from rl_ode_physics_tpu_torch.ops import solver as sol

    out: Dict[str, float] = {}

    def timeit(name, fn, *args):
        fn(*args)
        _sync(state)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        _sync(state)
        out[name] = (time.perf_counter() - t0) / reps * 1000.0
        return r

    cand = timeit("broadphase_ms", lambda s: bp.broadphase(s, config), state)
    cont = timeit("narrowphase_ms",
                  lambda s, c: nph.narrowphase(s, c, config), state, cand)
    s2 = timeit("forces_ms",
                lambda s: integ.apply_external_forces(s, config), state)
    s3 = timeit("solve_ms", lambda s, c: sol.solve(s, c, config), s2, cont)
    timeit("integrate_ms",
           lambda s: integ.integrate_positions(s, config), s3)
    out["total_ms"] = sum(out.values())
    return out


@contextlib.contextmanager
def trace(logdir: str = os.path.join("build", "trace")):
    """A ``torch.profiler`` trace of the block, of the CPU and, where there
    is one, the card, written as a Chrome trace ``trace.json`` under
    ``logdir`` (the port of ``:73``, a ``jax.profiler`` trace there).
    Yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLog:
    """Ring buffer of per-tick diagnostics rows (host-side), the port of
    ``rl_ode_physics_tpu/utils/profiling.py:82-107``. A row holds world 0
    of the (B,) counters of ``step_with_diagnostics``, read in one
    device-to-host copy."""

    def __init__(self, capacity: int = 4096):
        self.rows = deque(maxlen=capacity)

    def append(self, tick: int, metrics: dict) -> None:
        import torch
        values = torch.stack([v[0].to(torch.float64)
                              for v in metrics.values()]).cpu().tolist()
        row = {"tick": int(tick)}
        row.update(zip(metrics, values))
        self.rows.append(row)

    def last(self) -> Optional[dict]:
        return self.rows[-1] if self.rows else None

    def summary(self) -> dict:
        if not self.rows:
            return {}
        keys = [k for k in self.rows[0] if k != "tick"]
        return {
            k: {
                "mean": float(np.mean([r[k] for r in self.rows])),
                "max": float(np.max([r[k] for r in self.rows])),
            }
            for k in keys
        }


def _timed(fn, repeats: int):
    """(host ms, CUDA-event span ms) per call of ``fn``, averaged over
    ``repeats``."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / repeats
    return host_ms, start.elapsed_time(end) / repeats


def _mesh_workload():
    """(config, one world, mesh): the trimesh workload of
    ``models/workloads.py`` on its 9,216-triangle stand-in mesh."""
    from rl_ode_physics_tpu_torch.models import workloads

    config = workloads.mesh_config()
    world, mesh = workloads.mesh_world(config, *workloads.standin_mesh(),
                                       device="cuda")
    return config, world, mesh


def _mini_workload():
    """(config, one world): the mini-stack workload."""
    from rl_ode_physics_tpu_torch.models import workloads
    from rl_ode_physics_tpu_torch.models.scenes import mini_stack_world

    config = workloads.mini_config()
    return config, mini_stack_world(config, device="cuda")


def _card() -> str:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    return require_card("profiling")


def _profiled(fn, top: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, summed device
    time of its kernels, the device's idle share of the wall time, the
    number of kernel launches and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return {
        "wall_ms_profiled": wall_ms,
        "device_ms": device_ms,
        "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "kernel_launches": len(kernels),
        "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
    }


def profile_rollout(worlds: int, settle: int, repeats: int, top: int) -> dict:
    import torch

    from rl_ode_physics_tpu_torch.core.config import rollout_config
    from rl_ode_physics_tpu_torch.models.env import observe
    from rl_ode_physics_tpu_torch.models.workloads import (
        rollout_env, seeded_actions)

    card = _card()
    config = rollout_config(64)
    env = rollout_env(config, worlds, "cuda")
    state, _ = env.reset(seed=42)
    steps = settle // env.substeps
    actions = seeded_actions((steps + 1, worlds, env.num_actors, 6), 0,
                             "cuda")
    for i in range(steps):
        state = env.advance(state, actions[i])
    torch.cuda.synchronize()
    act = actions[steps]
    rays = env.num_actors * env.lidar_dirs.shape[0]
    phases = {
        f"substeps ({env.substeps} x world.step, forces re-armed)":
            lambda: env.advance(state, act),
        "observe": lambda: observe(state, env.obs_slots),
        f"lidar ({rays} rays x {config.max_bodies} slots a world)":
            lambda: env.sense(state),
        "whole control step (env.step)": lambda: env.step(state, act),
    }
    out = {}
    for name, fn in phases.items():
        host_ms, span_ms = _timed(fn, repeats)
        out[name] = {"host_ms": host_ms, "event_span_ms": span_ms,
                     **_profiled(fn, top)}
    return {
        "card": card,
        "workload": "rollout",
        "worlds": worlds,
        "settle_substeps": steps * env.substeps,
        "overflow": int(state.overflow.sum()),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "control_step": out,
    }


def profile(worlds: int, settle: int, repeats: int, top: int,
            mesh_path: bool = False, classic: bool = False,
            mini: bool = False) -> dict:
    import torch

    from rl_ode_physics_tpu_torch.core import world as world_m
    from rl_ode_physics_tpu_torch.core.config import bench_config
    from rl_ode_physics_tpu_torch.models import workloads
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, mesh_kernels, narrowphase, narrowphase_cm,
        solver, trimesh)
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    card = _card()
    if mesh_path:
        config, world, mesh = _mesh_workload()
    elif classic:
        (config, world), mesh = workloads.settled_capsule_stack(), None
    elif mini:
        (config, world), mesh = _mini_workload(), None
    else:
        config, mesh = bench_config(64), None
        world = bench_world(config, device="cuda")
    batch = replicate(world, worlds, device="cuda")
    batch = make_batched_step_fn(config, substeps=settle,
                                 trimesh=mesh)(batch)
    torch.cuda.synchronize()

    phases = {}
    extra = None
    if mesh is not None:
        extra = trimesh.mesh_narrowphase(batch, mesh, config)
        probes = trimesh.mesh_probes(batch, config).reshape(-1, 3)
        tris = mesh.transposed()
        phases["mesh_narrowphase (probes, tile sweep, candidates, box and "
               "sphere contacts, dedup)"] = (
            lambda: trimesh.mesh_narrowphase(batch, mesh, config))
        phases["sphere_mesh_d2_tiles kernel alone"] = (
            lambda: mesh_kernels.sphere_mesh_d2_tiles(probes, *tris))
    if classic:
        cand = broadphase.broadphase(batch, config)
        contacts = narrowphase.narrowphase(batch, cand, config)
        phases.update({
            "broadphase (pair mask, candidate compaction)":
                lambda: broadphase.broadphase(batch, config),
            "narrowphase (9 pair kernels on every candidate, compact_rows)":
                lambda: narrowphase.narrowphase(batch, cand, config),
        })
    else:
        contacts, _ = narrowphase_cm.narrowphase_typed_cm(batch, config,
                                                          extra)
        phases["narrowphase (eligibility, pair kernels, compaction)"] = (
            lambda: narrowphase_cm.narrowphase_typed_cm(batch, config, extra))
    forced = integrator.apply_external_forces(batch, config)
    solved = solver.solve(forced, contacts, config)
    phases.update({
        "apply_external_forces":
            lambda: integrator.apply_external_forces(batch, config),
        "solve_jacobi": lambda: solver.solve(forced, contacts, config),
        "integrate_positions":
            lambda: integrator.integrate_positions(solved, config),
        "whole substep": lambda: world_m.step(batch, config, mesh),
    })
    phase_ms = {}
    for name, fn in phases.items():
        host_ms, span_ms = _timed(fn, repeats)
        phase_ms[name] = {"host_ms": host_ms, "event_span_ms": span_ms}

    substep = _profiled(lambda: world_m.step(batch, config, mesh), top)
    return {
        "card": card,
        "workload": ("trimesh" if mesh is not None
                     else "capsule-stack" if classic
                     else "mini-stack" if mini else "bench"),
        "worlds": worlds,
        "settle_substeps": settle,
        "overflow": int(batch.overflow.sum()),
        "live_contacts_max": int(contacts.count.max()),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "phases": phase_ms,
        "substep": substep,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="the trimesh workload instead of the bench's")
    ap.add_argument("--rollout", action="store_true",
                    help="a control step of the RL rollout workload")
    ap.add_argument("--classic", action="store_true",
                    help="the capsule-stack workload's classic substep")
    ap.add_argument("--mini", action="store_true",
                    help="the mini-stack workload's typed substep")
    ap.add_argument("--worlds", type=int, default=None,
                    help="default 8192, or 1024 with --mesh")
    ap.add_argument("--settle", type=int, default=96)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    worlds = args.worlds or (1024 if args.mesh else 8192)
    if args.rollout:
        result = profile_rollout(worlds, args.settle, args.repeats, args.top)
    else:
        result = profile(worlds, args.settle, args.repeats, args.top,
                         args.mesh, args.classic, args.mini)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
