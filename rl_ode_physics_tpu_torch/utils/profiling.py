"""Where a substep's time goes on the card.

Run on a machine with a CUDA card, from the root of the checkout::

    python3 -m rl_ode_physics_tpu_torch.utils.profiling [--worlds 8192]

It builds the bench world (``bench_config(64)``, 60 dynamic bodies) in
``--worlds`` worlds, settles it ``--settle`` substeps, then prints one JSON
object with:

* ``phases``: each stage of the substep run alone on the settled state:
  host wall time (launch to synchronize) and the CUDA-event span on the
  stream, which includes the gaps where the card waits for the host;
* ``substep``: one whole substep under ``torch.profiler``: the wall time,
  the summed device time of its kernels, the device's idle share of the
  wall time, the number of kernel launches, and the kernels with the most
  device time.

Nothing here runs on the main path; it calls the same functions the step
calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


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


def profile(worlds: int, settle: int, repeats: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from rl_ode_physics_tpu_torch.core import world as world_m
    from rl_ode_physics_tpu_torch.core.config import bench_config
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import integrator, narrowphase_cm, solver
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    config = bench_config(64)
    batch = replicate(bench_world(config, device="cuda"), worlds,
                      device="cuda")
    batch = make_batched_step_fn(config, substeps=settle)(batch)
    torch.cuda.synchronize()

    contacts, _ = narrowphase_cm.narrowphase_typed_cm(batch, config)
    forced = integrator.apply_external_forces(batch, config)
    solved = solver.solve(forced, contacts, config)
    phases = {
        "narrowphase (eligibility, pair kernels, compaction)":
            lambda: narrowphase_cm.narrowphase_typed_cm(batch, config),
        "apply_external_forces":
            lambda: integrator.apply_external_forces(batch, config),
        "solve_jacobi": lambda: solver.solve(forced, contacts, config),
        "integrate_positions":
            lambda: integrator.integrate_positions(solved, config),
        "whole substep": lambda: world_m.step(batch, config),
    }
    phase_ms = {}
    for name, fn in phases.items():
        host_ms, span_ms = _timed(fn, repeats)
        phase_ms[name] = {"host_ms": host_ms, "event_span_ms": span_ms}

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        world_m.step(batch, config)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "card": card,
        "worlds": worlds,
        "settle_substeps": settle,
        "phases": phase_ms,
        "substep": {
            "wall_ms_profiled": wall_ms,
            "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches": len(kernels),
            "top_kernels_ms": ranked,
        },
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", type=int, default=8192)
    ap.add_argument("--settle", type=int, default=96)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    print(json.dumps(profile(args.worlds, args.settle, args.repeats,
                             args.top), indent=1))


if __name__ == "__main__":
    main()
