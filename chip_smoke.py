#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure raises and the script exits non-zero:

0. device: a CUDA card is required; prints ``nvidia-smi``'s name and power
   limit of the card.
1. build: compiles every hand-written kernel of the main path from the
   checkout's sources with ``nvcc`` (one ``nvcc`` per source, all started
   together) and prints the build time.
2. kernels against their plain versions on the card, at the main path's
   shapes: ``compact_rows_t`` at B=8192 worlds, D=10, M=384, k=64, mask
   densities 0, 0.15, 0.5 and 1 (overflow), both selector dtypes, held
   exactly equal. Times the kernel and its plain version with CUDA events.
3. the card's step against the port's CPU step: the bench world in 4
   worlds, settled 40 substeps on the CPU, then 8 substeps on each device;
   pos/quat/linvel/angvel at atol 1e-4, tick and overflow exact.
4. the main path at full width: the bench world (60 dynamic bodies in 64
   slots) in 8192 worlds through ``make_batched_step_fn(substeps=96)``,
   one warm-up launch and 3 timed ones (384 substeps, inside the 600
   audited for this capacity signature); zero overflow, finite state,
   tick 384; prints body-steps/s. Kernel launch counts are set to 0 just
   before this phase and read just after.
5. prints one JSON line of every kernel the run launched, then the last
   line ``{"ok": true, "device": {...}}``.

The configuration is ``core.config.bench_config(64)``: the values
``bench.bench_config(64)`` resolves to at its defaults, with the contact
compaction run by the kernel.
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

# H100 SXM data-sheet peak device-memory rate (bytes/s)
HBM_BYTES_PER_S = 3.35e12
WORLDS = 8192
BODIES = 60
SUBSTEPS_PER_LAUNCH = 96
TIMED_LAUNCHES = 3


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
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    builds = [compaction_kernel.build]
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


def phase_card_vs_cpu(config):
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = bench_world(config, num_bodies=BODIES, device="cpu")
    start = make_batched_step_fn(config, substeps=40, device="cpu")(
        replicate(world, 4, device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu")(start)
    card = make_batched_step_fn(config, substeps=8, device="cuda")(
        _to(start, "cuda"))
    torch.cuda.synchronize()
    worst = {}
    for name in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
        worst[name] = float(diff)
        if not diff <= 1e-4:
            raise AssertionError(f"card step differs from the CPU step in "
                                 f"{name}: {float(diff)} > 1e-4")
    for name in ("tick", "overflow"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"card step {name} differs from the CPU's")
    log(f"card step vs CPU step (4 worlds, 40 settling + 8 substeps): "
        f"max abs diff {worst}, tick {cpu.tick.tolist()}, overflow "
        f"{cpu.overflow.tolist()}")


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


def main() -> int:
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch
    from rl_ode_physics_tpu_torch.core.config import bench_config

    config = bench_config(64)
    phase_build()
    kernels = [phase_kernels()]
    phase_card_vs_cpu(config)
    launches = phase_main_path(config, card)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
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
