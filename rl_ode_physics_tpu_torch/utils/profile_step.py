"""Profile the batched substep: a device trace mapped to source lines of the
port, as a table of the hottest operations.

The port of ``benchmarks/profile_step.py``, whose XLA ops carried their
source line in the compiled HLO's metadata. Here the batched step runs
under ``torch.profiler`` with ``with_stack=True``, which records every
Python call as an event; each CUDA kernel (and copy or fill) is matched to
its launch on the host (the CUDA call of the same correlation id), and its
device time goes to the innermost Python function of
``rl_ode_physics_tpu_torch`` running at that moment (this module
excepted), as ``file:line`` of that function's ``def``. On the CPU, where
there are no kernels, the outermost PyTorch operations take their place,
with their host time::

    python3 -m rl_ode_physics_tpu_torch.utils.profile_step \\
        [num_worlds] [substeps] [--workload bench|capsule|mini]

Workloads (``models/workloads.py``): ``bench`` (default) is bench-64,
``core/config.bench_config(64)`` (the compaction through the
``compact_rows_t`` kernel) on ``scenes.bench_world``, with the JAX
script's ``BENCH_*`` variables (``BENCH_SOLVER``, ``BENCH_CONTACTS``,
``BENCH_ITERS``, ``BENCH_OMEGA``, ``BENCH_BETA``, ``BENCH_TYPED``,
``BENCH_SEL_DTYPE``, ``BENCH_CM``, ``BENCH_CHUNK``) overriding its fields
where set; the JAX script's defaults, a classic-pipeline engine, are
``BENCH_TYPED=0 BENCH_ITERS=10 BENCH_OMEGA=1.2 BENCH_CONTACTS=128
BENCH_SEL_DTYPE=float32``. ``capsule`` is the capsule-stack workload
(BASELINE config 2, classic, one world settled 480 substeps first),
``mini`` the mini-stack workload. The batch takes one untraced launch of
``substeps`` substeps, then one traced launch, both eager
(``utils/graphs.disable_graphs``): a CUDA graph's replay runs no Python,
so its kernels would map to no source line.

Printed: the device total a substep, the table (ms a substep, calls, the
operation — the PyTorch operation that launched the kernel, or the
kernel's name for a hand-written one — and the source), the per-file
totals with what no function of the port launched under ``?``, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import torch

from rl_ode_physics_tpu_torch.utils import graphs

PACKAGE = "rl_ode_physics_tpu_torch"
_FRAME = re.compile(rf"{PACKAGE}/(\S+?\.py)\((\d+)\): (.+)$")
_SELF = "utils/profile_step.py"
# the trace's categories of work on the card
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def bench_profile_config():
    """``bench_config(64)`` with the JAX script's ``BENCH_*`` variables
    applied where they are set."""
    from rl_ode_physics_tpu_torch.core.config import SolverKind, bench_config
    env = os.environ
    casts = dict(
        BENCH_SOLVER=("solver", lambda v: SolverKind[v.upper()]),
        BENCH_CONTACTS=("max_contacts", int),
        BENCH_ITERS=("solver_iterations", int),
        BENCH_OMEGA=("jacobi_omega", float),
        BENCH_BETA=("jacobi_beta", float),
        BENCH_TYPED=("typed_buckets", lambda v: v != "0"),
        BENCH_SEL_DTYPE=("selector_dtype", str),
        BENCH_CM=("cm_narrowphase", lambda v: v != "0"))
    return bench_config(64).replace(**{
        field: cast(env[key]) for key, (field, cast) in casts.items()
        if key in env})


def workload(name: str, device="cuda"):
    """(config, one world) of a workload."""
    from rl_ode_physics_tpu_torch.models import scenes, workloads
    if name == "bench":
        config = bench_profile_config()
        return config, scenes.bench_world(config, num_bodies=60,
                                          device=device)
    if name == "capsule":
        return workloads.settled_capsule_stack(device)
    if name == "mini":
        config = workloads.mini_config()
        return config, scenes.mini_stack_world(config, device=device)
    raise ValueError(f"unknown workload {name!r}")


@dataclasses.dataclass
class _Span:
    start: float
    end: float
    source: str
    function: str


def trace_events(prof) -> list:
    """The complete events (``"ph": "X"``) of a finished profile's Chrome
    trace: the one form that carries the Python calls (category
    ``python_function``) in every PyTorch release the port runs on."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _frames(events):
    """The port's Python calls on the thread that made most of them (this
    module's excepted), as spans sorted by start."""
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") != "python_function":
            continue
        m = _FRAME.search(e["name"])
        if m is None or m.group(1) == _SELF:
            continue
        spans[e["tid"]].append(_Span(
            e["ts"], e["ts"] + e["dur"], f"{m.group(1)}:{m.group(2)}",
            m.group(3)))
    if not spans:
        return []
    main = max(spans.values(), key=len)
    return sorted(main, key=lambda s: (s.start, -s.end))


def _innermost(spans, times):
    """For each host time, the innermost span holding it, or None: one
    sweep over the nested spans, the times in order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    stack, i = [], 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def _device_items(events):
    """(op, kernel, host time, device µs) of every kernel, copy and fill on
    the card: the host time is that of its launch, the host-side CUDA call
    of the same correlation id (None if the trace has none); the op is the
    PyTorch operation it is linked to, or the kernel's own name (a hand
    kernel's ctypes launch runs in no operation)."""
    launches, ops = {}, {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") in DEVICE_WORK:
            continue
        if "correlation" in args:
            launches[args["correlation"]] = e
        elif e.get("cat") == "cpu_op" and "External id" in args:
            ops[args["External id"]] = e
    items = []
    for e in events:
        if e.get("cat") not in DEVICE_WORK:
            continue
        args = e.get("args", {})
        op = ops.get(args.get("External id"))
        launch = launches.get(args.get("correlation"))
        items.append((op["name"] if op is not None else e["name"],
                      e["name"], None if launch is None else launch["ts"],
                      e["dur"]))
    return items


def _cpu_items(events):
    """(op, op, host time, host µs) of the outermost PyTorch operations of
    each thread."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["ts"], -e["dur"]))
    items, ends = [], {}
    for e in ops:
        if e["ts"] >= ends.get(e["tid"], float("-inf")):
            items.append((e["name"], e["name"], e["ts"], e["dur"]))
            ends[e["tid"]] = e["ts"] + e["dur"]
    return items


def attribute(events, items) -> list:
    """Rows ``{op, kernel, source, function, us, calls}`` of the profiled
    ``items`` (``_device_items`` or ``_cpu_items`` of ``events``), one a
    (operation, kernel, source), hottest first; ``source`` ``?`` where no
    function of the port was running at the launch."""
    spans = _frames(events)
    known = [i for i, it in enumerate(items) if it[2] is not None]
    where = dict(zip(known, _innermost(spans, [items[i][2] for i in known])))
    rows = {}
    for i, (op, kernel, _, us) in enumerate(items):
        span = where.get(i)
        source, function = ((span.source, span.function) if span
                            else ("?", "?"))
        row = rows.setdefault((op, kernel, source), dict(
            op=op, kernel=kernel, source=source, function=function, us=0.0,
            calls=0))
        row["us"] += us
        row["calls"] += 1
    return sorted(rows.values(), key=lambda r: -r["us"])


def profile(num_worlds: int = 2048, substeps: int = 8, name: str = "bench",
            device="cuda") -> dict:
    """Profile one launch of ``substeps`` substeps of ``num_worlds`` worlds
    of a workload: the rows of ``attribute`` (``ms`` a substep), the total
    a substep, the per-file totals, the share of the total mapped to a
    source line of the port, and the launches of each hand kernel in the
    traced launch."""
    from torch.profiler import ProfilerActivity

    from rl_ode_physics_tpu_torch.ops import compaction_kernel, mesh_kernels
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    on_device = torch.device(device).type == "cuda"
    config, world = workload(name, device)
    chunk = int(os.environ.get("BENCH_CHUNK", 0)) if name == "bench" else 0
    batch = replicate(world, num_worlds, device=device)
    graphed = make_batched_step_fn(config, substeps=substeps, device=device,
                                   chunk=chunk if num_worlds > chunk else 0)

    def step(b):
        with graphs.disable_graphs():
            return graphed(b)

    def sync():
        if on_device:
            torch.cuda.synchronize(device)

    batch = step(batch)
    sync()
    kernels = (compaction_kernel.compact_rows_t,
               mesh_kernels.sphere_mesh_d2_tiles, mesh_kernels.sphere_mesh_d2)
    before = [k.launches for k in kernels]
    activities = [ProfilerActivity.CPU]
    if on_device:
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities,
                                with_stack=True) as prof:
        batch = step(batch)
        sync()
    wall_s = time.perf_counter() - t0
    events = trace_events(prof)
    items = _device_items(events) if on_device else _cpu_items(events)
    rows = attribute(events, items)
    total = sum(r["us"] for r in rows)
    by_file = collections.Counter()
    for r in rows:
        r["ms"] = r["us"] / substeps / 1e3
        by_file[r["source"].split(":")[0]] += r["ms"]
    mapped = sum(r["us"] for r in rows if r["source"] != "?")
    return dict(
        workload=name, worlds=num_worlds, substeps=substeps,
        device=str(device), on_device=on_device,
        total_ms=total / substeps / 1e3, traced_wall_s=wall_s,
        mapped_share=mapped / total if total else 0.0,
        rows=rows, by_file=dict(by_file.most_common()),
        hand_kernel_launches={k.__name__: k.launches - b
                              for k, b in zip(kernels, before)},
        overflow=int(batch.overflow.sum()))


def report(r: dict, top: int = 60) -> str:
    """The JAX tool's table: the total, the hottest rows, the per-file
    totals."""
    what = "device" if r["on_device"] else "host (CPU operations)"
    lines = [f"{what} total: {r['total_ms']:.2f} ms/substep "
             f"@{r['worlds']} worlds ({r['workload']}); "
             f"{r['mapped_share']:.1%} mapped to the port's source",
             f"{'ms/substep':>10}  {'calls':>5}  {'op':<38} source"]
    for row in r["rows"][:top]:
        lines.append(f"{row['ms']:10.3f}  {row['calls']:5d}  "
                     f"{row['op'][:38]:<38} {row['source']} "
                     f"({row['function']})")
    lines.append("\nper-file totals (unattributed ops under '?'):")
    for fname, ms in r["by_file"].items():
        lines.append(f"{ms:10.3f}  {fname}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_worlds", type=int, nargs="?", default=2048)
    ap.add_argument("substeps", type=int, nargs="?", default=8)
    ap.add_argument("--workload", default="bench",
                    choices=("bench", "capsule", "mini"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=60)
    args = ap.parse_args(argv)
    card = require_card("profile_step", args.device)
    r = profile(args.num_worlds, args.substeps, args.workload, args.device)
    print(report(r, args.top))
    print(f"card: {card}; traced launch {r['traced_wall_s']:.2f} s; hand "
          f"kernel launches {r['hand_kernel_launches']}; overflow "
          f"{r['overflow']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
