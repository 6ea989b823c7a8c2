"""The program's own trace of a cell's step, for the ``--trace 1`` readers.

The readers of ``program_span`` and ``program_counter`` metrics ask for
the run's ``program`` record through ``program(ctx)``. The first that asks
in a ``--trace 1`` run on a card has it made (``record``, in a process of
its own), after the window and the traced calls: a second step of the
same cell, from the run's own ``--seed``, is built and captured under the
program's ``utils.tracing.recording`` (stage stamps and device counters
inside its CUDA graph), warmed up as set-up warms the cell's step, run on
through as many calls as the run's window held, then driven from there,
the traced calls' first call, by the window's closed loop, with no
profiler, for about ``SECONDS`` of calls and at least ``MIN_CALLS``;
``tracing.read()`` of those calls is the record, printed on standard
error as ``# program {...}``. So the record reads the worlds the traced
calls read, and nothing a run measured before changes: the window, the
samples, ``memory_peak_bytes`` and the traced calls are the run's own.

A program without ``utils.tracing`` (a commit from before it), or a run
with no card, gives no record, and every reader of it None. Where the
program has tracing and the record's process fails, the run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SECONDS = 2.0
MIN_CALLS = 16


def record(cfg: dict, traffic: dict, seed: int, device,
           calls_before: int = 0) -> dict | None:
    """The program's trace of ``SECONDS`` of the cell's closed loop, with
    ``calls``, ``wall_s``, ``substeps_per_call`` and ``first_call`` added;
    None where the program has no tracing. The loop starts after the
    set-up's warm-up calls and ``calls_before`` more: a run's window's
    calls, so that a cell that keeps evolving (the settled pile's contact
    rows, and so its solve, grow over a run) reads as its traced calls."""
    try:
        from rl_ode_physics_tpu_torch.utils import tracing
    except ImportError:
        return None
    from benchlib import window

    per_call = int(traffic["substeps_per_call"])
    warm_calls = max(1, int(traffic["warmup_substeps"]) // per_call)
    warm_calls += calls_before
    with tracing.recording(device):
        s = window.build(cfg, traffic, seed, device)
        batch, resets, step = s.batch, s.resets, s.step
        fail = window.Failures(batch)

        def call(batch, k):
            resets.apply(batch, k)
            batch = step(batch)
            fail.update(batch)
            window._sync(device)
            return batch

        for k in range(warm_calls):
            batch = call(batch, k)
        tracing.reset()
        t0 = time.perf_counter()
        n = 0
        while n < MIN_CALLS or time.perf_counter() - t0 < SECONDS:
            batch = call(batch, warm_calls + n)
            n += 1
        wall_s = time.perf_counter() - t0
        rec = tracing.read()
    rec.update(calls=n, wall_s=wall_s, substeps_per_call=per_call,
               first_call=warm_calls)
    return rec


def run_seed(argv=None, default: int = 0) -> int:
    """The ``--seed`` the run was given (``run.py``'s command line)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=default)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def request(ctx: dict, seed: int) -> list:
    """``main``'s arguments for the record of the run's cell: its seed,
    and the window's calls to run before the record's loop, so that the
    loop's first call is the traced calls' first."""
    return ["--workload", ctx["cell"], "--seed", str(seed),
            "--calls-before", str(len(ctx["call_ms"]))]


def program(ctx: dict):
    """The run's ``program`` record: the one in ``ctx``, or, in a traced
    run on a card that has none yet, ``record`` of its cell (``request``)
    made in a process of its own (``main``), kept in ``ctx`` for the
    readers after; None where there is none. The run's own process has
    had the profiler on, and a profiler that has run slows every later
    graph launch of its process (the arena's: 0.16 → 3.3 ms a call): the
    record's host spans and outside gaps would read the trace's cost."""
    if "program" not in ctx:
        ctx["program"] = None
        if ctx.get("traced_substeps") and ctx.get("cell"):
            ctx["program"] = _record_apart(request(ctx, run_seed()))
            if ctx["program"] is not None:
                print("# program " + json.dumps(ctx["program"]),
                      file=sys.stderr)
    return ctx["program"]


def _record_apart(args: list):
    """``main(args)`` in a new process: its record; None without a card or
    for a program without tracing. Raises where the process fails or
    gives no record."""
    import importlib.util
    import torch
    if not (torch.cuda.is_available() and importlib.util.find_spec(
            "rl_ode_physics_tpu_torch.utils.tracing")):
        return None
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve())]
                          + args, stdout=subprocess.PIPE, text=True,
                          timeout=900)
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    if rec is None:
        raise RuntimeError(f"the program's record ({' '.join(args)}) "
                           f"failed: exit {proc.returncode}")
    return rec


def main(argv=None) -> int:
    """``record`` of one cell on the card, as one JSON line (null where
    the program has no tracing). ``--calls-before``: the calls of a run's
    window (``run.py``'s standard error counts them), to read the worlds
    as the run's traced calls did."""
    ap = argparse.ArgumentParser(description="the program's trace of a "
                                 "cell's closed loop")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls-before", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchlib import manifest
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    rec = record(manifest.config_of(bench, cell), manifest.traffic_of(cell),
                 args.seed, "cuda:0", args.calls_before)
    print(json.dumps(rec))
    return 0


def stage_ms(ctx: dict, *stages: str):
    """Device ms a substep of ``stages`` together, from the stamps (the
    substeps: the ``start`` stamps)."""
    rec = program(ctx)
    if rec is None or not rec["stamps"].get("start"):
        return None
    ns = sum(rec["stages_ns"][s] for s in stages)
    return ns / 1e6 / rec["stamps"]["start"]


def per_world(ctx: dict, counter: str):
    """A counter over the world-substeps it was summed over."""
    rec = program(ctx)
    if rec is None or not rec["counters"].get("world_substeps"):
        return None
    return rec["counters"][counter] / rec["counters"]["world_substeps"]


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parents[2])]
    sys.exit(main())
