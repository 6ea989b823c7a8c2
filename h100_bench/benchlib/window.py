"""One run of a cell: set-up, the measured window, the traced calls.

The loop is closed, as a vectorised-environment learner drives it: a call
applies the resets that are due, calls the program's batched step
(``parallel.batch.make_batched_step_fn``: a CUDA graph replay of
``substeps_per_call`` substeps), counts failures on the device, and ends
with ``torch.cuda.synchronize()``; the next call starts after it. Set-up
builds the seeded worlds, captures the cell's graph and runs the
warm-up calls under the same loop. The window runs calls until
``seconds`` have passed and ends at the last call's synchronise.

Samples for the check: the sampled worlds' state before and after a few
calls drawn from the seed (and the run's first call, from the worlds the
harness made), copied on the device and read after the window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchlib import traffic as traffic_m

SNAPSHOT_FIELDS = ("pos", "quat", "linvel", "angvel", "force", "torque",
                   "inv_mass", "inv_inertia", "body_type", "size",
                   "category", "collide", "is_static", "is_kinematic",
                   "friction", "restitution", "overflow")


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Failures:
    """World-calls that dropped a contact row (``overflow`` rose) or left a
    non-finite pose or velocity, counted on the device."""

    def __init__(self, batch):
        import torch
        self.prev = batch.overflow.clone()
        self.count = torch.zeros((), dtype=torch.int64, device=batch.device)

    def update(self, batch) -> None:
        import torch
        total = (batch.pos.sum((1, 2)) + batch.quat.sum((1, 2))
                 + batch.linvel.sum((1, 2)) + batch.angvel.sum((1, 2)))
        bad = (batch.overflow != self.prev) | ~torch.isfinite(total)
        self.count += bad.sum()
        self.prev.copy_(batch.overflow)


def snapshot(batch, worlds) -> dict:
    """The sampled worlds' fields, copied on the device."""
    return {name: getattr(batch, name).index_select(0, worlds)
            for name in SNAPSHOT_FIELDS}


@dataclasses.dataclass
class Setup:
    cfg: dict
    traffic: dict
    pool: object
    batch: object
    resets: object
    step: object
    dynamic_per_world: int


def build(cfg: dict, traffic: dict, seed: int, device, step_factory=None):
    """The cell's worlds, resets and step function."""
    config = traffic_m.engine_config(cfg)
    pool = traffic_m.pool(cfg, traffic, seed)
    batch = traffic_m.initial_batch(pool, traffic, device)
    resets = traffic_m.Resets(pool, traffic, device)
    dynamic = (pool.inv_mass > 0).sum(1)
    if not bool((dynamic == dynamic[0]).all()):
        raise ValueError("the pool's worlds differ in their dynamic bodies")
    if step_factory is None:
        from rl_ode_physics_tpu_torch.parallel.batch import (
            make_batched_step_fn)
        step_factory = make_batched_step_fn
    per_call = int(traffic["substeps_per_call"])
    step = step_factory(config, substeps=per_call, donate=True,
                        unroll=per_call, device=device)
    return Setup(cfg, traffic, pool, batch, resets, step, int(dynamic[0]))


def _draw_samples(traffic: dict, seed: int, expected_calls: int):
    """(sampled worlds, sampled window calls) from the seed: the calls
    among the first half of those the window is expected to hold."""
    r = traffic_m.rng(seed, 3)
    spec = traffic["sample"]
    worlds = np.sort(r.choice(int(traffic["worlds"]),
                              size=min(int(spec["worlds"]),
                                       int(traffic["worlds"])),
                              replace=False))
    span = max(1, expected_calls // 2)
    calls = np.sort(r.choice(span, size=min(int(spec["calls"]), span),
                             replace=False))
    return worlds, [int(c) for c in calls]


def run(cfg: dict, traffic: dict, seed: int, seconds: float, t0: float,
        device="cuda", step_factory=None, traced_calls=None) -> dict:
    """A whole run but the check: set-up, the window and, with
    ``traced_calls`` (a function of the measured seconds a call that gives
    how many calls to trace), the traced calls under ``torch.profiler``.
    ``t0``: the host clock at the process's start, where set-up begins."""
    import torch
    s = build(cfg, traffic, seed, device, step_factory)
    per_call = int(traffic["substeps_per_call"])
    warm_calls = max(1, int(traffic["warmup_substeps"]) // per_call)
    batch, resets, step = s.batch, s.resets, s.step
    start_worlds = torch.as_tensor(
        _draw_samples(traffic, seed, 2)[0], device=device)
    samples = []

    call = 0
    warm_ms = []
    fail = Failures(batch)
    for _ in range(warm_calls):
        ta = time.perf_counter()
        resets.apply(batch, call)
        if call == 0:
            before = snapshot(batch, start_worlds)
        batch = step(batch)
        if call == 0:
            samples.append(dict(call=-1, worlds=start_worlds,
                                before=before,
                                after=snapshot(batch, start_worlds)))
        fail.update(batch)
        _sync(device)
        warm_ms.append((time.perf_counter() - ta) * 1e3)
        call += 1
    tail = warm_ms[-min(8, len(warm_ms)):]
    est_ms = max(float(np.median(tail)), 1e-3)
    worlds, sample_calls = _draw_samples(
        traffic, seed, int(seconds * 1e3 / est_ms))
    worlds_t = torch.as_tensor(worlds, device=device)
    fail.count.zero_()              # the window counts its own calls only
    _sync(device)
    setup_s = time.perf_counter() - t0

    call_ms, host_ms = [], []
    k = 0
    t_start = time.perf_counter()
    while True:
        ta = time.perf_counter()
        resets.apply(batch, call)
        sampled = k in sample_calls
        if sampled:
            before = snapshot(batch, worlds_t)
        batch = step(batch)
        tb = time.perf_counter()
        if sampled:
            samples.append(dict(call=k, worlds=worlds_t, before=before,
                                after=snapshot(batch, worlds_t)))
        fail.update(batch)
        _sync(device)
        tc = time.perf_counter()
        call_ms.append((tc - ta) * 1e3)
        host_ms.append((tb - ta) * 1e3)
        k += 1
        call += 1
        if tc - t_start >= seconds:
            break
    window_s = tc - t_start
    failed = int(fail.count)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    trace = None
    if traced_calls is not None:
        from benchlib import trace as trace_m
        n = traced_calls(window_s / k)
        trace, batch, call = trace_m.traced(batch, step, resets, fail, call,
                                            n, device)
        trace["traced_substeps"] = n * per_call

    for sample in samples:
        sample["worlds"] = sample["worlds"].cpu().numpy()
        for side in ("before", "after"):
            sample[side] = {name: t.cpu().numpy()
                            for name, t in sample[side].items()}
    out = dict(
        setup_s=setup_s, window_s=window_s, calls=k, call_ms=call_ms,
        host_ms=host_ms, failed=failed,
        attempted=k * int(traffic["worlds"]),
        body_substeps=k * per_call * int(traffic["worlds"])
        * s.dynamic_per_world,
        memory_peak_bytes=int(peak), samples=samples,
        warm_calls=warm_calls, trace=trace, setup=s)
    # the program's state goes before the reference runs
    s.batch = s.step = s.resets = None
    del batch, step, resets, fail
    return out
