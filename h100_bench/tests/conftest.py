"""Shared set-up of the harness's tests: the import paths and a tiny run
of a cell on the CPU."""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_traffic(traffic: dict, worlds: int = 4, warm: int = 4) -> dict:
    """A cell's traffic cut to ``worlds`` worlds and ``warm`` warm-up
    substeps, every world sampled: a size a CPU test run holds."""
    return dict(traffic, worlds=worlds,
                pool_worlds=min(int(traffic["pool_worlds"]), worlds),
                warmup_substeps=warm,
                sample=dict(traffic["sample"], worlds=worlds, calls=2))


def low_rain(cfg: dict) -> dict:
    """A rain scene's bodies dropped from 1 to 3 m, so that a run of a few
    substeps has contacts."""
    for spec in cfg["scenes"].values():
        if "rain" in spec:
            spec["rain"]["y"] = [1.0, 3.0]
    return cfg


def tiny_run(cell_name: str, step_factory=None, seed: int = 5,
             seconds: float = 0.4, worlds: int = 4, warm: int = 4):
    """(numbers, correct, rows, out) of a tiny run on the CPU through the
    harness of ``cell_name`` (``<config>.<traffic>``, from the files
    whether or not ``BENCHMARK.json`` lists the cell), with
    ``step_factory`` in place of the program's ``make_batched_step_fn``
    when given, and a rain scene dropped low (``low_rain``)."""
    import json
    from benchlib import checks, manifest, window
    config, traffic_name = cell_name.split(".", 1)
    with open(BENCH / "configs" / f"{config}.json") as f:
        cfg = low_rain(json.load(f))
    traffic = tiny_traffic(manifest.traffic_of({"traffic": traffic_name}),
                           worlds, warm)
    out = window.run(cfg, traffic, seed, seconds, time.perf_counter(),
                     device="cpu", step_factory=step_factory)
    numbers = checks.check(manifest.reference(cfg["reference"]),
                           out["samples"], out["setup"])[0]
    correct, rows = checks.judge(numbers, cfg["limits"])
    return numbers, correct, rows, out
