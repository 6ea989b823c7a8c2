"""Run one cell of the port's benchmark on the card and print its result.

    python3 h100_bench/run.py --workload arena64-hb8.settled-8192 \\
        --seed 12345 --seconds 50 --trace 0

The cell names a configuration (``h100_bench/configs/<config>.json``) and
a traffic mix (``h100_bench/traffic/<traffic>.json``); ``BENCHMARK.json``
lists the cells and their metrics. A run builds the seeded worlds, warms
up and captures the cell's step (set-up, ``setup_s``), steps the batch in
closed loop for ``--seconds`` (the window), then checks the sampled calls
against the plain reference (``h100_bench/reference/``). With
``--trace 0`` it reports the cell's end-to-end metrics; with
``--trace 1`` a few more calls run under ``torch.profiler`` after the
window and it reports the per-layer metrics (``h100_bench/metrics/``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (world-calls), ``metrics``, ``device``,
``breakdown`` (traced runs) and ``checks``, each number compared with its
limit; the same comparisons are the last lines of standard error. With no
CUDA card, or with JAX or the JAX package loaded in the process, it
prints no result and exits with another code than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's and the libraries' build caches live in the checkout, at
# fixed paths, so that only a cell's first run there builds
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(ROOT))

from benchlib import checks, manifest, stats, window  # noqa: E402

# calls traced in a --trace 1 run: about 0.3 s of calls, 4 to 32 of them
TRACE_SECONDS = 0.3


def traced_calls(seconds_per_call: float) -> int:
    return int(min(32, max(4, math.ceil(TRACE_SECONDS / seconds_per_call))))


def end_to_end(out: dict) -> dict:
    return {
        "body_steps_per_s": stats.rate(out["body_substeps"], out["window_s"]),
        "call_ms_p95": stats.percentile(out["call_ms"], 95),
        "setup_s": out["setup_s"],
    }


def per_layer(bench: dict, name: str, out: dict,
              root: Path = manifest.ROOT) -> dict:
    ctx = dict(out["trace"], host_ms=out["host_ms"], call_ms=out["call_ms"],
               cell=name)
    values = {}
    for m in manifest.metrics_of(bench, name, "per_layer"):
        value = manifest.reader(m["name"], root)(ctx)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    return values


def emit(result: dict) -> int:
    """Print the result's line, last on standard output; or, where the
    process holds JAX or the JAX package (a reader or the reference may
    have loaded it after the window), name it on standard error, print no
    result and return 4."""
    found = checks.forbidden_modules()
    if found:
        print(f"h100_bench: the process holds {found}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config_of(bench, cell)
    traffic = manifest.traffic_of(cell)

    import torch
    if not torch.cuda.is_available():
        print("h100_bench: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"h100_bench: {cell['chips']} cards wanted, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda:0"

    out = window.run(cfg, traffic, args.seed, args.seconds, T0,
                     device=device,
                     traced_calls=traced_calls if args.trace else None)
    found = checks.forbidden_modules()
    if found:
        print(f"h100_bench: the process holds {found} after the window",
              file=sys.stderr)
        return 4

    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        metrics = per_layer(bench, cell["name"], out)
        device_info["busy_s"] = out["trace"]["busy_s"]
        device_info["window_s"] = out["trace"]["window_s"]
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {name: {"value": value, "unit": units[name]}
                   for name, value in end_to_end(out).items()
                   if name in units}

    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    try:
        reference = manifest.reference(cfg["reference"])
        numbers = checks.check(reference, out["samples"], out["setup"])[0]
    except Exception:  # a reference that fails judges nothing correct
        traceback.print_exc()
        numbers = {}
    ref_s = time.perf_counter() - t_ref
    correct, rows = checks.judge(numbers, cfg["limits"])
    correct = correct and numbers.get("world_calls", 0) > len(
        out["samples"][0]["worlds"])

    print(f"# {cell['name']} seed {args.seed}: {out['calls']} calls in "
          f"{out['window_s']:.3f} s, set-up {out['setup_s']:.3f} s, "
          f"{out['warm_calls']} warm-up calls, reference {ref_s:.1f} s over "
          f"{numbers.get('world_calls')} world-calls", file=sys.stderr)
    if args.trace:
        n = (out["trace"]["traced_substeps"]
             // int(traffic["substeps_per_call"]))
        print(f"# traced {n} calls in {out['trace']['window_s']:.4f} s; "
              f"untraced median call "
              f"{stats.percentile(out['call_ms'], 50):.3f} ms",
              file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)

    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if args.trace:
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
