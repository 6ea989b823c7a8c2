"""Readings that the limits of ``correct`` are set from, on the card.

    python3 h100_bench/control.py --workload quickstep-f64.stack-1024 \\
        --seconds 4 --seeds 11 12 13

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
short window, the same samples), then two readings of every number the
cell's reference compares:

* ``program``: the program's state after each sampled call against the
  reference (the lower reading, over many seeds);
* ``control``: the reference put in the program's place in the nearest
  lower precision, against the reference. Where the program has such a
  path of its own it is the control: the float64 configurations run the
  program's own float32 step on the sampled worlds, tiled to the cell's
  batch; the float32 configurations run the reference with its solver's
  operands rounded to TF32.

Both are judged against the same answers of the reference
(``benchlib.checks.check``).

One JSON line a seed on standard output. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

from benchlib import checks, manifest, window  # noqa: E402
from benchlib import traffic as traffic_m  # noqa: E402


def program_f32_after(setup, before: dict, device) -> dict:
    """The program's own float32 path on the sampled worlds' ``before``
    state, tiled to the cell's batch: its state after one call."""
    import numpy as np
    import torch
    from rl_ode_physics_tpu_torch.core.state import WorldState
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    cfg = dict(setup.cfg, engine=dict(setup.cfg["engine"], dtype="float32"))
    config = traffic_m.engine_config(cfg)
    worlds = int(setup.traffic["worlds"])
    s = len(before["pos"])
    idx = np.arange(worlds) % s
    fields = {}
    for f in dataclasses.fields(WorldState):
        if f.name in before:
            a = torch.as_tensor(np.asarray(before[f.name])[idx])
        else:
            a = getattr(setup.pool, f.name)[:1].expand(
                (worlds,) + getattr(setup.pool, f.name).shape[1:])
        if a.is_floating_point():
            a = a.to(torch.float32)
        fields[f.name] = a.contiguous().to(device)
    per_call = int(setup.traffic["substeps_per_call"])
    step = make_batched_step_fn(config, substeps=per_call, donate=False,
                                unroll=per_call, device=device)
    out = step(WorldState(**fields))
    return {name: getattr(out, name)[:s].double().cpu().numpy()
            for name in ("pos", "quat", "linvel", "angvel", "overflow")}


def control_afters(reference, setup, samples, device) -> list:
    """The control's state after each sample, aligned with ``samples``."""
    import numpy as np
    out = []
    lower = setup.cfg["engine"]["dtype"] == "float64"
    for s in samples:
        if lower:
            out.append(program_f32_after(setup, s["before"], device))
            continue
        worlds = [reference.advance(s["before"], j, setup.cfg,
                                    setup.traffic, precision="tf32")
                  for j in range(len(s["before"]["pos"]))]
        out.append({k: np.stack([w[k] for w in worlds]) for k in worlds[0]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config_of(bench, cell)
    traffic = manifest.traffic_of(cell)
    reference = manifest.reference(cfg["reference"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = window.run(cfg, traffic, seed, args.seconds, t0,
                         device="cuda:0")
        torch.cuda.empty_cache()
        ctl = control_afters(reference, out["setup"], out["samples"],
                             "cuda:0")
        program, control = checks.check(reference, out["samples"],
                                        out["setup"], [ctl])
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              calls=out["calls"], failed=out["failed"],
                              program=program, control=control,
                              seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
