"""Solver µs an iteration a world (BASELINE.md's QuickStep-class metric).

The port of ``benchmarks/solver_iter.py``: the batched contact solve of a
settled bench world in ``num_worlds`` copies, timed at 5, 10, 20, 40 and 80
iterations; the least-squares slope of time against iterations, divided by
the worlds, is the marginal cost of one iteration of one world (it leaves
out the once-a-solve row and selector set-up)::

    python3 -m rl_ode_physics_tpu_torch.utils.solver_iter [num_worlds] \\
        [--device cuda]

Each count's time is the median of 5 samples of 10 solves, each sample
ended by a ``synchronize``. Prints the JAX script's JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig

ITERATIONS = (5, 10, 20, 40, 80)
SAMPLES = 5
SOLVES = 10


def run(num_worlds: int = 512, device="cuda", solves: int = SOLVES) -> dict:
    """The slope and the per-batch ms of each iteration count."""
    from rl_ode_physics_tpu_torch.core.world import make_step_fn
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import solver as sol
    from rl_ode_physics_tpu_torch.parallel.batch import replicate
    from rl_ode_physics_tpu_torch.utils.solver_convergence import (
        solver_inputs)

    base = EngineConfig(max_bodies=64, max_pair_candidates=256,
                        max_contacts=256, max_contacts_per_pair=4)
    w = scenes.bench_world(base, num_bodies=60, device=device)
    stepf = make_step_fn(base, substeps=12)
    for _ in range(15):          # contact-rich steady state
        w = stepf(w)
    batch = replicate(w, num_worlds, device=device)
    b2, cont = solver_inputs(batch, base)

    def sync():
        if b2.pos.is_cuda:
            torch.cuda.synchronize(b2.pos.device)

    times = {}
    for iters in ITERATIONS:
        cfg = base.replace(solver_iterations=iters)
        sol.solve(b2, cont, cfg)
        sync()
        got = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            for _ in range(solves):
                sol.solve(b2, cont, cfg)
            sync()
            got.append((time.perf_counter() - t0) / solves)
        times[iters] = float(np.median(got))
    ks = np.array(sorted(times))
    ts = np.array([times[k] for k in ks])
    slope = max(float(np.polyfit(ks, ts, 1)[0]), 0.0)   # s an iteration
    return {
        "metric": f"solver us/iter/world ({num_worlds} worlds, 256-contact "
                  f"buffers)",
        "value": slope / num_worlds * 1e6,
        "unit": "us/iteration/world",
        "per_batch_ms": {int(k): times[k] * 1000 for k in ks},
    }


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_worlds", type=int, nargs="?", default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = require_card("solver_iter", args.device)
    print(json.dumps(dict(run(args.num_worlds, args.device), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
