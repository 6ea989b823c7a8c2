"""What the banded sweep-and-prune pair phase costs against the dense one at
512 slots, on the card.

The port of ``benchmarks/sap_cost_analysis.py``, which compiled the chunk
program of both pair phases and compared XLA's cost analysis (flops,
bytes accessed) and an HLO op census (sort, copy). Here the same program
(``rl_ode_physics_tpu_torch.bench.bench_config`` at ``BENCH_BODIES``
slots, ``BENCH_CHUNK`` worlds, the dense pair phase, then
``sap_window=BENCH_SAP_W``) runs eagerly under
``utils/roofline.count_substeps``, which counts the bytes, the
matmul-family flops and every dispatched ATen operation that launches a
kernel:

* ``flops/substep`` and ``bytes/substep`` as ``utils/roofline`` counts
  them;
* ``aten_ops`` (the JAX script's ``hlo_instructions``): the operations of
  a launch of ``BENCH_SUBSTEPS`` substeps, and ``top_ops`` the 12
  commonest; HLO text holds a scan's body once, whereas every substep
  here dispatches its operations anew;
* ``sort``, ``copy`` (``copy_``, ``_to_copy`` and ``clone``) and ``cat``;
  the JAX script's ``fusion`` has no counterpart (eager PyTorch fuses
  nothing);
* ``overflow``: the rows the run dropped over all ``BENCH_SUBSTEPS``
  substeps, the SAP window's misses among them (both go to
  ``WorldState.overflow``).

The program is shape-bound (fixed buffers), so the count is taken over
the first ``COUNTED_SUBSTEPS`` = 2 substeps and scaled to
``BENCH_SUBSTEPS``; the remaining substeps run uncounted to read the
overflow at the launch's end. Then the ratio line: SAP over dense in bytes
and flops, and the differences in operations (``instr_delta`` is that of
``aten_ops``), sorts, copies and ``cat``::

    python3 -m rl_ode_physics_tpu_torch.utils.sap_cost_analysis \\
        [--device cpu]

``BENCH_BODIES`` (512), ``BENCH_CHUNK`` (16), ``BENCH_SUBSTEPS`` (24),
``BENCH_SAP_W`` (160). Runs on the card; ``--device cpu`` only when asked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from rl_ode_physics_tpu_torch.utils.roofline import (
    COUNTED_SUBSTEPS, count_substeps)

COPIES = ("copy_", "_to_copy", "clone")
TOP = 12


def census(config, num_bodies: int, chunk: int, substeps: int,
           device="cuda") -> dict:
    """The JAX script's row for one pair phase: ``config`` stepped at
    ``chunk`` worlds of ``bench_world``, counted over the first
    ``COUNTED_SUBSTEPS`` substeps and scaled to ``substeps``, with the
    overflow after all of them."""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    counted = min(COUNTED_SUBSTEPS, substeps)
    world = scenes.bench_world(config, num_bodies=num_bodies - 4,
                               device=device)
    c = count_substeps(config, replicate(world, chunk, device=device),
                       counted)
    state = c["state"]
    if substeps > counted:
        state = make_batched_step_fn(config, substeps=substeps - counted,
                                     device=device)(state)
    scale = substeps / counted
    ops = c["ops"]
    return {
        "flops/substep": c["flops"] / counted,
        "bytes/substep": c["bytes"] / counted,
        "aten_ops": round(sum(ops.values()) * scale),
        "top_ops": [(name, round(n * scale))
                    for name, n in ops.most_common(TOP)],
        "sort": round(ops["sort"] * scale),
        "copy": round(sum(ops[name] for name in COPIES) * scale),
        "cat": round(ops["cat"] * scale),
        "overflow": int(state.overflow.sum()),
        "substeps": substeps,
        "counted_substeps": counted,
    }


def ratio_line(dense: dict, sap: dict) -> dict:
    """``benchmarks/sap_cost_analysis.py:74-80``'s line, and ``cat``."""
    return {
        "bytes_ratio_sap_over_dense": sap["bytes/substep"]
        / dense["bytes/substep"],
        "flops_ratio": sap["flops/substep"] / max(dense["flops/substep"],
                                                  1.0),
        "instr_delta": sap["aten_ops"] - dense["aten_ops"],
        "sort_delta": sap["sort"] - dense["sort"],
        "copy_delta": sap["copy"] - dense["copy"],
        "cat_delta": sap["cat"] - dense["cat"],
    }


def run(num_bodies: int = 512, chunk: int = 16, substeps: int = 24,
        sap_w: int = 160, device="cuda") -> dict:
    """Both rows, printed as the JAX script prints them with the card's
    name and power limit (``"cpu"`` on the CPU), and the ratio line;
    returns {"dense": ..., "sap": ..., "ratio": ...}."""
    from rl_ode_physics_tpu_torch.bench import bench_config
    from rl_ode_physics_tpu_torch.utils.timing import card_label
    card = card_label(device)
    results = {}
    for label, sap in (("dense", 0), ("sap", sap_w)):
        cfg = bench_config(num_bodies).replace(sap_window=sap).validate()
        results[label] = dict(census(cfg, num_bodies, chunk, substeps,
                                     device), card=card)
        print(label, json.dumps(results[label], indent=1), flush=True)
    results["ratio"] = ratio_line(results["dense"], results["sap"])
    print(json.dumps(results["ratio"], indent=1), flush=True)
    return results


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)
    require_card("sap_cost_analysis", args.device)
    env = os.environ
    run(num_bodies=int(env.get("BENCH_BODIES", 512)),
        chunk=int(env.get("BENCH_CHUNK", 16)),
        substeps=int(env.get("BENCH_SUBSTEPS", 24)),
        sap_w=int(env.get("BENCH_SAP_W", 160)), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
