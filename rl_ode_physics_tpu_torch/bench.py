"""Throughput benchmark on the card: body-steps/s on the BASELINE config 4
workload.

The port of the repository's ``bench.py``. Workload: 8,192 worlds × 64
slots (the grassPlane arena and 60 stacked dynamic bodies a world), fixed
contact buffers, 120 Hz substeps, ``BENCH_SUBSTEPS`` of them a launch of
the batched step. Prints ONE JSON line last on stdout::

    {"metric": ..., "value": N, "unit": "body-steps/sec", "vs_baseline": N}

``vs_baseline`` is ``value / BASELINE_BODY_STEPS_PER_S``, the ratio
``bench.py`` prints, to the 50M body-steps/s that BASELINE.md sets for a
TPU v5e-8; it is kept so that the two lines read alike, and is no target
for this card. The parity line (plain Jacobi, omega 1, beta 0, 20
iterations, the ODE QuickStep budget) on the same workload follows on
stderr as ``# parity: {...}`` unless ``BENCH_PARITY=0``;
``BENCH_ONLY=parity`` measures only that line and prints it on stdout.
The ``# aux`` line on stderr gives the solver's selector-product rate and
the card's name and power limit::

    python3 -m rl_ode_physics_tpu_torch.bench [--device cpu]

The JAX script's environment variables, with its defaults:
``BENCH_WORLDS``, ``BENCH_BODIES``, ``BENCH_STEPS``, ``BENCH_SUBSTEPS``,
``BENCH_UNROLL`` (4), ``BENCH_CHUNK``, ``BENCH_PARITY``, ``BENCH_ONLY`` and
the configuration's overrides of ``bench_config``; the step donates the
batch, as the JAX script's does. On the card a launch of the batched step
replays CUDA graphs of ``BENCH_UNROLL`` substeps (``utils/graphs.py``, the
port's form of the JAX scan's unroll), ``BENCH_SUBSTEPS // BENCH_UNROLL``
graph launches and one of the remainder. One default differs:
``BENCH_CHUNK`` is 0, the whole batch a launch, where the JAX script's is
256: a chunk here is a copy into the chunk-sized graph and back, chunk
after chunk, and which default the card wants is not settled yet.

Each run must pass ``require_audit`` against the card's sign-off,
``utils/audited_capacities_h100.json``, and any contact dropped during the
run raises. Runs on the card; ``--device cpu`` only when asked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from rl_ode_physics_tpu_torch.core import config as core_config
from rl_ode_physics_tpu_torch.core.config import SolverKind

# BASELINE.md:24, the body-steps/s target set for a TPU v5e-8 that
# bench.py's vs_baseline divides by; no target for this card
BASELINE_BODY_STEPS_PER_S = 50e6
WARMUP_LAUNCHES = 3


def _sync(batch) -> None:
    """``torch.cuda.synchronize()`` and one scalar read back, where the JAX
    script calls ``block_until_ready``."""
    if batch.pos.is_cuda:
        torch.cuda.synchronize(batch.pos.device)
    batch.pos[0, 0].cpu()


def _measure(config, num_worlds, num_bodies, substeps, launches, chunk,
             unroll, device="cuda"):
    """Run the workload under ``config``: 3 warm-up launches (the first
    captures the graphs on the card), then ``launches`` timed ones of
    ``substeps`` substeps, ``unroll`` a graph, the batch donated; return
    (value, dt, num_dynamic). Raises on any dropped contact."""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = scenes.bench_world(config, num_bodies=num_bodies - 4,
                               device=device)
    batch = replicate(world, num_worlds, device=device)
    step_fn = make_batched_step_fn(config, substeps=substeps, donate=True,
                                   chunk=chunk, unroll=unroll,
                                   device=device)

    # warm-up: let the stacks reach their contact-rich steady state
    for _ in range(WARMUP_LAUNCHES):
        batch = step_fn(batch)
    _sync(batch)
    t0 = time.perf_counter()
    for _ in range(launches):
        batch = step_fn(batch)
    _sync(batch)
    dt = time.perf_counter() - t0

    total_steps = launches * substeps
    # only DYNAMIC bodies count (the 4 static arena geoms are not
    # integrated or solved: 60 of the 64 slots are dynamic)
    num_dynamic = int((world.inv_mass > 0).sum())
    # capacity honesty: a configuration whose buffers drop contacts
    # benchmarks a physically wrong workload; WorldState.overflow
    # accumulates every dropped row
    total_overflow = int(batch.overflow.sum())
    if total_overflow:
        raise RuntimeError(
            f"contact capacity overflow during the bench: {total_overflow} "
            f"dropped rows across {num_worlds} worlds — max_contacts/"
            f"bucket_caps are under-sized for this solver setting; re-run "
            f"rl_ode_physics_tpu_torch.utils.capacity_audit and raise "
            f"BENCH_CONTACTS")
    return num_worlds * num_dynamic * total_steps / dt, dt, num_dynamic


def _result(config, value, dt, num_worlds, num_bodies, num_dynamic,
            total_steps, note="", chunk=0, unroll=1):
    return {
        "metric": f"body-steps/sec ({num_worlds} worlds x {num_dynamic} "
                  f"dynamic bodies (of {num_bodies} slots), "
                  f"{total_steps} substeps in {dt:.3f}s, "
                  f"unroll {unroll}, "
                  f"{config.solver_iterations} solver iters "
                  f"(omega={config.jacobi_omega}, hb beta={config.jacobi_beta}"
                  f"{note}), solver={config.solver.value}, TF32 off, "
                  f"{f'chunk {chunk}' if chunk else 'unchunked'})",
        "value": value,
        "unit": "body-steps/sec",
        "vs_baseline": value / BASELINE_BODY_STEPS_PER_S,
    }


def _bucket_caps(num_bodies: int):
    """Typed-bucket pair caps for the bench shapes
    (``core/config.bench_bucket_caps``); ``BENCH_CAPS='ss,sb,bb'``
    overrides."""
    env = os.environ.get("BENCH_CAPS")
    if env:
        ss, sb, bb = (int(x) for x in env.split(","))
        return ((1, 1, ss), (1, 2, sb), (2, 2, bb))
    return core_config.bench_bucket_caps(num_bodies)


def bench_config(num_bodies: int, parity: bool = False):
    """The exact configuration the bench runs for this shape,
    ``bench.bench_config`` field by field: the throughput policy with the
    bench's capacities (``core/config.bench_config``) and the JAX script's
    environment overrides, with its defaults. On the card the contact
    compaction is the ``compact_rows_t`` kernel whatever
    ``pallas_compaction`` (``BENCH_PALLAS_COMPACT``) says.
    ``parity=True``: the ODE-parity plain-20 line, with
    ``2 * num_bodies`` contact rows."""
    env = os.environ
    base = core_config.bench_config(num_bodies)
    config = base.replace(
        solver=SolverKind[env.get("BENCH_SOLVER", "jacobi").upper()],
        solver_iterations=int(env.get("BENCH_ITERS", 8)),
        jacobi_omega=float(env.get("BENCH_OMEGA", 1.3)),
        jacobi_beta=float(env.get("BENCH_BETA", 0.9)),
        solver_loop_unroll=int(env.get("BENCH_SOLVER_UNROLL", 1)),
        friction=env.get("BENCH_FRICTION", "1") != "0",
        max_contacts=int(env.get("BENCH_CONTACTS", base.max_contacts)),
        solver_matmul_dtype=env.get("BENCH_MM_DTYPE", "float32"),
        selector_dtype=env.get("BENCH_SEL_DTYPE", base.selector_dtype),
        typed_buckets=env.get("BENCH_TYPED", "1") != "0",
        bucket_caps=_bucket_caps(num_bodies),
        pallas_compaction=env.get("BENCH_PALLAS_COMPACT", "0") != "0",
        cm_narrowphase=env.get("BENCH_CM", "1") != "0",
        solver_cm=env.get("BENCH_SOLVER_CM", "0") != "0",
        sap_window=int(env.get("BENCH_SAP", 0)),
    ).validate()
    if parity:
        config = config.replace(
            solver_iterations=20, jacobi_omega=1.0, jacobi_beta=0.0,
            max_contacts=2 * num_bodies)
    return config


def require_audit(config, num_bodies: int, total_substeps: int,
                  registry=None) -> None:
    """Refuse a capacity configuration that the card's audit has not signed
    off, or signed off at fewer substeps than the bench runs (contact and
    pair peaks deepen as the piles densify). ``registry``: the sign-offs
    (default: ``utils/audited_capacities_h100.json``; the TPU's registry
    does not hold on the card, whose float32 products are exact, ROADMAP
    C2). ``BENCH_ALLOW_UNAUDITED=1`` skips the check with a warning; the
    overflow counter still fails a run that drops a contact."""
    if os.environ.get("BENCH_ALLOW_UNAUDITED") == "1":
        print("# WARNING: BENCH_ALLOW_UNAUDITED=1 — capacity signature "
              "not checked; overflow counter is the only guard",
              file=sys.stderr)
        return
    from rl_ode_physics_tpu_torch.utils.capacity_audit import (
        CARD_REGISTRY, capacity_signature, load_registry)
    if registry is None:
        registry = load_registry(CARD_REGISTRY)
    sig = capacity_signature(config, num_bodies)
    entry = registry.get(sig)
    if entry is None:
        raise RuntimeError(
            f"UNAUDITED capacity configuration: no sign-off for\n  {sig}\n"
            f"in rl_ode_physics_tpu_torch/utils/audited_capacities_h100.json."
            f" Run\n  python3 -m rl_ode_physics_tpu_torch.utils.capacity_audit"
            f" --bodies {num_bodies} --steps {max(total_substeps, 500)} "
            f"--sign\non the card (or set BENCH_ALLOW_UNAUDITED=1 for an "
            f"exploratory sweep).")
    if entry["steps"] < total_substeps:
        raise RuntimeError(
            f"audit horizon too shallow for this schedule: signed off at "
            f"{entry['steps']} substeps, bench runs {total_substeps} "
            f"(peaks deepen as piles densify). Re-run capacity_audit "
            f"--bodies {num_bodies} --steps {total_substeps} --sign.")


def solver_flops(config) -> int:
    """The solver's two (2C, N)×(N, 8) selector products an iteration, per
    world and substep (``bench.py:326``)."""
    return (2 * (2 * config.max_contacts) * config.max_bodies * 8 * 2
            * config.solver_iterations)


def settings(env=os.environ) -> dict:
    """The bench's schedule from the environment, at its defaults."""
    s = dict(num_worlds=int(env.get("BENCH_WORLDS", 8192)),
             num_bodies=int(env.get("BENCH_BODIES", 64)),
             substeps=int(env.get("BENCH_SUBSTEPS", 96)),
             launches=int(env.get("BENCH_STEPS", 3)),
             chunk=int(env.get("BENCH_CHUNK", 0)),
             unroll=int(env.get("BENCH_UNROLL", 4)))
    if (not s["chunk"] or s["num_worlds"] <= s["chunk"]
            or s["num_worlds"] % s["chunk"]):
        s["chunk"] = 0
    return s


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)
    card = require_card("bench", args.device)
    s = settings()
    num_worlds, num_bodies = s["num_worlds"], s["num_bodies"]
    substeps, launches, chunk = s["substeps"], s["launches"], s["chunk"]
    unroll = s["unroll"]
    # the warm-up and timed launches all count toward the audited horizon
    horizon = (launches + WARMUP_LAUNCHES) * substeps
    total_steps = launches * substeps
    run = dict(num_worlds=num_worlds, num_bodies=num_bodies,
               substeps=substeps, launches=launches, chunk=chunk,
               unroll=unroll, device=args.device)
    parity_note = "; ODE QuickStep parity setting"

    config = bench_config(num_bodies)
    if os.environ.get("BENCH_ONLY") == "parity":
        parity_cfg = bench_config(num_bodies, parity=True)
        require_audit(parity_cfg, num_bodies, horizon)
        p_value, p_dt, num_dynamic = _measure(parity_cfg, **run)
        print(json.dumps(_result(
            parity_cfg, p_value, p_dt, num_worlds, num_bodies, num_dynamic,
            total_steps, note=parity_note, chunk=chunk, unroll=unroll)))
        return 0

    require_audit(config, num_bodies, horizon)
    value, dt, num_dynamic = _measure(config, **run)

    # the solver's selector-product rate for comparison across runs
    # (stderr; the one stdout line is the JSON)
    flops = solver_flops(config)
    print(f"# aux: {num_dynamic} dynamic bodies/world; solver selector-matmul "
          f"throughput ~{flops * num_worlds * total_steps / dt / 1e12:.2f} "
          f"TFLOP/s sustained ({flops / 1e6:.2f} MFLOP/world/substep at "
          f"C={config.max_contacts}, N={config.max_bodies}, "
          f"{config.solver_iterations} iters); slot-steps/sec (all "
          f"{num_bodies} slots) = "
          f"{num_worlds * num_bodies * total_steps / dt:.3g}; on {card}",
          file=sys.stderr)
    headline = _result(
        config, value, dt, num_worlds, num_bodies, num_dynamic, total_steps,
        note="; >= plain-20-iter convergence, see "
             "rl_ode_physics_tpu_torch/utils/solver_convergence.py",
        chunk=chunk, unroll=unroll)

    if (os.environ.get("BENCH_PARITY", "1") != "0"
            and config.solver is SolverKind.JACOBI):
        parity_cfg = bench_config(num_bodies, parity=True)
        require_audit(parity_cfg, num_bodies, horizon)
        p_value, p_dt, _ = _measure(parity_cfg, **run)
        p = _result(parity_cfg, p_value, p_dt, num_worlds, num_bodies,
                    num_dynamic, total_steps, note=parity_note, chunk=chunk, unroll=unroll)
        print("# parity: " + json.dumps(p), file=sys.stderr)

    print(json.dumps(headline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
