"""Capacity audit on the card: measured live-contact and pair peaks of the
bench scene against the bench's capacities.

The port of ``benchmarks/capacity_audit.py``. The bench's buffer
capacities must hold every contact its workload makes: a capacity signed
off on the TPU (``benchmarks/audited_capacities.json``) may not hold on
the card, whose float32 products are exact where the TPU's default
rounds to bf16, so that trajectories settle otherwise. This audit runs
the bench scene under both policies of ``core/config.bench_config`` (the
hb-8 headline and the plain-20 parity line) at their exact capacities,
over seeds × substeps, and prints each seed's live-contact peak, its
candidate-pair peak in each typed bucket (sphere-sphere, sphere-box,
box-box, counted from ``narrowphase._pair_eligibility`` as the JAX
script does), and its cumulative overflow::

    python3 -m rl_ode_physics_tpu_torch.utils.capacity_audit \\
        [--bodies 64] [--steps 500] [--seeds 42,7,...] [--sign] [--compare]

The JAX script runs each seed as its own world under a ``lax.scan`` of 50
substeps; here the seeds are the worlds of one batch, stepped through
``core/world.step_with_diagnostics``, and the running maxima stay on the
card until each chunk of 50 substeps ends (a run covers whole chunks, as
the JAX script's does). ``--platform`` is ``cuda`` (default) or ``cpu``.
``main`` exits non-zero if any seed overflowed, after auditing both
policies.

``--sign`` records each clean policy in ``build/audited_capacities.json``
(never in ``benchmarks/``), keyed by ``capacity_signature``, with
``"platform"`` the card's name and power limit. ``--compare`` prints each
signature's peaks on this device beside the TPU registry's and the caps.
``audited_capacities_h100.json`` beside this module is a clean audit taken
on the H100 this way (PERF.md §6 names the run).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import bench_config

ROOT = Path(__file__).resolve().parents[2]
REGISTRY = ROOT / "benchmarks" / "audited_capacities.json"
CARD_REGISTRY = Path(__file__).resolve().parent / "audited_capacities_h100.json"
SIGNED = ROOT / "build" / "audited_capacities.json"
BUCKETS = ((1, 1), (1, 2), (2, 2))
BUCKET_NAMES = ("ss", "sb", "bb")
CHUNK = 50


def capacity_signature(config, num_bodies: int) -> str:
    """The capacity-relevant configuration key of
    ``benchmarks/capacity_audit.py:60``: what changes how many contacts and
    pairs the workload makes or the buffers hold."""
    caps = ",".join(f"{a}{b}:{c}" for a, b, c in config.bucket_caps) \
        if config.typed_buckets else "classic"
    return (f"bodies={num_bodies}|solver={config.solver.value}"
            f"|iters={config.solver_iterations}"
            f"|omega={config.jacobi_omega}|beta={config.jacobi_beta}"
            f"|C={config.max_contacts}|K={config.max_contacts_per_pair}"
            f"|caps={caps}|friction={config.friction}")


def load_registry(path=REGISTRY) -> dict:
    """A registry of signed-off capacities, read only: by default the TPU's,
    ``benchmarks/audited_capacities.json``; ``CARD_REGISTRY`` is the
    H100's."""
    path = Path(path)
    if path.exists():
        with open(path) as fh:
            return json.load(fh)
    return {}


def bucket_counts(state) -> torch.Tensor:
    """(B, 3) int32: the candidate pairs of each world in the sphere-sphere,
    sphere-box and box-box buckets."""
    from rl_ode_physics_tpu_torch.ops.narrowphase import _pair_eligibility
    hit, tmin, tmax = _pair_eligibility(state)
    return torch.stack(
        [(hit & (tmin == a) & (tmax == b)).sum((1, 2), dtype=torch.int32)
         for a, b in BUCKETS], -1)


def audit_config(config, num_bodies: int, steps: int, seeds,
                 chunk: int = CHUNK, device="cuda"):
    """Run the bench scene under ``config``, one world a seed; return
    ``[(seed, peak_contacts, peak_pairs (3,) int64, overflow,
    first_overflow)]``: the JAX ``audit_config``'s list, and the substep
    that ended the first chunk with an overflow in that world (None if
    none did). Runs ``ceil(steps / chunk) * chunk`` substeps, and reads the
    running maxima back once a chunk."""
    from rl_ode_physics_tpu_torch.core.world import step_with_diagnostics
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import concat_worlds

    batch = concat_worlds([
        scenes.bench_world(config, num_bodies=num_bodies - 4, seed=seed,
                           device=device) for seed in seeds])
    peak_c = torch.zeros(len(seeds), dtype=torch.int32, device=device)
    peak_b = torch.zeros((len(seeds), 3), dtype=torch.int32, device=device)
    first = [None] * len(seeds)
    for n in range(math.ceil(steps / chunk)):
        for _ in range(chunk):
            batch, m = step_with_diagnostics(batch, config)
            peak_c = torch.maximum(peak_c, m["num_contacts"])
            peak_b = torch.maximum(peak_b, bucket_counts(batch))
        host = torch.cat([peak_c[:, None], peak_b,
                          batch.overflow[:, None].to(torch.int32)],
                         1).cpu().numpy()
        first = [f if f is not None or not row[4] else (n + 1) * chunk
                 for f, row in zip(first, host)]
    return [(seed, int(row[0]), row[1:4].astype(np.int64), int(row[4]), f)
            for seed, row, f in zip(seeds, host, first)]


def audit(bodies: int = 64, steps: int = 500,
          seeds=(42, 7, 123, 999, 5, 17, 314, 2718), device="cuda") -> list:
    """Both policies of ``bench_config(bodies)`` (``parity`` False, then
    True), audited over ``seeds``: a dict a policy with its ``label``,
    ``signature``, capacities, per-seed peaks, worst peaks, total overflow
    and the TPU registry's entry for the signature (or None)."""
    registry = load_registry()
    out = []
    for parity in (False, True):
        config = bench_config(bodies, parity=parity)
        results = audit_config(config, bodies, steps, seeds, device=device)
        sig = capacity_signature(config, bodies)
        worst_b = np.max([r[2] for r in results], axis=0)
        out.append(dict(
            label="parity plain-20" if parity else "headline hb-8",
            signature=sig, steps=steps, seeds=list(seeds),
            max_contacts=config.max_contacts,
            caps={f"{a}{b}": c for a, b, c in config.bucket_caps},
            per_seed=[dict(seed=seed, peak_contacts=pc,
                           peak_pairs=dict(zip(BUCKET_NAMES, map(int, pb))),
                           overflow=ovf, first_overflow_by_substep=first)
                      for seed, pc, pb, ovf, first in results],
            peak_contacts=max(r[1] for r in results),
            peak_pairs=dict(zip(BUCKET_NAMES, map(int, worst_b))),
            overflow=sum(r[3] for r in results),
            tpu=registry.get(sig)))
    return out


def sign(entries, platform: str, path=None) -> list:
    """Record each clean entry of ``audit`` in the registry at ``path``
    (default ``SIGNED``; created or extended), with ``platform``; returns
    the signatures signed."""
    path = Path(path or SIGNED)
    registry = load_registry(path)
    signed = []
    for e in entries:
        if e["overflow"]:
            continue
        registry[e["signature"]] = {
            "steps": e["steps"], "seeds": e["seeds"], "platform": platform,
            "peak_contacts": e["peak_contacts"], "peak_pairs": e["peak_pairs"],
            "max_contacts": e["max_contacts"], "caps": e["caps"]}
        signed.append(e["signature"])
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(registry, fh, indent=1, sort_keys=True)
    return signed


def compare_line(e: dict) -> str:
    """This device's worst peaks beside the TPU registry's and the caps."""
    tpu = e["tpu"]
    if tpu is None:
        return f"compare {e['label']}: no TPU entry for {e['signature']}"
    parts = [f"contacts {e['peak_contacts']} (tpu {tpu['peak_contacts']}, "
             f"cap {e['max_contacts']})"]
    for name, key in zip(BUCKET_NAMES, ("11", "12", "22")):
        parts.append(f"{name} {e['peak_pairs'][name]} "
                     f"(tpu {tpu['peak_pairs'][name]}, cap {e['caps'][key]})")
    return (f"compare {e['label']}: " + ", ".join(parts)
            + f"; tpu audit {tpu['steps']} steps x {len(tpu['seeds'])} seeds")


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bodies", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seeds", default="42,7,123,999,5,17,314,2718")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="the device to audit on (default: the card)")
    ap.add_argument("--sign", action="store_true",
                    help="record each clean policy in "
                         "build/audited_capacities.json")
    ap.add_argument("--compare", action="store_true",
                    help="print the peaks beside the TPU registry's")
    args = ap.parse_args(argv)
    card = require_card("capacity_audit", args.platform)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    entries = audit(args.bodies, args.steps, seeds, args.platform)
    for e in entries:
        caps = e["caps"]
        print(f"== {e['label']}: C={e['max_contacts']} caps={caps} "
              f"({args.steps} steps x {len(seeds)} seeds, "
              f"platform={card})")
        for s in e["per_seed"]:
            pb = s["peak_pairs"]
            flag = ("" if s["overflow"] == 0 else
                    f"  *** OVERFLOW *** by substep "
                    f"{s['first_overflow_by_substep']}")
            print(f"{e['label']}: seed {s['seed']}: peak contacts "
                  f"{s['peak_contacts']}/{e['max_contacts']}, bucket pair "
                  f"peaks ss={pb['ss']}/{caps['11']} sb={pb['sb']}/"
                  f"{caps['12']} bb={pb['bb']}/{caps['22']}, overflow "
                  f"{s['overflow']}{flag}")
        if args.compare:
            print(compare_line(e))
    if args.sign:
        for sig in sign(entries, card):
            print(f"signed off: {sig}")
    bad = [e["label"] for e in entries if e["overflow"]]
    if bad:
        print(f"{', '.join(bad)} dropped contacts: caps under-sized",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
