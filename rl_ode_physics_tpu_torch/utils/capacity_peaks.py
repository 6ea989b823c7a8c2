"""Candidate-pair and contact peaks of a workload on the card, to size a
configuration's capacities.

The port of ``tools/capacity_peaks.py``, with its two scenes::

    python3 -m rl_ode_physics_tpu_torch.utils.capacity_peaks capsule-stack
    python3 -m rl_ode_physics_tpu_torch.utils.capacity_peaks mini-stack

``capsule-stack``: BASELINE config 2 (``capsule_stack_world(num_bodies=64,
seed=7)``, 68 slots) through the classic pipeline at ``EngineConfig``'s
defaults, 648 substeps (the horizon of ``chip_smoke.py``'s capsule-stack
path: 480 settling substeps, a warm-up launch of 24 and 3 timed launches
of 48). ``mini-stack``: ``benchmarks/tpu_default_conformance.py``'s engine
and scene (``EngineConfig.throughput(max_bodies=16,
max_pair_candidates=128, max_contacts=256)``, ``mini_stack_world``), 384
substeps.

Both run one world at capacities far above any peak (nothing can be
dropped), and print the JAX tool's JSON line every ``--every`` substeps
and at the end: the peak of live contacts, of broadphase candidates
(classic) or pairs tested (typed), the peak candidates of each type pair,
the overflow counter, and where the dynamic bodies are (lowest and
highest y, fastest speed), with the card's name and power limit. The
running peaks stay on the device between those lines.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig

NAMES = {1: "sphere", 2: "box", 3: "capsule", 4: "plane"}
TYPES = 6                    # body type codes 0-5 (core/state.BodyType)
DEFAULT_SUBSTEPS = {"capsule-stack": 648, "mini-stack": 384}


def scene(name: str, device="cuda"):
    """(config, one world) of a scene, at the JAX tool's capacities."""
    from rl_ode_physics_tpu_torch.models import scenes
    if name == "capsule-stack":
        # the capacities chip_smoke.py runs are 192/192; these hold anything
        config = EngineConfig(max_bodies=68, max_pair_candidates=1024,
                              max_contacts=2048)
        return config, scenes.capsule_stack_world(config, num_bodies=64,
                                                  seed=7, device=device)
    if name == "mini-stack":
        config = EngineConfig.throughput(max_bodies=16,
                                         max_pair_candidates=128,
                                         max_contacts=256)
        return config, scenes.mini_stack_world(config, device=device)
    raise ValueError(f"unknown scene {name!r}")


def _advance(state, config):
    """One substep, and what the substep saw before it stepped: the pairs
    tested, the contacts, and the (TYPES·TYPES,) count of the pairs of
    each (lower, higher) type code."""
    from rl_ode_physics_tpu_torch.core.world import step
    from rl_ode_physics_tpu_torch.ops import broadphase, narrowphase

    if config.typed_buckets:
        hit, _, _ = narrowphase._pair_eligibility(state)
        contacts, pairs = narrowphase.narrowphase_typed(state, config)
        ia, ib = torch.nonzero(hit[0], as_tuple=True)
    else:
        cand = broadphase.broadphase(state, config)
        contacts = narrowphase.narrowphase(state, cand, config)
        pairs = cand.count
        valid = cand.valid[0]
        ia, ib = cand.ia[0][valid], cand.ib[0][valid]
    types = state.body_type[0].to(torch.int64)
    ta, tb = types[ia], types[ib]
    code = torch.minimum(ta, tb) * TYPES + torch.maximum(ta, tb)
    by_code = torch.bincount(code, minlength=TYPES * TYPES)
    return step(state, config), pairs, contacts.count, by_code


def run(scene_name: str, substeps: int | None = None, every: int = 96,
        device="cuda", card: str | None = None) -> list:
    """The JAX tool's lines, as dicts: one every ``every`` substeps and one
    at the end."""
    config, state = scene(scene_name, device)
    substeps = substeps or DEFAULT_SUBSTEPS[scene_name]
    moving = state.inv_mass[0] > 0
    peaks = torch.zeros(2, dtype=torch.int64, device=device)
    peak_codes = torch.zeros(TYPES * TYPES, dtype=torch.int64, device=device)
    lines = []
    for i in range(1, substeps + 1):
        state, pairs, count, by_code = _advance(state, config)
        peaks = torch.maximum(peaks, torch.stack(
            [torch.as_tensor(pairs, device=device).reshape(-1)[0],
             count[0]]).to(torch.int64))
        peak_codes = torch.maximum(peak_codes, by_code)
        if i % every == 0 or i == substeps:
            pos = state.pos[0][moving].double().cpu()
            speed = torch.linalg.vector_norm(state.linvel[0][moving], dim=-1)
            by_type = {}
            for code, n in enumerate(peak_codes.tolist()):
                if n:
                    t1, t2 = divmod(code, TYPES)
                    by_type[f"{NAMES[t1]}-{NAMES[t2]}"] = n
            line = {
                "scene": scene_name, "substep": i,
                "peak_pairs": int(peaks[0]),
                "peak_contacts": int(peaks[1]),
                "peak_pairs_by_type": dict(sorted(by_type.items())),
                "overflow": int(state.overflow[0]),
                "y_min": float(pos[:, 1].min()),
                "y_max": float(pos[:, 1].max()),
                "fastest_m_per_s": float(speed.max()),
            }
            if card is not None:
                line["card"] = card
            lines.append(line)
    return lines


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", choices=["capsule-stack", "mini-stack"])
    ap.add_argument("--substeps", type=int, default=None,
                    help="default 648 (capsule-stack) or 384 (mini-stack)")
    ap.add_argument("--every", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = require_card("capacity_peaks", args.device)
    for line in run(args.scene, args.substeps, args.every, args.device,
                    card):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
