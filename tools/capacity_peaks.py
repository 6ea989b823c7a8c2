"""Candidate-pair and contact peaks of a workload, measured on the JAX
package (the reference) on the CPU, to size a configuration's capacities.

    JAX_PLATFORMS=cpu python tools/capacity_peaks.py capsule-stack
    JAX_PLATFORMS=cpu python tools/capacity_peaks.py mini-stack

``capsule-stack``: BASELINE config 2 (``capsule_stack_world(num_bodies=64,
seed=7)``, 68 slots) through the classic pipeline at ``EngineConfig``'s
defaults, 648 substeps (the horizon ``chip_smoke.py`` runs: 480 settling
substeps, a warm-up launch of 24 and 3 timed launches of 48).
``mini-stack``: ``benchmarks/tpu_default_conformance.py``'s engine and
scene (``EngineConfig.throughput(max_bodies=16, max_pair_candidates=128,
max_contacts=256)``, ``mini_stack_world``), 384 substeps.

Both run one world at capacities far above any peak (nothing can be
dropped), and print one JSON line: the peak of live contacts, of broadphase
candidates (classic) or pairs tested (typed), the peak candidates of each
type pair, the overflow counter, and where the dynamic bodies are at the
end (lowest and highest y, fastest speed), with ``--every`` lines of the
same along the way.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = {1: "sphere", 2: "box", 3: "capsule", 4: "plane"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", choices=["capsule-stack", "mini-stack"])
    ap.add_argument("--substeps", type=int, default=None,
                    help="default 648 (capsule-stack) or 384 (mini-stack)")
    ap.add_argument("--every", type=int, default=96)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from rl_ode_physics_tpu.core.config import EngineConfig
    from rl_ode_physics_tpu.core.world import step
    from rl_ode_physics_tpu.models import scenes
    from rl_ode_physics_tpu.ops import broadphase, narrowphase

    if args.scene == "capsule-stack":
        substeps = args.substeps or 648
        # the capacities chip_smoke.py runs are 192/192; these hold anything
        config = EngineConfig(max_bodies=68, max_pair_candidates=1024,
                              max_contacts=2048)
        state = scenes.capsule_stack_world(config, num_bodies=64, seed=7)
    else:
        substeps = args.substeps or 384
        config = EngineConfig.throughput(max_bodies=16,
                                         max_pair_candidates=128,
                                         max_contacts=256)
        state = scenes.mini_stack_world(config)
    types = np.asarray(state.body_type)
    moving = np.asarray(state.inv_mass) > 0

    @jax.jit
    def advance(s):
        """One substep, and what the substep saw before it stepped: the
        pairs tested, the contacts, and the type codes of each pair."""
        if config.typed_buckets:
            hit, tmin, tmax = narrowphase._pair_eligibility(s)
            contacts, pairs = narrowphase.narrowphase_typed(s, config)
            ia, ib = jnp.nonzero(hit, size=hit.size, fill_value=-1)
            valid = ia >= 0
        else:
            cand = broadphase.broadphase(s, config)
            contacts = narrowphase.narrowphase(s, cand, config)
            pairs, ia, ib, valid = cand.count, cand.ia, cand.ib, cand.valid
        return step(s, config), pairs, contacts.count, ia, ib, valid

    peaks = {"pairs": 0, "contacts": 0}
    by_type = {}
    for i in range(1, substeps + 1):
        state, pairs, count, ia, ib, valid = advance(state)
        peaks["pairs"] = max(peaks["pairs"], int(pairs))
        peaks["contacts"] = max(peaks["contacts"], int(count))
        ia, ib, valid = np.asarray(ia), np.asarray(ib), np.asarray(valid)
        seen = {}
        for a, b in zip(ia[valid], ib[valid]):
            key = "-".join(NAMES[t] for t in sorted((types[a], types[b])))
            seen[key] = seen.get(key, 0) + 1
        for key, n in seen.items():
            by_type[key] = max(by_type.get(key, 0), n)
        if i % args.every == 0 or i == substeps:
            pos = np.asarray(state.pos)[moving]
            speed = np.linalg.norm(np.asarray(state.linvel)[moving], axis=-1)
            print(json.dumps({
                "scene": args.scene, "substep": i,
                "peak_pairs": peaks["pairs"],
                "peak_contacts": peaks["contacts"],
                "peak_pairs_by_type": dict(sorted(by_type.items())),
                "overflow": int(state.overflow),
                "y_min": float(pos[:, 1].min()),
                "y_max": float(pos[:, 1].max()),
                "fastest_m_per_s": float(speed.max()),
            }), flush=True)


if __name__ == "__main__":
    main()
