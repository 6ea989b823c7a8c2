"""Trajectory deviation of the box-box manifold variants.

The port of ``benchmarks/manifold_deviation.py``: the same rotated box
stack stepped under three manifold schemes, and their pairwise trajectory
divergence:

* exact: reference-face clipping (Sutherland-Hodgman), K=8
  (``EngineConfig(exact_box_clip=True, max_contacts_per_pair=8)``), the
  manifold of ODE's dBoxBox;
* cand8: the branch-free 8-candidate manifold, K=8;
* fold4: the throughput default, the 8 candidates fold-merged to K=4.

::

    python3 -m rl_ode_physics_tpu_torch.utils.manifold_deviation [steps] \\
        [--device cuda]

Prints the JAX script's table (max, RMS and final |Δx| of the dynamic
bodies' positions for each pair) and each variant's final tower heights,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind

BASE = dict(max_bodies=8, max_pair_candidates=32, max_contacts=128,
            solver=SolverKind.PGS, matmul_precision="highest")


def variants() -> dict:
    """The three configurations by name."""
    return {
        "exact": EngineConfig(**BASE, exact_box_clip=True,
                              max_contacts_per_pair=8),
        "cand8": EngineConfig(**BASE, max_contacts_per_pair=8),
        "fold4": EngineConfig(**BASE, max_contacts_per_pair=4),
    }


def rotated_stack(cfg, seed=11, device="cuda"):
    """A 4-box tower of distinct sizes and yaw angles (the face clip's
    paths exercised: incident quads rotated against reference rects), and
    two spheres resting against it."""
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    from rl_ode_physics_tpu_torch.utils.prng import RandStream

    b = WorldBuilder(cfg, seed)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (100.0, 1.0, 100.0))
    rng = RandStream(seed)
    y = 0.5
    for yaw, s in zip((0.0, 0.35, 0.6, 1.0), (0.8, 0.68, 0.55, 0.42)):
        y += s / 2 + 0.04
        q = (float(np.cos(yaw / 2)), 0.0, float(np.sin(yaw / 2)), 0.0)
        b.add_body(BodyType.BOX,
                   (rng.double(-0.02, 0.02), y, rng.double(-0.02, 0.02)),
                   (s, s, s), quat=q)
        y += s / 2
    b.add_body(BodyType.SPHERE, (1.0, 0.85, 0.0), (0.3, 0.0, 0.0))
    b.add_body(BodyType.SPHERE, (-0.9, 0.85, 0.4), (0.3, 0.0, 0.0))
    return b.finish(device)


def run(cfg, steps, device="cuda"):
    """((steps, N, 3) positions of the one world, final state)."""
    import torch

    from rl_ode_physics_tpu_torch.core.world import make_step_fn

    w = rotated_stack(cfg, device=device)
    stepf = make_step_fn(cfg, substeps=1, donate=False)   # traj is kept
    traj = []
    for _ in range(steps):
        w = stepf(w)
        traj.append(w.pos[0])
    return torch.stack(traj).cpu().numpy(), w


def divergence(trajs: dict) -> list:
    """[(name a, name b, max |dx|, RMS |dx|, final max |dx|)] of each
    pair of trajectories."""
    names = list(trajs)
    out = []
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            d = np.linalg.norm(trajs[names[i]] - trajs[names[j]], axis=-1)
            out.append((names[i], names[j], float(d.max()),
                        float(np.sqrt((d ** 2).mean())), float(d[-1].max())))
    return out


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = require_card("manifold_deviation", args.device)
    trajs, finals = {}, {}
    for name, cfg in variants().items():
        trajs[name], finals[name] = run(cfg, args.steps, args.device)
        print(f"{name}: done ({args.steps} steps)")
    print(f"\nPairwise trajectory divergence over {args.steps} steps "
          f"(dynamic-body positions, meters) on {card}:")
    print(f"{'pair':<16}{'max |dx|':>12}{'RMS |dx|':>12}"
          f"{'final max |dx|':>16}")
    for a, b, dmax, rms, final in divergence(trajs):
        print(f"{a}-{b:<10}{dmax:12.4f}{rms:12.4f}{final:16.4f}")
    # resting sanity: every variant keeps the tower standing
    for name, w in finals.items():
        ys = w.pos[0, 1:5, 1].cpu().numpy()
        print(f"{name}: final tower heights {np.round(ys, 3)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
