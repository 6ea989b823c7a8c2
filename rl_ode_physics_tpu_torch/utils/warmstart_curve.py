"""Solve error against iteration count, cold start against warm start.

The port of ``benchmarks/warmstart_curve.py``. For each solver (PGS, then
JACOBI) and iteration count, the impulse cache is built over 8 warm steps
(``ops/warmstart.make_warm_step_fn``) on a settled resting scene; then,
from the same state and contact rows, one cold solve and one warm solve
(``lam0`` from ``warmstart.match_lam``) are each held to the converged
400-iteration impulses: the largest |Δλ| of each and their ratio::

    python3 -m rl_ode_physics_tpu_torch.utils.warmstart_curve [--device cuda]

The scene is ``bench_world(num_bodies=10, seed=42)`` in 16 slots, settled
244 substeps. Prints the JAX script's table a solver, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import sys

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind

ITERATIONS = (1, 2, 3, 5, 10, 20)
SETTLE = 244
WARM_STEPS = 8
CONVERGED = 400


def curve(kind: SolverKind, iterations=ITERATIONS, settle: int = SETTLE,
          device="cuda") -> list:
    """[(iters, cold |Δλ|, warm |Δλ|)] of one solver."""
    from rl_ode_physics_tpu_torch.core.world import make_step_fn
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import broadphase as bp
    from rl_ode_physics_tpu_torch.ops import integrator
    from rl_ode_physics_tpu_torch.ops import narrowphase as nph
    from rl_ode_physics_tpu_torch.ops import solver as so
    from rl_ode_physics_tpu_torch.ops import warmstart

    cfg = EngineConfig(max_bodies=16, max_pair_candidates=64,
                       max_contacts=64, solver=kind)
    w0 = scenes.bench_world(cfg, num_bodies=10, seed=42, device=device)
    w0 = make_step_fn(cfg, substeps=settle)(w0)
    solve = so.solve_pgs if kind is SolverKind.PGS else so.solve_jacobi
    out = []
    for iters in iterations:
        c = cfg.replace(solver_iterations=iters)
        warm_fn = warmstart.make_warm_step_fn(c)
        cache = warmstart.init_cache(c, device=device)
        w = w0
        for _ in range(WARM_STEPS):
            w, cache = warm_fn(w, cache)
        cand = bp.broadphase(w, c)
        contacts = nph.narrowphase(w, cand, c)
        wf = integrator.apply_external_forces(w, c)
        _, lam_star = solve(wf, contacts,
                            c.replace(solver_iterations=CONVERGED),
                            return_lam=True)
        _, lam_cold = solve(wf, contacts, c, return_lam=True)
        lam0 = warmstart.match_lam(cache, contacts)
        _, lam_warm = solve(wf, contacts, c, lam0=lam0, return_lam=True)
        out.append((iters, float((lam_cold - lam_star).abs().max()),
                    float((lam_warm - lam_star).abs().max())))
    return out


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = require_card("warmstart_curve", args.device)
    print(f"card: {card}")
    for kind in (SolverKind.PGS, SolverKind.JACOBI):
        print(f"{kind}:")
        print(f"{'iters':>6} {'cold |dlam|':>13} {'warm |dlam|':>13} "
              f"{'ratio':>7}")
        for iters, e_cold, e_warm in curve(kind, device=args.device):
            print(f"{iters:>6} {e_cold:>13.3e} {e_warm:>13.3e} "
                  f"{e_cold / max(e_warm, 1e-12):>7.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
