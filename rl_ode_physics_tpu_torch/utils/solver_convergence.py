"""Convergence of the mass-splitting Jacobi solver: plain against heavy-ball.

The port of ``benchmarks/solver_convergence.py``, the argument behind the
bench's hb-8 against plain-20 (``bench.py:10-16``): how many
momentum-accelerated sweeps match plain Jacobi at ODE's 20? Matched in
solution space: the largest velocity difference after one solve against a
quasi-converged one (plain Jacobi at 400 sweeps), on contact-rich states
of the bench scene::

    python3 -m rl_ode_physics_tpu_torch.utils.solver_convergence [--device cuda]

Prints the JAX script's table, sorted by the worst error over the states,
with the card's name and power limit. The table is necessary but not
sufficient: a setting that wins a single solve can blow up over a
trajectory (the script's caution, ω 1.3 β 0.95 at 7 sweeps).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind

# (omega, beta, iters); the bench's setting is (1.3, 0.9, 8)
CASES = [(1.0, 0.0, it) for it in (10, 15, 20, 30, 40)] + [
    (om, b, it)
    for om in (1.0, 1.2, 1.3)
    for b in (0.45, 0.9, 0.95)
    for it in (7, 8, 10, 15)
]
REFERENCE_ITERATIONS = 400


def convergence_config() -> EngineConfig:
    """The JAX script's engine: classic pipeline, JACOBI, K=4, 64 slots."""
    return EngineConfig(solver=SolverKind.JACOBI, max_bodies=64,
                        max_pair_candidates=256, max_contacts=128,
                        max_contacts_per_pair=4,
                        enable_capsules=False, enable_planes=False)


def contact_rich_states(cfg, seeds=(42, 7, 123), settle_steps=25,
                        device="cuda"):
    """Bench-scene worlds stepped into resting-stack steady state, plus the
    early settling burst (step 5) where impacts are violent: one-world
    states, each step 8 substeps."""
    from rl_ode_physics_tpu_torch.core.world import make_step_fn
    from rl_ode_physics_tpu_torch.models import scenes

    stepf = make_step_fn(cfg, substeps=8, donate=False)   # states are kept
    states = []
    for seed in seeds:
        w = scenes.bench_world(cfg, num_bodies=60, seed=seed, device=device)
        for i in range(settle_steps):
            w = stepf(w)
            if i in (4, settle_steps - 1):
                states.append(w)
    return states


def solve_err(state, contacts, cfg, ref_vel) -> float:
    """The largest velocity difference of one Jacobi solve under ``cfg``
    from ``ref_vel`` (linvel, angvel)."""
    from rl_ode_physics_tpu_torch.ops import solver as sol
    out = sol.solve_jacobi(state, contacts, cfg)
    dv = torch.cat([out.linvel - ref_vel[0], out.angvel - ref_vel[1]], -1)
    return float(dv.abs().max())


def solver_inputs(state, cfg):
    """(state after external forces, contacts) of one substep: what the
    solver sees."""
    from rl_ode_physics_tpu_torch.ops import broadphase as bp
    from rl_ode_physics_tpu_torch.ops import integrator as integ
    from rl_ode_physics_tpu_torch.ops import narrowphase as nph
    cand = bp.broadphase(state, cfg)
    contacts = nph.narrowphase(state, cand, cfg)
    return integ.apply_external_forces(state, cfg), contacts


def table(states, cfg, cases=CASES) -> dict:
    """{(omega, beta, iters): [error a state]} against the 400-sweep
    solve."""
    from rl_ode_physics_tpu_torch.ops import solver as sol
    rows = {}
    for state in states:
        s2, contacts = solver_inputs(state, cfg)
        ref = sol.solve_jacobi(s2, contacts, dataclasses.replace(
            cfg, solver_iterations=REFERENCE_ITERATIONS))
        ref_vel = (ref.linvel, ref.angvel)
        for omega, beta, iters in cases:
            c2 = dataclasses.replace(cfg, jacobi_omega=omega,
                                     jacobi_beta=beta,
                                     solver_iterations=iters)
            rows.setdefault((omega, beta, iters), []).append(
                solve_err(s2, contacts, c2, ref_vel))
    return rows


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = require_card("solver_convergence", args.device)
    cfg = convergence_config()
    states = contact_rich_states(cfg, device=args.device)
    print(f"{len(states)} contact-rich states on {card}")
    rows = table(states, cfg)
    print(f"{'omega':>6} {'beta':>5} {'iters':>5}  {'max err':>10}  "
          f"{'mean err':>10}   (velocity vs 400-iteration solve)")
    for (omega, beta, iters), errs in sorted(rows.items(),
                                             key=lambda kv: max(kv[1])):
        print(f"{omega:6.2f} {beta:5.2f} {iters:5d}  {max(errs):10.2e}  "
              f"{np.mean(errs):10.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
