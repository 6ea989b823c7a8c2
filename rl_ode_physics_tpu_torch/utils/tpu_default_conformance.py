"""The shipped throughput policy against the float64 referee, on the card.

The port of ``benchmarks/tpu_default_conformance.py``. The conformance bar
(a relative trajectory error of 1e-5) is measured on the float64 PGS
configuration (``testing/conformance.py``); the float32 policy the bench
ships (heavy-ball JACOBI, ω 1.3, β 0.9, 8 sweeps, typed buckets, K=4, bf16
selectors at these 16 slots) has a trajectory error of its own, which this
measures::

    python3 -m rl_ode_physics_tpu_torch.utils.tpu_default_conformance \\
        [steps] [precision] [device]

Scene: ``scenes.mini_stack_world`` (a box tower, spheres, dynamic and
kinematic capsules). Engine: ``EngineConfig.throughput(max_bodies=16,
max_pair_candidates=128, max_contacts=256)``, one world. Referee: the
float64 NumPy QuickStep of ``testing/referee.py``. ``precision`` other than
``default`` (``highest``) measures with float32 selectors, as the JAX
script does; on the card every float32 product is exact either way (TF32
is off), so only the selectors' bf16 rounding differs. The script's five
numbers are printed on its line: the largest relative position error, the
resting-height error over the last 100 steps, the first step where a body
is more than 1 cm from the referee's, the error of the sorted final heights
of the dynamic bodies, and the engine's motion over its last 50 steps. The
JAX script sets no bar and neither does this; it requires finite state
and no overflow. ``device`` defaults to the card; the tests pass ``cpu``.
"""

from __future__ import annotations

import sys

import numpy as np

from rl_ode_physics_tpu_torch.core.config import EngineConfig

MIN_STEPS = 50


def throughput_config(precision: str = "default") -> EngineConfig:
    """``tpu_default_conformance.py:43-53``'s engine at ``precision``."""
    overrides = {}
    if precision != "default":
        # bf16 selectors would round what the precision override removes
        overrides["selector_dtype"] = "float32"
    return EngineConfig.throughput(
        max_bodies=16, max_pair_candidates=128, max_contacts=256,
        matmul_precision=precision, **overrides)


def five_numbers(pos_e, pos_r, init) -> dict:
    """The JAX script's numbers from the engine's and the referee's (T, N, 3)
    position trajectories and the initial state."""
    from rl_ode_physics_tpu_torch.testing.conformance import max_rel_err

    active = init["body_type"] != 0
    diff = np.linalg.norm(pos_e - pos_r, axis=-1)
    late = np.abs(pos_e[-100:, active, 1] - pos_r[-100:, active, 1]).max()
    # the step of the first macroscopic divergence (>1 cm): gradual drift or
    # a chaotic branch (the tower toppling otherwise)
    div_step = int(np.argmax(np.where(active[None, :], diff, 0.0).max(-1)
                             > 0.01))
    dyn = active & (init["inv_mass"] > 0)
    hs_e = np.sort(pos_e[-1, dyn, 1])
    hs_r = np.sort(pos_r[-1, dyn, 1])
    return dict(
        max_rel_pos_err=max_rel_err(pos_e, pos_r, active),
        late_height_err=float(late),
        first_divergence_step=div_step,
        sorted_heights_err=float(np.abs(hs_e - hs_r).max()),
        late_motion=float(np.abs(pos_e[-1] - pos_e[-MIN_STEPS]).max()))


def run(steps: int = 1000, precision: str = "default",
        device="cuda") -> dict:
    """The engine and the referee over ``steps`` steps of the mini stack:
    the five numbers, the config's solver settings, the seconds of each
    side, and the engine's positions (``pos_e``, (T, N, 3)) for a
    comparison of devices. Raises on a non-finite state or an overflow."""
    import torch

    from rl_ode_physics_tpu_torch.testing import conformance

    if steps < MIN_STEPS:
        raise ValueError(f"steps={steps}: the last number is the motion over "
                         f"the last {MIN_STEPS} steps")
    config = throughput_config(precision)
    t = conformance.trajectories("mini_stack", steps, device, config)
    final = t["final"]
    if not (np.isfinite(t["pos_e"]).all() and torch.isfinite(final.pos).all()
            and torch.isfinite(final.linvel).all()):
        raise AssertionError("tpu_default_conformance: non-finite state")
    overflow = int(final.overflow.sum())
    if overflow:
        raise AssertionError(f"tpu_default_conformance: overflow {overflow}")
    return dict(five_numbers(t["pos_e"], t["pos_r"], t["init"]),
                steps=steps, precision=precision, device=str(device),
                iterations=config.solver_iterations,
                omega=config.jacobi_omega, beta=config.jacobi_beta,
                engine_s=t["engine_s"], referee_s=t["referee_s"],
                pos_e=t["pos_e"])


def line(r: dict) -> str:
    """The JAX script's printed line."""
    return (f"[tpu-default-conformance] backend={r['device']} "
            f"precision={r['precision']} max rel pos err = "
            f"{r['max_rel_pos_err']:.3e}, late resting-height err = "
            f"{r['late_height_err']:.3e} over {r['steps']} steps; first >1cm "
            f"divergence at step {r['first_divergence_step']}; "
            f"sorted-final-heights err = {r['sorted_heights_err']:.3e}; "
            f"engine end-state motion over last 50 steps = "
            f"{r['late_motion']:.3e} (f32 JACOBI hb-{r['iterations']} "
            f"omega={r['omega']} beta={r['beta']} typed K=4 vs f64 PGS-20 "
            f"referee)")


def main(steps: int = 1000, precision: str = "default",
         device: str = "cuda") -> dict:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    card = require_card("tpu_default_conformance", device)
    print(f"backend={device} steps={steps} card={card}", file=sys.stderr)
    r = run(steps, precision, device)
    print(line(r))
    print(f"card: {card}; engine {r['engine_s']:.2f} s, referee "
          f"{r['referee_s']:.2f} s")
    return r


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1000,
         sys.argv[2] if len(sys.argv) > 2 else "default",
         sys.argv[3] if len(sys.argv) > 3 else "cuda")
