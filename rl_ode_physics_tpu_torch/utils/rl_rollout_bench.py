"""End-to-end RL rollout throughput on the card, the repository's namesake
use case.

The port of ``benchmarks/rl_rollout_bench.py``: ``PhysicsEnv.rollout``
(actions in, physics substeps, observations and lidar out) across the
whole batch, as env-steps/s (an env step is one 60 Hz control step of
``substeps`` 120 Hz substeps of a world) and body-steps/s::

    python3 -m rl_ode_physics_tpu_torch.utils.rl_rollout_bench
    BENCH_WORLDS=512 BENCH_LIDAR=0 python3 -m \\
        rl_ode_physics_tpu_torch.utils.rl_rollout_bench

The script's environment variables: ``BENCH_WORLDS`` (8192),
``BENCH_BODIES`` (64 slots), ``BENCH_HORIZON`` (16), ``BENCH_REPEATS`` (4),
``BENCH_SUBSTEPS`` (2), ``BENCH_LIDAR`` (16 rays an actor, 0 for none),
``BENCH_CHUNK`` (256; worlds stepped a chunk at a time, 0 for the whole
batch), ``BENCH_OBS`` (``actors`` or ``all`` slots observed) and
``BENCH_CONTACTS``. The engine is the throughput policy of
``core/config.rollout_config`` (80 contact rows at 64 slots: the actors
push the peak above the resting scene's), the compaction through the
``compact_rows_t`` kernel; actions are 0.5 x standard normal from a seed.
One warm-up rollout, then ``BENCH_REPEATS`` timed ones, ended by a
``synchronize``. Raises on a contact overflow. Prints the JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def settings(env=os.environ) -> dict:
    """The script's environment settings at its defaults."""
    s = dict(
        num_worlds=int(env.get("BENCH_WORLDS", 8192)),
        num_bodies=int(env.get("BENCH_BODIES", 64)),
        substeps=int(env.get("BENCH_SUBSTEPS", 2)),
        horizon=int(env.get("BENCH_HORIZON", 16)),
        repeats=int(env.get("BENCH_REPEATS", 4)),
        lidar_rays=int(env.get("BENCH_LIDAR", 16)),
        chunk=int(env.get("BENCH_CHUNK", 256)),
        obs_mode=env.get("BENCH_OBS", "actors"))
    if s["num_worlds"] <= s["chunk"] or s["num_worlds"] % s["chunk"]:
        s["chunk"] = 0
    s["max_contacts"] = int(env.get(
        "BENCH_CONTACTS", 80 if s["num_bodies"] == 64
        else 2 * s["num_bodies"]))
    return s


def run(num_worlds: int = 8192, num_bodies: int = 64, substeps: int = 2,
        horizon: int = 16, repeats: int = 4, lidar_rays: int = 16,
        chunk: int = 0, obs_mode: str = "actors",
        max_contacts: int | None = None, device="cuda") -> dict:
    """One warm-up and ``repeats`` timed rollouts of ``horizon`` control
    steps: the JSON line's keys, and the overflow (0, or it raises)."""
    from rl_ode_physics_tpu_torch.core.config import rollout_config
    from rl_ode_physics_tpu_torch.models.workloads import (
        rollout_env, seeded_actions)

    config = rollout_config(num_bodies)
    if max_contacts is not None:
        config = config.replace(max_contacts=max_contacts)
    env = rollout_env(config, num_worlds, device, chunk=chunk,
                      lidar_rays=lidar_rays, substeps=substeps,
                      obs_slots=obs_mode, bodies=num_bodies - 4)
    state, _ = env.reset(seed=42)
    actions = seeded_actions((horizon, num_worlds, env.num_actors, 6), 0,
                             device)

    def sync():
        if state.pos.is_cuda:
            torch.cuda.synchronize(state.pos.device)

    state, traj = env.rollout(state, actions)          # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        state, traj = env.rollout(state, actions)
    sync()
    dt = time.perf_counter() - t0
    env_steps = num_worlds * horizon * repeats
    dynamic = num_bodies - 4
    # capacity honesty, as bench.py: overflow is loud
    overflow = int(state.overflow.sum())
    if overflow:
        raise RuntimeError(f"contact capacity overflow in rollout bench: "
                           f"{overflow} dropped rows")
    return {
        "metric": f"env-steps/sec ({num_worlds} worlds, horizon {horizon}, "
                  f"{substeps} substeps/env-step, {env.num_actors} actors, "
                  f"chunk {chunk}, lidar {lidar_rays} rays, "
                  f"obs ({env.num_obs_slots},13)"
                  f"{' + lidar' if lidar_rays else ''}, "
                  f"solver hb-{config.solver_iterations} "
                  f"omega={config.jacobi_omega} beta={config.jacobi_beta})",
        "value": env_steps / dt,
        "unit": "env-steps/sec",
        "body_steps_per_sec": env_steps * substeps * dynamic / dt,
    }


def main(device="cuda") -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    card = require_card("rl_rollout_bench", device)
    print(json.dumps(dict(run(**settings(), device=device), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
