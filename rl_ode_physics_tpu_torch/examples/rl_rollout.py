"""Batched RL rollout demo: the engine as an RL physics backend.

The port of ``examples/rl_rollout.py``. A batch of arena worlds with one
force-controlled actor sphere each runs a rollout under random action
sequences, and the run reports env-steps/sec (BASELINE config 4's
"batched RL-style env throughput").

    python -m rl_ode_physics_tpu_torch.examples.rl_rollout \\
        [num_worlds] [steps] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.models.env import PhysicsEnv


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(num_worlds: int = 256, steps: int = 60, device="cuda"):
    device = torch.device(device)
    config = EngineConfig(max_bodies=8, max_pair_candidates=32,
                          max_contacts=64)

    def scene(cfg, seed):
        b = WorldBuilder(cfg, seed)
        b.add_body_map((0, 0, 0), (0, 0, 0), (100.0, 1.0, 100.0))
        b.add_body(BodyType.SPHERE, (0.0, 1.0, 0.0), (0.3, 0, 0))
        return b.finish(device)

    env = PhysicsEnv(config, scene, actor_slots=[1],
                     num_worlds=num_worlds, substeps=2, device=device)
    state, obs = env.reset(seed=0)
    print(f"obs shape {tuple(obs.shape)}")

    generator = torch.Generator(device=device).manual_seed(0)
    actions = torch.rand((steps, num_worlds, 1, 6), generator=generator,
                         device=device) * 10.0 - 5.0
    # keep actors hovering: bias the y-force around gravity
    actions[..., 1] += 9.8

    final, traj = env.rollout(state, actions)       # warm-up
    _sync(device)
    t0 = time.perf_counter()
    final, traj = env.rollout(state, actions)
    _sync(device)
    dt = time.perf_counter() - t0

    env_steps = steps * num_worlds
    print(f"rollout: {steps} control steps × {num_worlds} envs "
          f"in {dt:.3f}s → {env_steps / dt:,.0f} env-steps/sec")
    print(f"actor height spread at T: "
          f"min {float(traj[-1, :, 1, 1].min()):.2f} "
          f"max {float(traj[-1, :, 1, 1].max()):.2f}")
    return env_steps / dt


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_worlds", nargs="?", type=int, default=256)
    parser.add_argument("steps", nargs="?", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.num_worlds, args.steps, args.device)
