"""End-to-end RL training on the engine: the "rl" in rl-ode-physics.

The port of ``examples/rl_training.py``. Task: a dynamic sphere (the
actor) starts at the arena centre; the policy pushes it with world-frame
forces toward a target point. Observation: the actor's position and
linear velocity relative to the target (6 features). Policy: a linear map
to a planar force. Reward: the negative final distance to the target.

Trainer: antithetic evolution strategies (OpenAI-ES). Each candidate
parameter vector drives its own world of one batch, so one evaluation
steps population × horizon × substeps substeps of every world at once;
the policy runs for all worlds as one batched product. On a card each
device's horizon loop is one CUDA graph launch (``utils/graphs.py``), the
JAX trainer's ``lax.scan``; the noise is drawn outside it. With a ``mesh``
(``parallel/mesh.py``) the worlds are split over its devices, each block
rolled out by its own ``PhysicsEnv`` on its own device; the rewards are
gathered to the lead device for their mean and spread and the gradient
estimate, the only traffic between devices.

    python -m rl_ode_physics_tpu_torch.examples.rl_training [iters] \\
        [--horizon 60] [--device cuda]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.models.env import PhysicsEnv
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.parallel.mesh import on_device, shard_batch
from rl_ode_physics_tpu_torch.utils import graphs

TARGET = (3.0, 0.65, 2.0)
ACTOR = 4            # slot after the 4 arena geoms
OBS_DIM = 6          # (pos - target, linvel)
ACT_DIM = 2          # planar force (x, z)
FORCE_SCALE = 8.0


def trainer_config() -> EngineConfig:
    """The JAX trainer's engine: classic pipeline, heavy-ball Jacobi."""
    return EngineConfig(max_bodies=8, max_pair_candidates=32,
                        max_contacts=32, enable_capsules=False,
                        solver_iterations=8, jacobi_omega=1.3,
                        jacobi_beta=0.9)


def scene(config: EngineConfig, seed: int, device="cuda"):
    b = WorldBuilder(config, seed)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (100.0, 1.0, 100.0))
    b.add_body_map((0.0, 2.0, -50.0), (0.0, 0.0, 0.0), (100.0, 4.0, 1.0))
    b.add_body_map((-50.0, 2.0, 0.0), (0.0, 0.0, 0.0), (1.0, 4.0, 100.0))
    b.add_body_map((50.0, 2.0, 0.0), (0.0, 0.0, 0.0), (1.0, 4.0, 100.0))
    # physical sphere inertia (2/5·m·r²): with the reference's ODE-default
    # identity inertia, the μ=∞ rolling constraint gives the 0.15 m sphere
    # an effective pushing mass of m + I/r² ≈ 45 — nearly unpushable
    r = 0.15
    i_sph = 0.4 * 1.0 * r * r
    b.add_body(BodyType.SPHERE, (0.0, 0.65, 0.0), (r, 0.0, 0.0),
               inertia=(i_sph, i_sph, i_sph))
    return b.finish(device)


def policy_actions(ws: torch.Tensor, bs: torch.Tensor, state,
                   target: torch.Tensor) -> torch.Tensor:
    """Per-world params ws (B, 6, 2), bs (B, 2) and the batch → (B, 1, 6)
    actor force/torque actions, one batched product for every world."""
    o = torch.cat([state.pos[:, ACTOR] - target, state.linvel[:, ACTOR]],
                  dim=-1)                                    # (B, 6)
    f_xz = torch.tanh(torch.bmm(o[:, None, :], ws)[:, 0] + bs) * FORCE_SCALE
    zero = torch.zeros_like(f_xz[:, :1])
    return torch.cat([f_xz[:, :1], zero, f_xz[:, 1:], zero.expand(-1, 3)],
                     dim=-1)[:, None, :]


class ESTrainer:
    """``trainer(params, generator) -> (params, mean reward)``: one ES
    iteration, its noise drawn from ``generator`` on the lead device;
    ``trainer.step_with_noise(params, ew, eb)`` takes the scaled noise
    (``pop`` × the parameter shapes) instead."""

    def __init__(self, pop: int, horizon: int, sigma: float, lr: float,
                 substeps: int, mesh, device):
        config = trainer_config()
        self.pop, self.horizon, self.sigma, self.lr = pop, horizon, sigma, lr
        self.devices = ((torch.device(device),) if mesh is None
                        else mesh.devices)
        self.lead = self.devices[0]
        n_worlds = 2 * pop                # antithetic pairs share the batch
        if n_worlds % len(self.devices):
            raise ValueError(f"{n_worlds} worlds do not split evenly over "
                             f"{len(self.devices)} devices")
        self.per_device = n_worlds // len(self.devices)
        self.envs = [PhysicsEnv(config, functools.partial(scene, device=dev),
                                actor_slots=[ACTOR],
                                num_worlds=self.per_device,
                                substeps=substeps, device=dev)
                     for dev in self.devices]
        state0 = replicate(scene(config, 0, device=self.lead), n_worlds,
                           device=self.lead)
        self.state0 = ((state0,) if mesh is None
                       else shard_batch(state0, mesh))
        f = getattr(torch, config.dtype)
        self.targets = [torch.tensor(TARGET, dtype=f, device=dev)
                        for dev in self.devices]
        self.init_params = (torch.zeros((OBS_DIM, ACT_DIM), dtype=f,
                                        device=self.lead),
                            torch.zeros((ACT_DIM,), dtype=f,
                                        device=self.lead))
        # each block's horizon loop as one graph on its device; the
        # initial states are copied in, never written
        self._horizons = [
            graphs.Graphed(self._control_step(env), None, True, env.config,
                           None, env.device) for env in self.envs]

    def _control_step(self, env):
        """One control step of ``env``'s block under the policy: the body
        of its horizon loop."""
        def body(state, consts):
            ws, bs, target = consts
            return env._advance(state, policy_actions(ws, bs, state,
                                                      target)), None
        return body

    def rollout_reward(self, ws: torch.Tensor, bs: torch.Tensor):
        """(2·pop,) rewards on the lead device of per-world params ws
        (2·pop, 6, 2), bs (2·pop, 2): every block rolled out on its own
        device, the devices in turn: on the cards each block's whole
        horizon is one CUDA graph launch (the JAX trainer's ``lax.scan``);
        eagerly, each block's horizon loop."""
        n = self.per_device
        blocks = [(ws[i * n:(i + 1) * n].to(dev), bs[i * n:(i + 1) * n].to(dev),
                   self.targets[i])
                  for i, dev in enumerate(self.devices)]
        states = list(self.state0)
        for i, env in enumerate(self.envs):
            with on_device(env.device):
                states[i] = self._horizons[i](states[i], blocks[i],
                                              self.horizon)[0]
        rewards = [-torch.linalg.vector_norm(
            s.pos[:, ACTOR][:, [0, 2]] - t[[0, 2]], dim=-1)
            for s, t in zip(states, self.targets)]
        return torch.cat([r.to(self.lead) for r in rewards])

    def step_with_noise(self, params, ew: torch.Tensor, eb: torch.Tensor):
        w, b = params
        pop = self.pop
        # antithetic population: [w + e; w - e]
        ws = torch.cat([w + ew, w - ew])
        bs = torch.cat([b + eb, b - eb])
        r = self.rollout_reward(ws, bs)                      # (2·pop,)
        adv = (r - r.mean()) / torch.clamp(r.std(correction=0), min=1e-6)
        d = adv[:pop] - adv[pop:]
        gw = torch.einsum("p,pij->ij", d, ew) / (2 * pop)
        gb = torch.einsum("p,pj->j", d, eb) / (2 * pop)
        return (w + self.lr * gw / self.sigma,
                b + self.lr * gb / self.sigma), r.mean()

    def __call__(self, params, generator: torch.Generator):
        w, b = params
        ew = torch.randn((self.pop,) + tuple(w.shape), generator=generator,
                         dtype=w.dtype, device=self.lead) * self.sigma
        eb = torch.randn((self.pop,) + tuple(b.shape), generator=generator,
                         dtype=b.dtype, device=self.lead) * self.sigma
        return self.step_with_noise(params, ew, eb)


def make_trainer(pop: int = 16, horizon: int = 25, sigma: float = 0.1,
                 lr: float = 0.3, substeps: int = 2, mesh=None,
                 device="cuda"):
    """(init_params, train_step): ``train_step(params, generator) ->
    (params, mean reward)``, an ``ESTrainer``. ``mesh``: an optional
    ``parallel.mesh.Mesh`` whose devices the 2·pop worlds are split over
    (its first device leads; ``device`` is then unused)."""
    trainer = ESTrainer(pop, horizon, sigma, lr, substeps, mesh, device)
    return trainer.init_params, trainer


def main(iters: int = 20, horizon: int = 60, device="cuda"):
    params, train_step = make_trainer(horizon=horizon, device=device)
    generator = torch.Generator(device=train_step.lead).manual_seed(0)
    rewards = []
    for i in range(iters):
        params, mean_r = train_step(params, generator)
        rewards.append(float(mean_r))
        print(f"iter {i:3d}  mean reward {rewards[-1]:8.3f}  "
              f"(= -distance to target)", flush=True)
    print(f"first {np.mean(rewards[:3]):.3f} → last "
          f"{np.mean(rewards[-3:]):.3f}")
    return rewards


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("iters", nargs="?", type=int, default=20)
    parser.add_argument("--horizon", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.iters, args.horizon, args.device)
