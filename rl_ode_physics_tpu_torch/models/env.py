"""Batched RL environment: the "rl" of the engine.

The port of ``rl_ode_physics_tpu/models/env.py``: thousands of worlds
stepped in lockstep, each fed its own actions every control step.

    env = PhysicsEnv(config, scene_fn, actor_slots=[4, 5], num_worlds=8192)
    state, obs = env.reset(seed=0)
    state, obs = env.step(state, actions)         # one 60 Hz control step
    final, traj = env.rollout(state, action_seq)  # a horizon of them

* actions: (num_worlds, num_actors, 6), a world-frame force (3) and torque
  (3) on each actor slot, held for the whole control step: the integrator
  clears the accumulators, so they are added again before every substep.
  An actor slot named twice gets the sum of its actions.
* observations: (num_worlds, S, 13), pos (3) quat (4) linvel (3) angvel (3)
  of each observed slot; ``obs_slots`` picks the slots (default: all).
  Rewards and termination are the caller's, as functions of the state.
* ``substeps`` physics substeps (120 Hz) per control step.
* ``chunk``: step the world batch in chunks of this many worlds, one after
  the other, to bound peak device memory; ``rollout`` then runs each chunk
  through the whole horizon before the next (the reference's chunk-major
  order). Worlds are independent, so the results are those of the
  unchunked run.
* ``lidar_dirs``: optional (R, 3) body-frame ray directions. Every actor
  casts them from its position after each control step, and the distances,
  divided by ``lidar_range``, come with the observation as (obs, lidar
  (num_worlds, num_actors, R)).
* ``trimesh``: an optional static ``ops.trimesh.TriMesh`` on the env's
  device, shared by every world.

On a card ``advance``, ``step`` and ``rollout`` each replay one CUDA graph
a call (``utils/graphs.py``), the JAX env's ``jax.jit`` of the control
step and of its ``lax.scan`` over the horizon: the actions are the graph's
input, the lidar is swept inside it, and every tensor returned is new, so
no later call writes over it. ``env.graphed`` and ``env.eager_reason`` say
which route the env takes; under ``disable_graphs()`` and on the CPU it
is the eager loop.

The env runs on ``device`` (the card unless the caller asks for the CPU)
and raises on a state that lies elsewhere. Gradients through the env are
not part of this port.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from rl_ode_physics_tpu_torch.core import world as world_m
from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops.raycast import ray_distances
from rl_ode_physics_tpu_torch.parallel.batch import (
    concat_worlds, replicate, take_worlds)
from rl_ode_physics_tpu_torch.utils import graphs
from rl_ode_physics_tpu_torch.utils import quat as quat_m


def observe(state: WorldState, slots=None) -> torch.Tensor:
    """(B, S, 13) observations of a batch: pos, quat, linvel, angvel of the
    slots in ``slots``, or of every slot (S = N) when it is None."""
    full = torch.cat([state.pos, state.quat, state.linvel, state.angvel],
                     dim=-1)
    if slots is None:
        return full
    index = graphs.constant(tuple(int(s) for s in slots), torch.int64,
                            state.device)
    return full.index_select(1, index)


class PhysicsEnv:
    def __init__(self, config: EngineConfig,
                 scene_fn: Callable[[EngineConfig, int], WorldState],
                 actor_slots: Sequence[int] = (),
                 num_worlds: int = 1, substeps: int = 2,
                 trimesh=None, lidar_dirs=None, lidar_range: float = 50.0,
                 obs_slots: Optional[Sequence[int]] = None,
                 chunk: int = 0, device="cuda"):
        """``scene_fn(config, seed)`` returns a one-world state on
        ``device``."""
        config.validate()
        if chunk and num_worlds % chunk:
            raise ValueError(
                f"num_worlds {num_worlds} not divisible by chunk {chunk}")
        self.config = config
        self.scene_fn = scene_fn
        self.device = torch.device(device)
        self.actor_slots = torch.tensor(list(actor_slots), dtype=torch.int64,
                                        device=self.device)
        self.num_worlds = num_worlds
        self.substeps = substeps
        self.trimesh = trimesh
        # rounded to f32 as the JAX env does, then held in the state's dtype
        self.lidar_dirs = (None if lidar_dirs is None else torch.as_tensor(
            lidar_dirs, dtype=torch.float32).to(
                device=self.device, dtype=getattr(torch, config.dtype)))
        self.lidar_range = lidar_range
        self.obs_slots = (None if obs_slots is None
                          else tuple(int(s) for s in obs_slots))
        self.chunk = chunk
        # (A, N): actor a drives slot n
        self._onehot = (self.actor_slots[:, None] == torch.arange(
            config.max_bodies, device=self.device)[None, :]).to(
                getattr(torch, config.dtype))
        self._advance_graphs, self._step_graphs, self._rollout_graphs = (
            graphs.Graphed(body, None, False, config, None, self.device)
            for body in (
                lambda state, acts: (self._advance(state, acts[0]), None),
                lambda state, acts: self._control_step(state, acts[0]),
                self._rollout_body))
        self.graphed = self._rollout_graphs.graphed
        self.eager_reason = self._rollout_graphs.eager_reason

    @property
    def num_actors(self) -> int:
        return int(self.actor_slots.shape[0])

    @property
    def num_obs_slots(self) -> int:
        return (self.config.max_bodies if self.obs_slots is None
                else len(self.obs_slots))

    @property
    def _has_lidar(self) -> bool:
        return self.lidar_dirs is not None and self.num_actors > 0

    def _check_device(self, state: WorldState) -> None:
        if state.device.type != self.device.type:
            raise ValueError(f"state on {state.device}, env made for "
                             f"{self.device}")

    def reset(self, seed: int = 0):
        """(batch, obs): ``scene_fn``'s world in ``num_worlds`` copies."""
        world = self.scene_fn(self.config, seed)
        self._check_device(world)
        batch = replicate(world, self.num_worlds, device=self.device)
        return batch, observe(batch, self.obs_slots)

    def advance(self, state: WorldState, actions) -> WorldState:
        """``substeps`` substeps of a batch under its (b, A, 6) actions: a
        control step without its observation."""
        return self._advance_graphs(state, (actions,))[0]

    def _advance(self, state: WorldState, actions) -> WorldState:
        if self.num_actors:
            # a one-hot projection: no scatter, duplicate slots sum
            force = torch.einsum("an,bad->bnd", self._onehot,
                                 actions[..., 0:3])
            torque = torch.einsum("an,bad->bnd", self._onehot,
                                  actions[..., 3:6])
        for _ in range(self.substeps):
            if self.num_actors:
                state = state.replace(force=state.force + force,
                                      torque=state.torque + torque)
            state = world_m.step(state, self.config, self.trimesh)
        return state

    def sense(self, state: WorldState) -> torch.Tensor:
        """(B, A, R) lidar distances over ``lidar_range``, of an env made
        with ``lidar_dirs``."""
        b, a, r = state.num_worlds, self.num_actors, self.lidar_dirs.shape[0]
        r_mat = quat_m.to_matrix(state.quat[:, self.actor_slots])  # (B,A,3,3)
        dirs = torch.sum(r_mat[:, :, None, :, :]
                         * self.lidar_dirs[None, None, :, None, :], dim=-1)
        origins = state.pos[:, self.actor_slots][:, :, None, :].expand(
            dirs.shape)
        t = ray_distances(state, origins.reshape(b, a * r, 3),
                          dirs.reshape(b, a * r, 3), self.config,
                          max_dist=self.lidar_range)
        return t.reshape(b, a, r) / self.lidar_range

    def _observe_full(self, state: WorldState):
        obs = observe(state, self.obs_slots)
        if self._has_lidar:
            return obs, self.sense(state)
        return obs

    def _chunks(self, num_worlds: int):
        size = self.chunk if 0 < self.chunk < num_worlds else num_worlds
        return [(s, s + size) for s in range(0, num_worlds, size)]

    def _control_step(self, state: WorldState, actions):
        state = self._advance(state, actions)
        return state, self._observe_full(state)

    def step(self, state: WorldState, actions: torch.Tensor):
        """One control step: (state, (B, A, 6) actions) → (state, obs)."""
        self._check_device(state)
        spans = self._chunks(state.num_worlds)
        if len(spans) == 1:
            return self._step_graphs(state, (actions,))
        new_state = concat_worlds([
            self.advance(take_worlds(state, s, e), actions[s:e])
            for s, e in spans])
        return new_state, self._observe_full(new_state)

    def _rollout_body(self, carry, consts):
        """One control step of a rollout: the actions of step ``t`` (a
        (1,) counter on the device) in, the observation (and lidar) written
        into row ``t`` of the trajectory."""
        state, t, traj, lidar = carry
        state = self._advance(state, consts[0].index_select(0, t)[0])
        traj.index_copy_(0, t, observe(state, self.obs_slots)[None])
        if lidar is not None:
            lidar.index_copy_(0, t, self.sense(state)[None])
        return (state, t + 1, traj, lidar), None

    def rollout(self, state: WorldState, action_seq: torch.Tensor):
        """(T, B, A, 6) actions → (final state, (T, B, S, 13) observations),
        or (final state, (observations, (T, B, A, R) lidar)) with a lidar.
        The trajectory is written into tensors allocated once. On a card a
        chunk's whole horizon is one graph launch."""
        self._check_device(state)
        horizon, b = action_seq.shape[0], state.num_worlds
        f = state.pos.dtype
        traj = torch.empty((horizon, b, self.num_obs_slots, 13), dtype=f,
                           device=state.device)
        lidar = None
        if self._has_lidar:
            lidar = torch.empty((horizon, b, self.num_actors,
                                 self.lidar_dirs.shape[0]), dtype=f,
                                device=state.device)
        finals = []
        for s, e in self._chunks(b):
            rows = (traj[:, s:e], None if lidar is None else lidar[:, s:e])
            start = torch.zeros((1,), dtype=torch.int64, device=state.device)
            (part, _, *written), _ = self._rollout_graphs(
                (take_worlds(state, s, e), start, *rows),
                (action_seq[:, s:e],), horizon)
            for view, got in zip(rows, written):
                if got is not view:         # the graph's copy of the rows
                    view.copy_(got)
            finals.append(part)
        final = finals[0] if len(finals) == 1 else concat_worlds(finals)
        return final, (traj if lidar is None else (traj, lidar))
