"""Batches of independent worlds.

The port of ``rl_ode_physics_tpu/parallel/batch.py``: ``replicate`` tiles
one world into a batch, ``make_batched_step_fn`` steps the batch. There is
no cross-world communication, so a batch is a leading axis on every
tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import U32_MASK, WorldState
from rl_ode_physics_tpu_torch.core.world import make_step_fn


def replicate(state: WorldState, num_worlds: int, reseed: bool = True,
              device="cuda") -> WorldState:
    """Tile a one-world state into ``num_worlds`` worlds on ``device``.

    ``reseed=True`` gives each world its own PRNG stream: seed + world
    index, wrapped to 32 bits like the JAX package's uint32 add.
    """
    if state.num_worlds != 1:
        raise ValueError(f"replicate takes one world, got {state.num_worlds}")
    fields = {
        f.name: getattr(state, f.name).to(device).expand(
            (num_worlds,) + getattr(state, f.name).shape[1:]).clone()
        for f in dataclasses.fields(WorldState)}
    batch = WorldState(**fields)
    if reseed:
        idx = torch.arange(num_worlds, dtype=torch.int64, device=batch.device)
        batch = batch.replace(rng_state=(batch.rng_state + idx) & U32_MASK)
    return batch


def make_batched_step_fn(config: EngineConfig, substeps: int = 1,
                         chunk: int = 0, device="cuda"):
    """A function batch → batch that runs ``substeps`` substeps.

    ``chunk``: step the batch in world-chunks of this size, one after the
    other, to bound peak device memory. The batch must lie on ``device``:
    the function raises rather than step it anywhere else.
    """
    step_fn = make_step_fn(config, substeps)
    want = torch.device(device)

    def fn(batch: WorldState) -> WorldState:
        if batch.device.type != want.type:
            raise ValueError(f"batch on {batch.device}, step function made "
                             f"for {want}")
        if not chunk:
            return step_fn(batch)
        b_total = batch.num_worlds
        if b_total % chunk:
            raise ValueError(f"batch {b_total} not divisible by chunk {chunk}")
        parts = []
        for start in range(0, b_total, chunk):
            part = WorldState(**{
                f.name: getattr(batch, f.name)[start:start + chunk]
                for f in dataclasses.fields(WorldState)})
            parts.append(step_fn(part))
        return WorldState(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(WorldState)})

    return fn
