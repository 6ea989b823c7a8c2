"""Batches of independent worlds.

The port of ``rl_ode_physics_tpu/parallel/batch.py``: ``replicate`` tiles
one world into a batch, ``batched_step`` steps every world of it once and
``make_batched_step_fn`` steps it ``substeps`` times. There is no
cross-world communication, so a batch is a leading axis on every tensor
(``parallel/mesh.py`` splits that axis over cards).
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import U32_MASK, WorldState
from rl_ode_physics_tpu_torch.core.world import make_step_fn, step
from rl_ode_physics_tpu_torch.ops.dense import LIVE_PAIR_TENSORS


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


def batched_step(batch: WorldState, config: EngineConfig) -> WorldState:
    """One substep for every world in the batch."""
    return step(batch, config)


def take_worlds(batch: WorldState, start: int, stop: int) -> WorldState:
    """Worlds ``start..stop-1`` of a batch, as views."""
    return WorldState(**{f.name: getattr(batch, f.name)[start:stop]
                         for f in dataclasses.fields(WorldState)})


def concat_worlds(parts) -> WorldState:
    """Batches joined along the world axis."""
    return WorldState(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(WorldState)})


def dense_pipeline_bytes(config: EngineConfig, worlds: int) -> int:
    """What the dense pipeline's (worlds, N, N, K, 3) f32 intermediates
    take at their peak, unpadded."""
    n, k = config.max_bodies, config.max_contacts_per_pair
    return LIVE_PAIR_TENSORS * worlds * n * n * k * 3 * 4


def _check_dense_fits(config: EngineConfig, batch: WorldState,
                      chunk: int) -> None:
    """Refuse a dense-pipeline batch whose intermediates exceed the card's
    free memory, naming a chunk that fits."""
    per_chunk = chunk or batch.num_worlds
    need = dense_pipeline_bytes(config, per_chunk)
    free, _ = torch.cuda.mem_get_info(batch.device)
    if need > free:
        fits = max(1, per_chunk * free // need)
        raise ValueError(
            f"dense_pipeline at {per_chunk} worlds x {config.max_bodies} "
            f"bodies needs ~{need / 1e9:.1f} GB of intermediates, "
            f"{free / 1e9:.1f} GB are free on {batch.device}; use the sparse "
            f"pipeline or chunk<={fits}")


def make_batched_step_fn(config: EngineConfig, substeps: int = 1,
                         chunk: int = 0, device="cuda", trimesh=None,
                         joints=None):
    """A function batch → batch that runs ``substeps`` substeps.

    ``chunk``: step the batch in world-chunks of this size, one after the
    other, to bound peak device memory. The batch must lie on ``device``:
    the function raises rather than step it anywhere else. ``trimesh``: an
    optional static ``ops.trimesh.TriMesh`` on the same device, shared by
    every world. ``joints``: an optional ``ops.joints.JointSet`` on the same
    device, of one world (shared by every world) or of the whole batch
    (with ``chunk``, it must be of one world). On a card, a dense-pipeline
    batch whose intermediates would not fit raises.
    """
    if chunk and joints is not None and joints.kind.shape[0] != 1:
        raise ValueError("chunk needs a joint table of one world")
    step_fn = make_step_fn(config, substeps, trimesh=trimesh, joints=joints)
    want = torch.device(device)

    def fn(batch: WorldState) -> WorldState:
        if batch.device.type != want.type:
            raise ValueError(f"batch on {batch.device}, step function made "
                             f"for {want}")
        if config.dense_pipeline and trimesh is None and batch.pos.is_cuda:
            _check_dense_fits(config, batch, chunk)
        if not chunk:
            return step_fn(batch)
        b_total = batch.num_worlds
        if b_total % chunk:
            raise ValueError(f"batch {b_total} not divisible by chunk {chunk}")
        return concat_worlds([
            step_fn(take_worlds(batch, start, start + chunk))
            for start in range(0, b_total, chunk)])

    return fn
