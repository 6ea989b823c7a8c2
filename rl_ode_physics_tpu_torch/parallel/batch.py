"""Batches of independent worlds.

The port of ``rl_ode_physics_tpu/parallel/batch.py``: ``replicate`` tiles
one world into a batch, ``batched_step`` steps every world of it once and
``make_batched_step_fn`` steps it ``substeps`` times, replaying CUDA
graphs on a card (``utils/graphs.py``). There is no
cross-world communication, so a batch is a leading axis on every tensor
(``parallel/mesh.py`` splits that axis over cards).
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import U32_MASK, WorldState
from rl_ode_physics_tpu_torch.core.world import _step_impl, step
from rl_ode_physics_tpu_torch.ops.dense import LIVE_PAIR_TENSORS
from rl_ode_physics_tpu_torch.utils import graphs


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


def _put_rows(out, start: int, part: WorldState) -> None:
    for o, p in zip(out, graphs.flatten(part)[0]):
        o[start:start + p.shape[0]].copy_(p)


def make_batched_step_fn(config: EngineConfig, substeps: int = 1,
                         donate: bool = True, chunk: int = 0,
                         unroll: int = 1, device="cuda", trimesh=None,
                         joints=None):
    """A function batch → batch that runs ``substeps`` substeps: the JAX
    ``make_batched_step_fn`` (``rl_ode_physics_tpu/parallel/batch.py:
    44-106``), its parameters in its order, then the port's.

    On a card a call replays CUDA graphs (``utils/graphs.py``), the port's
    ``jax.jit`` over ``lax.scan``: ``unroll`` substeps a graph, so a call
    is ``substeps // unroll`` launches and one more of the remainder
    (``unroll=substeps``: one launch a call). ``donate``: with True the
    batch is updated in the graph's buffers and the caller does not read
    the old handle again; with False the input is left as it was and the
    result is a new batch. ``chunk``: step the batch in world-chunks of
    this size, each through all its substeps before the next (JAX's
    ``lax.map``), to bound peak device memory: one chunk-sized graph, with
    a copy in and a copy out a chunk, into a new batch. Every solver's
    step is graphed on a card, DANTZIG's included; every step function on
    the CPU and under ``disable_graphs()`` runs the eager loop
    (``fn.graphed`` False on the CPU, the reason in ``fn.eager_reason``).

    The batch must lie on ``device``: the function raises rather than step
    it anywhere else. ``trimesh``: an optional static
    ``ops.trimesh.TriMesh`` on the same device, shared by every world.
    ``joints``: an optional ``ops.joints.JointSet`` on the same device, of
    one world (shared by every world) or of the whole batch (with
    ``chunk``, it must be of one world). On a card, a dense-pipeline batch
    whose intermediates would not fit raises, before any capture.
    """
    config.validate()
    if chunk and joints is not None and joints.kind.shape[0] != 1:
        raise ValueError("chunk needs a joint table of one world")
    want = torch.device(device)
    step_fn = graphs.StepFunction(
        lambda state: _step_impl(state, config, trimesh, joints=joints),
        substeps, unroll, donate, config, joints, want,
        closing_stamp="integrate")

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
        leaves, treedef = graphs.flatten(batch)
        out = [torch.empty_like(t) for t in leaves]
        for s in range(0, b_total, chunk):
            # donated: the chunk's result is copied out before the next
            # chunk is stepped in the same buffers
            _put_rows(out, s, step_fn(take_worlds(batch, s, s + chunk),
                                      donate=True))
        return graphs.unflatten(treedef, out)

    fn.graphed, fn.eager_reason = step_fn.graphed, step_fn.eager_reason
    fn.graphs = step_fn.graphs
    return fn
