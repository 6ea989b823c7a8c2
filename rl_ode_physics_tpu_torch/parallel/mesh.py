"""The world batch split over cards.

The port of ``rl_ode_physics_tpu/parallel/mesh.py``. Worlds are
independent, so the world batch is the only axis that spans cards, and
the step needs no communication between them: each card steps its own
contiguous block of worlds. A single world (at most 512 bodies) fits on
one card, so there is no other axis to split.

A ``Mesh`` is a tuple of devices. ``shard_batch`` cuts a batch into one
block of worlds a device, in mesh order (the layout of JAX's
``PartitionSpec(axis_name)`` on the leading axis), and ``gather_batch``
joins the blocks again on one device. The step functions take and return
a tuple of shards: every shard is stepped on its own device by a
``make_batched_step_fn`` made for that device, inside
``torch.cuda.device(shard_device)``. On the cards each shard's call is
one CUDA graph (``utils/graphs.py``) captured on its device, and one host
thread launches the shards in turn, one launch a shard, so that every
card has work queued while the host moves on to the next.

Two things bound what that overlap gives. An eager step (under
``disable_graphs()``), bound by the host's launches, costs D times the
host time on D shards. And two shards of one card run on its one stream,
one after the other. No solver's step reads the host (DANTZIG's pivot
loop is one hand kernel), so every solver's shards are graphed.

No tensor of one shard meets a tensor of another: PyTorch raises on any
operation that mixes devices, so a step that ran is a step that did not
communicate.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.parallel.batch import (
    concat_worlds, make_batched_step_fn, take_worlds)

WORLD_AXIS = "worlds"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices that the world axis is split over, in
    order. A device may appear more than once."""

    devices: tuple
    axis_name: str = WORLD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Equal contiguous blocks of the world axis, one a device of
    ``mesh``, in mesh order."""

    mesh: Mesh

    def spans(self, num_worlds: int):
        """[(device, start, stop)] of a batch of ``num_worlds`` worlds;
        raises unless the mesh divides it evenly."""
        d = self.mesh.size
        if num_worlds % d:
            raise ValueError(f"{num_worlds} worlds do not split evenly over "
                             f"{d} devices")
        per = num_worlds // d
        return [(dev, i * per, (i + 1) * per)
                for i, dev in enumerate(self.mesh.devices)]


def _device(spec) -> torch.device:
    dev = torch.device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the given devices, or over every card that
    ``torch.cuda.device_count()`` sees; raises where there is none."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA card found; pass the "
                               "devices explicitly")
        devices = [f"cuda:{i}" for i in range(count)]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """The world axis split over ``mesh``; every field of ``WorldState``
    carries that axis first."""
    return BatchSharding(mesh)


def _place(batch: WorldState, device) -> WorldState:
    return WorldState(**{f.name: getattr(batch, f.name).to(device, copy=True)
                         for f in dataclasses.fields(WorldState)})


def shard_batch(batch: WorldState, mesh: Mesh) -> tuple:
    """The batch cut into a tuple of shards, shard i a copy of block i of
    the worlds on ``mesh.devices[i]``; raises unless the mesh divides the
    batch evenly."""
    return tuple(_place(take_worlds(batch, start, stop), dev)
                 for dev, start, stop in batch_sharding(mesh).spans(
                     batch.num_worlds))


def gather_batch(shards: Sequence[WorldState], device=None) -> WorldState:
    """The shards joined into one batch on ``device`` (default: the first
    shard's), worlds in shard order."""
    device = shards[0].device if device is None else device
    return concat_worlds([_place(s, device) for s in shards])


def on_device(device):
    """The context in which a shard on ``device`` is stepped: the card
    made current, so that what the step launches goes to its streams."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check_shards(shards, mesh: Mesh) -> tuple:
    shards = tuple(shards)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} "
                         f"devices")
    for shard, dev in zip(shards, mesh.devices):
        if shard.device != dev:
            raise ValueError(f"a shard on {shard.device} where the mesh has "
                             f"{dev}")
    return shards


def make_sharded_step_fn(config: EngineConfig, mesh: Mesh,
                         substeps: int = 1, donate: bool = True):
    """A function that runs ``substeps`` substeps of every world of a
    sharded batch: a tuple of shards (``shard_batch``) in, the stepped
    tuple out, each shard on its device; the JAX ``make_sharded_step_fn``
    (``rl_ode_physics_tpu/parallel/mesh.py:60-83``), ``donate`` as there.
    Every shard is stepped by a ``make_batched_step_fn`` made for its
    device, the shards in turn: on the cards one CUDA graph of all its
    substeps a shard, captured on the shard's device, so one launch a
    shard."""
    config.validate()      # unsupported compositions error at config time
    steps = [make_batched_step_fn(config, substeps, donate, unroll=substeps,
                                  device=dev)
             for dev in mesh.devices]

    def fn(shards) -> tuple:
        shards = _check_shards(shards, mesh)
        stepped = []
        for dev, step_fn, shard in zip(mesh.devices, steps, shards):
            with on_device(dev):
                stepped.append(step_fn(shard))
        return tuple(stepped)

    fn.graphed = all(step.graphed for step in steps)
    fn.eager_reason = next((s.eager_reason for s in steps
                            if not s.graphed), "")
    return fn


def make_shard_map_step_fn(config: EngineConfig, mesh: Mesh,
                           substeps: int = 1):
    """The same function as ``make_sharded_step_fn``, without donation as
    the JAX ``make_shard_map_step_fn`` (``mesh.py:86-116``) has none. In
    JAX the two names are two routes through XLA to one semantics (GSPMD
    partitioning of the whole batch, and explicit per-device blocks under
    ``shard_map``); the port steps per-device blocks in both, so they are
    one implementation under both names."""
    return make_sharded_step_fn(config, mesh, substeps, donate=False)
