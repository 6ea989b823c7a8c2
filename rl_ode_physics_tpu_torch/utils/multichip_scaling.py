"""Weak scaling of stepping and of ES training over a mesh of cards.

The port of ``benchmarks/multichip_scaling.py``'s rows, with its
configuration, scene and defaults. Work per device is held constant while
the mesh grows (sizes 1, 2, 4, … up to the devices given):

1. **Stepping** (``parallel/mesh.make_sharded_step_fn``): the bench world
   (60 dynamic bodies of 64 slots) under the throughput policy, 64 worlds
   a device, 16 substeps a launch; per-device body-steps/s. The typed
   narrowphase compacts through the ``compact_rows_t`` hand kernel on
   every shard. The JAX script asserts zero collectives in the step's
   HLO; the port's form of that claim is asserted here: every tensor of
   every output shard lies on that shard's device (PyTorch raises on an
   operation that mixes devices, so none ran).
2. **ES training** (``examples/rl_training.make_trainer``): 4 population
   members a device (8 worlds), horizon 8; ms a train step, and its ratio
   to the one-device step.

One host thread launches every shard, so a host-bound step costs D times
the host time on D shards: D cards give about one card's throughput
until the step is captured in a CUDA graph.

    python3 -m rl_ode_physics_tpu_torch.utils.multichip_scaling \\
        [worlds_per_device substeps pop_per_device horizon] \\
        [--devices cuda:0,cuda:0]

``--devices`` defaults to every card found. The last line is the JAX
script's JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.examples.rl_training import make_trainer
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.parallel.mesh import (
    make_mesh, make_sharded_step_fn, shard_batch)

REPS = 3


def scaling_config() -> EngineConfig:
    """The JAX script's throughput-policy engine at a bench-like world."""
    return EngineConfig.throughput(
        max_bodies=64, max_pair_candidates=256, max_contacts=64,
        enable_capsules=False, enable_planes=False,
        bucket_caps=((1, 1, 96), (1, 2, 96), (2, 2, 48)),
    )


def _sync(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def shards_stay_on_their_devices(shards, mesh) -> bool:
    """Whether every tensor of shard i lies on ``mesh.devices[i]``."""
    return all(getattr(s, f.name).device == dev
               for s, dev in zip(shards, mesh.devices)
               for f in dataclasses.fields(WorldState))


def step_row(world, config, devices, worlds_per_device: int,
             substeps: int) -> dict:
    """Per-device body-steps/s of the sharded step over ``devices``."""
    d = len(devices)
    mesh = make_mesh(devices)
    batch = replicate(world, worlds_per_device * d, device=devices[0])
    shards = shard_batch(batch, mesh)
    fn = make_sharded_step_fn(config, mesh, substeps=substeps)
    out = fn(shards)                               # warm up
    _sync(mesh.devices)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(out)
    _sync(mesh.devices)
    dt = (time.perf_counter() - t0) / REPS
    if not shards_stay_on_their_devices(out, mesh):
        raise AssertionError(f"a shard left its device at d={d}")
    overflow = sum(int(s.overflow.sum()) for s in out)
    if overflow:
        raise AssertionError(f"contact capacity overflow at d={d}: "
                             f"{overflow} rows")
    num_dynamic = int((world.inv_mass > 0).sum())
    return {"devices": d, "bodysteps_per_sec_per_device":
            worlds_per_device * num_dynamic * substeps / dt,
            "worlds_per_device": worlds_per_device, "substeps": substeps,
            "substep_ms": dt / substeps * 1e3,
            "shards_on_own_devices": True}


def train_row(devices, pop_per_device: int, horizon: int,
              t_single) -> dict:
    """ms a train step of the ES trainer over ``devices``."""
    d = len(devices)
    mesh = make_mesh(devices) if d > 1 else None
    params, train = make_trainer(pop=pop_per_device * d, horizon=horizon,
                                 mesh=mesh, device=devices[0])
    generator = torch.Generator(device=train.lead).manual_seed(0)
    params, r = train(params, generator)           # warm up
    _sync(train.devices)
    t0 = time.perf_counter()
    for _ in range(REPS):
        params, r = train(params, generator)
    _sync(train.devices)
    dt = (time.perf_counter() - t0) / REPS
    if not torch.isfinite(r):
        raise AssertionError(f"non-finite mean reward at d={d}")
    return {"devices": d, "train_step_s": dt,
            "per_device_slowdown_vs_1dev": (dt / t_single if t_single
                                            else 1.0)}


def run(devices=None, worlds_per_device: int = 64, substeps: int = 16,
        pop_per_device: int = 4, horizon: int = 8) -> dict:
    """The stepping and training rows at mesh sizes 1, 2, 4, … up to
    ``len(devices)`` (default: every card found)."""
    devices = make_mesh(devices).devices
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    print(f"# devices: {len(devices)} ({', '.join(map(str, devices))}); "
          f"mesh sizes: {sizes}", file=sys.stderr)
    config = scaling_config()
    world = scenes.bench_world(config, num_bodies=60, device=devices[0])
    step_rows, train_rows = [], []
    for d in sizes:
        row = step_row(world, config, devices[:d], worlds_per_device,
                       substeps)
        step_rows.append(row)
        print(f"# step  d={d}: "
              f"{row['bodysteps_per_sec_per_device'] / 1e6:.3f}M "
              f"body-steps/s/device (shards on their own devices)",
              file=sys.stderr)
    t_single = None
    for d in sizes:
        row = train_row(devices[:d], pop_per_device, horizon, t_single)
        t_single = t_single or row["train_step_s"]
        train_rows.append(row)
        print(f"# train d={d}: {row['train_step_s'] * 1e3:.1f} ms/step at "
              f"{pop_per_device * d} pop "
              f"({row['per_device_slowdown_vs_1dev']:.2f}x the 1-device "
              f"time)", file=sys.stderr)
    return {
        "metric": "multichip weak scaling (per-device, worlds/device="
                  f"{worlds_per_device}, pop/device={pop_per_device})",
        "platform": devices[0].type,
        "devices": [str(d) for d in devices],
        "stepping": step_rows,
        "training": train_rows,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int,
                        help="worlds_per_device substeps pop_per_device "
                             "horizon")
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices (default: every "
                             "card)")
    args = parser.parse_args(argv)
    devices = None if args.devices is None else args.devices.split(",")
    print(json.dumps(run(devices, *args.sizes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
