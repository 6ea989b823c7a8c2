"""Checkpoint / resume: bit-exact world snapshots in npz.

The port of ``rl_ode_physics_tpu/utils/checkpoint.py`` (npz ``save`` and
``load``; the orbax pair has no port). A checkpoint is the whole
``WorldState`` (tick counter and PRNG stream state included), so a restore
resumes the deterministic trajectory bit for bit.

The files are the JAX package's: the same field names and dtypes
(``category``, ``collide`` and ``rng_state`` as uint32), and a
``__config__`` entry that holds exactly the JAX ``EngineConfig`` fields. A
batch of one world is written without the world axis, as the JAX package
writes one world; a file of one world gains the axis on load, as
``utils/bridge.py`` gives it. Each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.utils import bridge


def _config_meta(config: EngineConfig) -> str:
    d = dataclasses.asdict(config)
    d["solver"] = config.solver.value
    return json.dumps(d)


def _config_from_meta(blob: str) -> EngineConfig:
    d = json.loads(blob)
    d["solver"] = SolverKind(d["solver"])
    # JSON turns tuples into lists; restore every tuple-typed field so the
    # frozen config compares (and hashes) equal to the original.
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return EngineConfig(**d)


def save(path: str, state, config: Optional[EngineConfig] = None) -> None:
    """Write an npz checkpoint of a batch (one world: without its axis)."""
    arrays = bridge.world_to_numpy(state,
                                   0 if state.num_worlds == 1 else None)
    if config is not None:
        arrays["__config__"] = np.frombuffer(
            _config_meta(config).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)                    # atomic publish


def load(path: str, device="cuda"):
    """→ (WorldState, EngineConfig | None), a batch on ``device``."""
    with np.load(path) as z:
        config = None
        if "__config__" in z:
            config = _config_from_meta(bytes(z["__config__"]).decode())
        arrays = {name: z[name] for name in z.files if name != "__config__"}
    # checkpoints written before per-body surface parameters get the
    # config (or ODE-default) values
    if "friction" not in arrays:
        shape = arrays["pos"].shape[:-1]
        f = arrays["pos"].dtype
        mu = config.mu if config is not None else float("inf")
        bo = config.bounce if config is not None else 0.2
        arrays["friction"] = np.full(shape, mu, f)
        arrays["restitution"] = np.full(shape, bo, f)
    return bridge.world_from_numpy(arrays, device=device), config
