"""Lockstep replay: record an intent stream, re-run it bit-exactly.

The port of ``rl_ode_physics_tpu/net/replay.py``. The intent log is the
same JSON lines, so a log written by either package replays in the other.

BASELINE config 5: "Deterministic lockstep server tick: bitwise-reproducible
multi-client replay". Because ``SimCore`` is pure — the step has fixed
iteration counts, no data-dependent shapes, no atomics and no scatter-add
(the solver's scatter is a one-hot ``bmm``) —
(initial seed, intent log) fully determines the trajectory. This module
serializes intent logs and re-executes them.
"""

from __future__ import annotations

import json
from typing import List, Optional

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.net.server import Intent, SimCore


def save_log(intents: List[Intent], path: str):
    with open(path, "w") as f:
        for it in intents:
            f.write(json.dumps(
                dict(tick=it.tick, kind=it.kind, payload=it.payload)) + "\n")


def load_log(path: str) -> List[Intent]:
    out = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out.append(Intent(d["tick"], d["kind"], d["payload"]))
    return out


def replay(intents: List[Intent], total_ticks: int,
           config: Optional[EngineConfig] = None, seed: int = 0,
           player_capsules: bool = False, device="cuda") -> SimCore:
    """Re-execute an intent stream against a fresh world; returns the
    SimCore at ``total_ticks``. Intents apply at their recorded tick
    boundary, before that tick's step — matching the server's event-then-
    step ordering (src/main.c:142-216). Intents recorded at the same tick
    keep their original relative order (stable sort)."""
    sim = SimCore(config, seed=seed, player_capsules=player_capsules,
                  device=device)
    queue = sorted(intents, key=lambda it: it.tick)   # stable
    qi = 0
    while sim.tick < total_ticks:
        while qi < len(queue) and queue[qi].tick == sim.tick:
            sim.apply_intent(queue[qi])
            qi += 1
        sim.advance(1)
    return sim
