"""Authoritative game server: deterministic sim core + transport shell.

The port of ``rl_ode_physics_tpu/net/server.py``, which replicates the
reference's ``StartServer`` (``src/main.c:59-270``) with the reference's
defects fixed (SURVEY.md §2e):

* physics ticks unconditionally at 120 Hz — the reference only stepped
  inside the ENet event loop, freezing the sim when idle
  (``src/main.c:206-216`` being inside ``while(enet_host_service…)``),
* spawn requests at capacity are *reported* (slot -1), not silently dropped
  (``src/main.c:178-182``).

``SimCore`` is a deterministic simulation shell around the step of a batch
of one world: every input is a (tick, intent) record, so a recorded intent
stream replays bitwise (BASELINE config 5). ``GameServer`` adds the
reliable-UDP transport, the player table, and the 60 Hz snapshot broadcast
(``BROADCAST_TIME``, ``src/main.c:28,218-253``). Both run on the card unless
the caller passes ``device="cpu"``. On the card a tick is one CUDA graph
launch (``core/world.make_step_fn(..., donate=False)``, and the graphed
diagnostics step), beside one copy in and one out of each ``WorldState``
field; intents stay eager writes between ticks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, CollMask, WorldState
from rl_ode_physics_tpu_torch.core.world import (
    add_body, make_diagnostics_step_fn, make_step_fn, release_body,
    set_body_pose)
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.net import protocol
from rl_ode_physics_tpu_torch.net.native_transport import make_host
from rl_ode_physics_tpu_torch.net.transport import Event, EventType
from rl_ode_physics_tpu_torch.ops import lcp
from rl_ode_physics_tpu_torch.utils import transforms as tf
from rl_ode_physics_tpu_torch.utils.profiling import MetricsLog

PORT = 12345                     # src/main.c:67
BROADCAST_TIME = 1.0 / 60.0      # src/main.c:28
PHYSICS_DT = 1.0 / 120.0         # src/main.c:208


@dataclasses.dataclass
class Intent:
    """A deterministic sim input, applied at a tick boundary."""
    tick: int
    kind: str                    # "spawn", "player_join", ...
    payload: dict


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors as numpy arrays, read in one device-to-host copy: their
    bytes are joined on the device and split again on the host."""
    flat = torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].view(dtype).reshape(t.shape))
        at += n
    return out


class SimCore:
    """Deterministic authoritative simulation (no transport, no wall clock).

    ``world`` is a batch of one world; every intent, ``advance``, the
    overflow check and the snapshots act on world 0. All mutation happens
    in the step or through recorded intents, so (initial state, intent log)
    → final state is a pure function.
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 world: Optional[WorldState] = None, seed: int = 0,
                 player_capsules: bool = False, diagnostics: bool = False,
                 device="cuda"):
        self.config = config or EngineConfig()
        self.world = (world if world is not None
                      else scenes.grass_plane_world(self.config, seed,
                                                    device=device))
        if self.world.num_worlds != 1:
            raise ValueError(f"SimCore steps one world, got "
                             f"{self.world.num_worlds}")
        # one CUDA graph launch a tick on a card (core/world.make_step_fn);
        # not donated: the state between ticks is the caller's to keep
        self._step1 = make_step_fn(self.config, substeps=1, donate=False)
        self.tick = 0
        self._overflow_checked_tick = 0
        self._overflow_reported = 0
        self.intent_log: List[Intent] = []
        # per-tick observability counters (SURVEY.md §5 metrics plan), from
        # a step that returns them beside the state, graphed as the step is
        self.metrics = MetricsLog() if diagnostics else None
        self._diag_step = (make_diagnostics_step_fn(self.config)
                           if diagnostics else None)
        # player embodiment (fixes the reference's floating-camera TODO,
        # src/main.c:244: "make players special bodies instead of cameras")
        self.player_capsules = player_capsules
        self.player_slots: Dict[int, int] = {}
        self._appliers = {
            "spawn": self._apply_spawn,
            "player_join": self._apply_player_join,
            "player_move": self._apply_player_move,
            "player_leave": self._apply_player_leave,
        }

    @property
    def device(self) -> torch.device:
        return self.world.device

    def apply_intent(self, intent: Intent):
        """Dispatch a recorded intent (replay path)."""
        return self._appliers[intent.kind](intent.payload)

    # --- intents ---------------------------------------------------------

    def spawn_body(self, body_type: int, transform16: np.ndarray,
                   size: np.ndarray, color: np.ndarray,
                   linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0),
                   record: bool = True) -> int:
        """Apply a MsgNewBody spawn (reference handler ``src/main.c:178-182``
        → ``AddBody(…, CMASK_OBJ, CMASK_OBJ|CMASK_MAP, …)``).

        Position from elements 12..14, rotation rows from elements 0..11
        (``GetTransMatPos/GetTransMatRot``, ``src/main.c:653-663``).
        ``linvel``/``angvel`` serve the X_NEW_BODY_VEL extension (the
        reference's src/main.c:531 TODO).
        """
        payload = dict(
            type=int(body_type),
            transform=np.asarray(transform16, np.float64).tolist(),
            size=np.asarray(size, np.float32).tolist(),
            color=np.asarray(color, np.uint8).tolist(),
            linvel=np.asarray(linvel, np.float32).tolist(),
            angvel=np.asarray(angvel, np.float32).tolist(),
        )
        if record:
            self.intent_log.append(Intent(self.tick, "spawn", payload))
        return self._apply_spawn(payload)

    def _apply_spawn(self, payload: dict) -> int:
        # the wire transform is cast to the world's dtype and read on the
        # host: one spawn's pose is a few scalars, and the card then gets
        # the quaternion the CPU computes
        t16 = torch.tensor(payload["transform"], dtype=self.world.pos.dtype)
        self.world, slot = add_body(
            self.world,
            payload["type"],
            tf.pos_from_mat16(t16),
            payload["size"],
            quat=tf.quat_from_mat16_rowmajor(t16),
            category=int(CollMask.OBJ),
            collide=int(CollMask.OBJ) | int(CollMask.MAP),
            color=payload["color"],
            linvel=payload.get("linvel", (0.0, 0.0, 0.0)),
            angvel=payload.get("angvel", (0.0, 0.0, 0.0)),
        )
        return int(slot[0])

    # --- player embodiment intents ----------------------------------------

    PLAYER_RADIUS = 0.5          # players drawn as r=0.5 spheres, src/main.c:315
    PLAYER_LENGTH = 1.0
    PLAYER_SPAWN = (0.0, 2.0, -3.0)   # playerCam default, src/player.c:8

    def player_join(self, pid: int, record: bool = True) -> int:
        if not self.player_capsules:
            return -1
        payload = dict(pid=int(pid))
        if record:
            self.intent_log.append(Intent(self.tick, "player_join", payload))
        return self._apply_player_join(payload)

    def _apply_player_join(self, payload: dict) -> int:
        self.world, slot = add_body(
            self.world, int(BodyType.CAPSULE), self.PLAYER_SPAWN,
            (self.PLAYER_RADIUS, self.PLAYER_LENGTH, 0.0),
            kinematic=True,
            color=(0, 121, 241, 255),       # BLUE, src/main.c:315
        )
        self.player_slots[payload["pid"]] = int(slot[0])
        return self.player_slots[payload["pid"]]

    def player_move(self, pid: int, pos, record: bool = True):
        """Kinematic capsule follows the player camera; its velocity is the
        displacement over one broadcast interval so pushes transfer
        momentum to dynamic bodies."""
        if not self.player_capsules or pid not in self.player_slots:
            return
        payload = dict(pid=int(pid), pos=[float(x) for x in pos])
        if record:
            self.intent_log.append(Intent(self.tick, "player_move", payload))
        self._apply_player_move(payload)

    def _apply_player_move(self, payload: dict):
        slot = self.player_slots.get(payload["pid"], -1)
        if slot < 0:
            return
        pos = torch.tensor(payload["pos"], dtype=self.world.pos.dtype,
                           device=self.device)
        vel = (pos - self.world.pos[0, slot]) * 60.0   # BROADCAST_TIME cadence
        self.world = set_body_pose(self.world, slot, pos=pos, linvel=vel)

    def player_leave(self, pid: int, record: bool = True):
        if not self.player_capsules or pid not in self.player_slots:
            return
        payload = dict(pid=int(pid))
        if record:
            self.intent_log.append(Intent(self.tick, "player_leave", payload))
        self._apply_player_leave(payload)

    def _apply_player_leave(self, payload: dict):
        slot = self.player_slots.pop(payload["pid"], -1)
        if slot >= 0:
            self.world = release_body(self.world, slot)

    # --- stepping --------------------------------------------------------

    def advance(self, substeps: int = 1):
        """Advance ``substeps`` × 120 Hz fixed steps."""
        for _ in range(substeps):
            if self.metrics is not None:
                self.world, m = self._diag_step(self.world)
                self.tick += 1
                self.metrics.append(self.tick, m)
            else:
                self.world = self._step1(self.world)
                self.tick += 1
        # loud capacity overflow (default path, no diagnostics needed):
        # a ~1 Hz device scalar read; warn whenever the cumulative count of
        # dropped pairs/contacts and capped DANTZIG solves has grown since
        # the last check
        if self.tick - self._overflow_checked_tick >= 120:
            self._overflow_checked_tick = self.tick
            self.check_overflow()

    def check_overflow(self) -> int:
        """Cumulative ``WorldState.overflow``: dropped pair/contact rows
        and DANTZIG solves stopped at the round cap; warns when it grows."""
        count = int(self.world.overflow[0])
        if count > self._overflow_reported:
            warnings.warn(
                f"physics capacity overflow: {count} pair/contact rows "
                f"dropped or DANTZIG solves stopped at "
                f"{lcp.MAX_PIVOT_ROUNDS} pivot rounds so far (tick "
                f"{self.tick}) — raise max_contacts / max_pair_candidates / "
                f"bucket_caps for dropped rows", RuntimeWarning,
                stacklevel=2)
            self._overflow_reported = count
        return count

    # --- snapshots -------------------------------------------------------

    def body_states(self) -> np.ndarray:
        """Wire-format BodyState[max_bodies] snapshot — the broadcast
        read-back of ``src/main.c:221-240``. The column-major transforms
        (``GetTransformMat``) are computed on the device in the state's
        dtype and cast to float64 on the host; transforms, sizes, types and
        colours come back in one device-to-host copy."""
        w = self.world
        m16, size, body_type, color = _to_host(
            tf.mat16_from_pos_quat(w.pos[0], w.quat[0]), w.size[0],
            w.body_type[0], w.color[0])
        out = np.zeros((self.config.max_bodies,), protocol.BODY_STATE_DTYPE)
        out["type"] = body_type
        out["transform"] = m16.astype(np.float64)
        out["size"] = size.astype(np.float32)
        out["col"] = color
        # NULL slots broadcast as type 0 (clients skip them, src/main.c:301)
        return out

    def state_digest(self) -> bytes:
        """Bitwise digest of world 0's dynamic state (determinism checks):
        the bytes of the JAX package's digest, whose (N, 3) arrays are the
        port's (1, N, 3) ones."""
        w = self.world
        h = hashlib.sha256()
        for arr in _to_host(w.pos, w.quat, w.linvel, w.angvel, w.body_type):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest().encode()


class GameServer:
    """Transport + player table around SimCore (reference ``StartServer``)."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 port: int = PORT, max_players: int = protocol.MAX_PLAYERS,
                 seed: int = 0, player_capsules: bool = False,
                 prefer_native: bool = True, device="cuda"):
        self.sim = SimCore(config, seed=seed, player_capsules=player_capsules,
                           device=device)
        # the C++ transport when it builds (same wire format), else the
        # Python Host. Peer headroom beyond the player table: the transport
        # enforces max_peers (ENet parity), and the reference's server-full
        # path (accept, then disconnect when no player slot is free,
        # src/main.c:164-167) needs the transport to accept that connection
        self.host = make_host(port=port, max_peers=max_players + 2,
                              prefer_native=prefer_native)
        self.max_players = max_players
        self.players = protocol.empty_players(max_players)
        self.peer_to_player: Dict[Tuple[str, int], int] = {}
        self.player_dirty = False
        self._phys_accum = 0.0
        self._bcast_accum = 0.0
        self.log: List[str] = []

    # --- event handling (reference switch, src/main.c:142-204) -----------

    def handle_event(self, ev: Event):
        if ev.type is EventType.CONNECT:
            free = np.flatnonzero(self.players["id"] == -1)
            if free.size == 0:
                ev.peer.disconnect()      # server full (src/main.c:164-167)
                self.log.append("server full, disconnected client")
                return
            pid = int(free[0])
            self.players["id"][pid] = pid
            self.players["pos"][pid] = 0.0
            self.players["dir"][pid] = 0.0
            self.peer_to_player[ev.peer.addr] = pid
            ev.peer.send(0, protocol.encode_player_id(pid))
            self.player_dirty = True
            self.sim.player_join(pid)
            self.log.append(f"assigned id {pid}")
        elif ev.type is EventType.RECEIVE:
            mtype = protocol.peek_type(ev.data)
            if mtype is protocol.MsgType.S_PLAYER_UPDATE:
                upd = protocol.decode_player_update(ev.data)
                pid = upd["id"]
                if 0 <= pid < self.max_players:
                    self.players["pos"][pid] = upd["pos"]
                    self.players["dir"][pid] = upd["dir"]
                    self.players["id"][pid] = pid
                    self.player_dirty = True
                    self.sim.player_move(pid, upd["pos"])
            elif mtype is protocol.MsgType.S_NEW_BODY:
                body = protocol.decode_new_body(ev.data)
                slot = self.sim.spawn_body(
                    body["type"], body["transform"], body["size"],
                    body["color"])
                if slot < 0:
                    self.log.append("spawn dropped: world full")
                else:
                    self.log.append(f"spawned body type {body['type']} "
                                    f"slot {slot}")
            elif mtype is protocol.MsgType.X_NEW_BODY_VEL:
                body = protocol.decode_new_body_vel(ev.data)
                slot = self.sim.spawn_body(
                    body["type"], body["transform"], body["size"],
                    body["color"], linvel=body["linvel"],
                    angvel=body["angvel"])
                if slot < 0:
                    self.log.append("spawn dropped: world full")
        elif ev.type is EventType.DISCONNECT:
            pid = self.peer_to_player.pop(ev.peer.addr, None)
            if pid is not None:
                self.players["id"][pid] = -1
                self.player_dirty = True
                self.sim.player_leave(pid)
                self.log.append("client disconnected")

    # --- main loop -------------------------------------------------------

    def pump(self, budget: float = 0.0):
        """Drain transport events (enet_host_service loop)."""
        while True:
            ev = self.host.service(budget)
            if ev is None:
                return
            self.handle_event(ev)
            budget = 0.0

    MAX_SUBSTEPS_PER_TICK = 8    # spiral-of-death guard: drop time when the
                                 # host can't sustain 120 Hz; the reference
                                 # has no guard and would stall identically

    def tick(self, dt: float):
        """Advance wall-clock dt: 60 Hz broadcast + fixed-rate physics
        (the accumulator pattern of ``src/main.c:206-253``).

        Broadcast runs first so snapshots keep flowing even when the host
        falls behind the 120 Hz physics cadence (sim time then dilates
        instead of the stream stalling).
        """
        self._bcast_accum += dt
        if self._bcast_accum >= BROADCAST_TIME:
            self._bcast_accum = 0.0
            self.broadcast()

        self._phys_accum += dt
        substeps = int(self._phys_accum / PHYSICS_DT)
        if substeps > 0:
            if substeps > self.MAX_SUBSTEPS_PER_TICK:
                substeps = self.MAX_SUBSTEPS_PER_TICK
                self._phys_accum = 0.0
            else:
                self._phys_accum -= substeps * PHYSICS_DT
            self.sim.advance(substeps)

    def broadcast(self):
        self.host.broadcast(
            0, protocol.encode_update_bodies(self.sim.body_states())
        )
        if self.player_dirty:
            self.host.broadcast(
                0, protocol.encode_update_players(self.players)
            )
            self.player_dirty = False

    def run(self, duration: Optional[float] = None):
        """Unconditional tick loop (fixes the idle-freeze defect)."""
        self.sim.advance(1)          # first step before serving
        t_prev = time.monotonic()
        t_end = None if duration is None else t_prev + duration
        while t_end is None or time.monotonic() < t_end:
            self.pump(0.002)
            now = time.monotonic()
            self.tick(now - t_prev)
            t_prev = now

    def close(self):
        self.host.close()
