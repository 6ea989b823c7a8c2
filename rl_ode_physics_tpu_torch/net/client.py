"""Headless game client: connect, mirror snapshots, send intents.

The port of ``rl_ode_physics_tpu/net/client.py`` (numpy and sockets only,
with the port's ``RandStream``); it talks to a server of either package.

Replicates the reference client loop (``main``, ``src/main.c:416-533``)
minus rendering (out of scope per SURVEY.md §2b): receives its player id,
mirrors the 60 Hz body/player snapshots, throttles its own player updates to
60 Hz (the reference's ``playerBroadcastTimer``, ``src/main.c:478-486``) and
spawns bodies (``ClientAddBody``, ``src/main.c:772-776``).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from rl_ode_physics_tpu_torch.net import protocol
from rl_ode_physics_tpu_torch.net.transport import EventType, Host
from rl_ode_physics_tpu_torch.utils.prng import RandStream

BROADCAST_TIME = 1.0 / 60.0


class GameClient:
    def __init__(self, server: Tuple[str, int] = ("127.0.0.1", 12345),
                 max_bodies: int = protocol.MAX_BODIES,
                 max_players: int = protocol.MAX_PLAYERS,
                 seed: int = 0):
        self.host = Host(port=None, max_peers=1)
        self.peer = self.host.connect(server)
        self.local_id = -1                       # src/player.c:6
        self.max_bodies = max_bodies
        self.players = protocol.empty_players(max_players)
        self.bodies = np.zeros((max_bodies,), protocol.BODY_STATE_DTYPE)
        self.rng = RandStream(seed)
        self._send_accum = 0.0
        self.pos = np.array([0.0, 2.0, -3.0], np.float32)  # playerCam default
        self.dir = np.array([0.0, 0.0, 1.0], np.float32)

    @property
    def connected(self) -> bool:
        return self.peer.connected and self.local_id != -1

    def pump(self, budget: float = 0.0):
        """Drain events (the 6 ms service loop, src/main.c:417)."""
        while True:
            ev = self.host.service(budget)
            if ev is None:
                return
            budget = 0.0
            if ev.type is not EventType.RECEIVE:
                continue
            mtype = protocol.peek_type(ev.data)
            if mtype is protocol.MsgType.C_PLAYER_ID:
                if self.local_id == -1:          # first-wins (src/main.c:422)
                    self.local_id = protocol.decode_player_id(ev.data)
            elif mtype is protocol.MsgType.C_UPDATE_PLAYERS:
                incoming = protocol.decode_update_players(ev.data)
                if incoming.shape[0] != self.players.shape[0]:
                    self.players = protocol.empty_players(incoming.shape[0])
                for i in range(self.players.shape[0]):
                    if i != self.local_id:       # skip self (src/main.c:433)
                        self.players[i] = incoming[i]
            elif mtype is protocol.MsgType.C_UPDATE_BODIES:
                self.bodies = protocol.decode_update_bodies(ev.data)
                self.max_bodies = self.bodies.shape[0]

    def update(self, dt: float):
        """Throttled 60 Hz player-state upload (src/main.c:478-486)."""
        self._send_accum += dt
        if self._send_accum >= BROADCAST_TIME and self.local_id != -1:
            self._send_accum = 0.0
            self.peer.send(0, protocol.encode_player_update(
                self.pos, self.dir, self.local_id))

    # --- spawning (reference keybinds M / SPACE, src/main.c:500-533) ------

    def spawn_body(self, body_type: int, transform16, size, color):
        self.peer.send(0, protocol.encode_new_body(
            body_type, transform16, size, color))

    @staticmethod
    def _identity_t16(pos):
        """Row-major wire transform at ``pos`` with identity rotation, in
        numpy (the spawn keys always send zero rotation,
        src/main.c:511,529)."""
        t16 = np.eye(4, dtype=np.float64).reshape(16)
        t16[12:15] = pos
        return t16

    def spawn_random(self):
        """The M-key spawner (src/main.c:502-522): see ``m_key_body``."""
        self.spawn_body(*m_key_body(self.rng))

    def spawn_at_camera(self):
        """The SPACE spawner (src/main.c:523-533): r=0.15 sphere at the
        camera position."""
        t16 = self._identity_t16(self.pos)
        self.spawn_body(1, t16, (0.15, 0.0, 0.0), self.rng.color())

    def throw_sphere(self, speed: float = 10.0):
        """Spawn a sphere launched along the view direction — the
        X_NEW_BODY_VEL extension that completes the reference's
        'bodies with initial forces' TODO (src/main.c:531-532)."""
        t16 = self._identity_t16(self.pos)
        self.peer.send(0, protocol.encode_new_body_vel(
            1, t16, (0.15, 0.0, 0.0), self.rng.color(),
            linvel=np.asarray(self.dir, np.float32) * speed))

    def close(self):
        # polite leave (enet_peer_disconnect before window close in the
        # reference): without it the server keeps the peer and retransmits
        # reliable snapshots to a dead address until its peer timeout
        if self.peer.connected:
            try:
                self.peer.disconnect()
            except OSError:
                pass
        self.host.close()


def m_key_body(rng: RandStream):
    """The M-key spawner's body (src/main.c:502-522): a random box or sphere
    at x,z∈[-4,4], y∈[20,50], drawn from ``rng`` with the reference's PRNG
    semantics. Returns ``(body_type, transform16, size, color)``."""
    pos = (rng.double(-4.0, 4.0), rng.double(20.0, 50.0),
           rng.double(-4.0, 4.0))
    t16 = GameClient._identity_t16(pos)
    if rng.randint(0, 2) == 0:
        size = (rng.double(0.2, 1.0), rng.double(0.2, 1.0),
                rng.double(0.2, 1.0))
        return 2, t16, size, rng.color()                # BODYTYPE_BOX
    size = (rng.double(0.1, 0.4), 0.0, 0.0)
    return 1, t16, size, rng.color()                    # BODYTYPE_SPHERE
