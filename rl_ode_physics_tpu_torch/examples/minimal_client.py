"""Headless 2D-prototype client: parity with ``src/client.c:15-122``.
Connect to 127.0.0.1 (``:29-30``), receive an id, send player updates,
mirror the roster (prints instead of drawing circles).

The port of ``examples/minimal_client.py``, on the port's
``net.protocol`` and ``net.transport``; it moves no tensor, so it takes
no device.

    python -m rl_ode_physics_tpu_torch.examples.minimal_client \\
        [port] [duration_s]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rl_ode_physics_tpu_torch.net import protocol
from rl_ode_physics_tpu_torch.net.transport import EventType, Host


def main(port: int = 12345, duration: float = 5.0) -> int:
    host = Host(port=None, max_peers=1)
    try:
        peer = host.connect(("127.0.0.1", port))
        local_id = -1
        players = protocol.empty_players()
        pos = np.zeros(3, np.float32)
        t_end = time.monotonic() + duration
        while time.monotonic() < t_end:
            ev = host.service(0.016)    # ~60 FPS loop (src/client.c:45)
            if ev is not None and ev.type is EventType.RECEIVE:
                mtype = protocol.peek_type(ev.data)
                if mtype is protocol.MsgType.C_PLAYER_ID and local_id == -1:
                    local_id = protocol.decode_player_id(ev.data)
                    print("RECEIVED ID:", local_id, flush=True)
                elif mtype is protocol.MsgType.C_UPDATE_PLAYERS:
                    players = protocol.decode_update_players(ev.data)
            if local_id != -1:
                pos[0] += 0.01          # wander like the WASD drift
                peer.send(0, protocol.encode_player_update(
                    pos, [1.0, 0.0, 0.0], local_id))
        roster = int((players["id"] != -1).sum())
        print(f"roster size {roster}", flush=True)
        return roster
    finally:
        host.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("port", nargs="?", type=int, default=12345)
    parser.add_argument("duration", nargs="?", type=float, default=5.0)
    args = parser.parse_args()
    main(args.port, args.duration)
