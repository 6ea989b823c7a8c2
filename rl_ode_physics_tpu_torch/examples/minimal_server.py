"""Player-only replication server: parity with the reference's standalone
2D prototype (``src/server.c:17-111``). No physics, no world: connect →
id assignment → player-state echo, rebroadcast when dirty (``:99-104``).

The port of ``examples/minimal_server.py``, on the port's
``net.protocol`` and ``net.transport``; it moves no tensor, so it takes
no device.

    python -m rl_ode_physics_tpu_torch.examples.minimal_server [port]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rl_ode_physics_tpu_torch.net import protocol
from rl_ode_physics_tpu_torch.net.transport import EventType, Host


def main(port: int = 12345, duration: float = None):
    host = Host(port=port, max_peers=protocol.MAX_PLAYERS)
    players = protocol.empty_players()
    peer_to_pid = {}
    dirty = False
    print(f"minimal server on port {host.port}", flush=True)
    t_end = None if duration is None else time.monotonic() + duration
    try:
        while t_end is None or time.monotonic() < t_end:
            ev = host.service(1.0)      # 1000 ms timeout like src/server.c:40
            if ev is None:
                continue
            if ev.type is EventType.CONNECT:
                free = np.flatnonzero(players["id"] == -1)
                if free.size == 0:
                    ev.peer.disconnect()
                    continue
                pid = int(free[0])
                players["id"][pid] = pid
                peer_to_pid[ev.peer.addr] = pid
                ev.peer.send(0, protocol.encode_player_id(pid))
                dirty = True
            elif ev.type is EventType.RECEIVE:
                if (protocol.peek_type(ev.data)
                        is protocol.MsgType.S_PLAYER_UPDATE):
                    upd = protocol.decode_player_update(ev.data)
                    players[upd["id"]] = (tuple(upd["pos"]),
                                          tuple(upd["dir"]), upd["id"])
                    dirty = True
            elif ev.type is EventType.DISCONNECT:
                pid = peer_to_pid.pop(ev.peer.addr, None)
                if pid is not None:
                    players["id"][pid] = -1
                    dirty = True
            if dirty:                    # rebroadcast-on-update (:99-104)
                host.broadcast(0, protocol.encode_update_players(players))
                dirty = False
    finally:
        host.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("port", nargs="?", type=int, default=12345)
    args = parser.parse_args()
    main(args.port)
