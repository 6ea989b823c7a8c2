"""CLI entry — replaces the reference's raygui main menu (src/main.c:385-409).

    python -m rl_ode_physics_tpu_torch.net server [--device cuda|cpu]
                                                  [--port 12345] [--capsules]
    python -m rl_ode_physics_tpu_torch.net client [--ip 127.0.0.1]
                                                  [--port 12345] [--spawn N]
                                                  [--duration S]

The port of ``rl_ode_physics_tpu/net/__main__.py``. The server runs the
authoritative sim headlessly on ``--device`` (the card by default;
unconditional 120 Hz tick, 60 Hz snapshot broadcast); the client, which
touches no device, connects, optionally spawns N random bodies with the
reference's M-key distribution, and mirrors snapshots. Either talks to the
other package's counterpart. The hand kernels, where a configuration runs
one, are cached by ``ops/kernel_build`` under ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rl_ode_physics_tpu_torch.net")
    sub = parser.add_subparsers(dest="role", required=True)

    ps = sub.add_parser("server")
    ps.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the world steps")
    ps.add_argument("--port", type=int, default=12345)   # src/main.c:67
    ps.add_argument("--max-players", type=int, default=32)
    ps.add_argument("--max-bodies", type=int, default=512,  # inc/body.h:6
                    help="world capacity (static shape; smaller = faster)")
    ps.add_argument("--capsules", action="store_true",
                    help="embody players as kinematic capsules")
    ps.add_argument("--duration", type=float, default=None)
    ps.add_argument("--seed", type=int, default=0)

    pc = sub.add_parser("client")
    pc.add_argument("--ip", default="127.0.0.1")
    pc.add_argument("--port", type=int, default=12345)
    pc.add_argument("--max-bodies", type=int, default=512,
                    help="must match the server's world capacity")
    pc.add_argument("--spawn", type=int, default=0,
                    help="spawn N random bodies after connecting")
    pc.add_argument("--duration", type=float, default=5.0)
    pc.add_argument("--seed", type=int, default=0)

    args = parser.parse_args(argv)

    if args.role == "server":
        from rl_ode_physics_tpu_torch.core.config import EngineConfig
        from rl_ode_physics_tpu_torch.net.server import GameServer

        n = args.max_bodies
        config = EngineConfig(max_bodies=n, max_pair_candidates=4 * n,
                              max_contacts=8 * n)
        server = GameServer(config, port=args.port,
                            max_players=args.max_players,
                            seed=args.seed, player_capsules=args.capsules,
                            device=args.device)
        print(f"Server started on port {server.host.port} "
              f"({args.device}).", flush=True)
        try:
            server.run(args.duration)
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
        return 0

    from rl_ode_physics_tpu_torch.net.client import GameClient

    client = GameClient((args.ip, args.port), max_bodies=args.max_bodies,
                        seed=args.seed)
    t_end = time.monotonic() + args.duration
    spawned = 0
    t_prev = time.monotonic()
    try:
        while time.monotonic() < t_end:
            client.pump(0.005)
            now = time.monotonic()
            client.update(now - t_prev)
            t_prev = now
            if client.connected and spawned < args.spawn:
                client.spawn_random()
                spawned += 1
        active = int((client.bodies["type"] != 0).sum())
        print(f"client id={client.local_id} mirrored {active} bodies",
              flush=True)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
