"""The port's wire protocol, transports, client and CLI against the JAX
package's.

The encoders are held byte for byte to the JAX package's for every message
type; a JAX ``GameClient`` is served by the port's ``GameServer`` (on the
CPU, over loopback UDP, the native transport) and a port client by the JAX
server, each mirroring the other's spawn; the CLI's server and client run
in subprocesses on ``--device cpu``.
"""

import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from _torch_port import SUBPROCESS_ENV, single_cpu_thread  # noqa: F401
from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.net import protocol as jproto
from rl_ode_physics_tpu.net.client import GameClient as JaxClient
from rl_ode_physics_tpu.net.server import GameServer as JaxServer
from rl_ode_physics_tpu.net.transport import Host as JaxHost
from rl_ode_physics_tpu.utils.prng import RandStream as JaxRandStream
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.net import native_transport as nt
from rl_ode_physics_tpu_torch.net import protocol as tproto
from rl_ode_physics_tpu_torch.net.client import GameClient as TorchClient
from rl_ode_physics_tpu_torch.net.client import m_key_body
from rl_ode_physics_tpu_torch.net.server import GameServer as TorchServer
from rl_ode_physics_tpu_torch.net.transport import EventType
from rl_ode_physics_tpu_torch.net.transport import Host as TorchHost
from rl_ode_physics_tpu_torch.utils.prng import RandStream

ROOT = Path(__file__).resolve().parents[1]
CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=64)


def _players(p):
    players = p.empty_players(4)
    players["id"][:3] = [0, 1, 2]
    players["pos"][1] = [1.0, 2.5, -3.0]
    players["dir"][2] = [0.0, 0.6, 0.8]
    return players


def _bodies(p):
    rng = np.random.default_rng(5)
    bodies = np.zeros((16,), p.BODY_STATE_DTYPE)
    bodies["type"] = rng.integers(0, 4, 16)
    bodies["transform"] = rng.normal(size=(16, 16))
    bodies["size"] = rng.uniform(0.1, 1.0, size=(16, 3))
    bodies["col"] = rng.integers(0, 256, size=(16, 4))
    return bodies


T16 = np.random.default_rng(6).normal(size=16)
MESSAGES = {
    "player_id": (lambda p: p.encode_player_id(7), "decode_player_id"),
    "player_update": (lambda p: p.encode_player_update(
        [1.5, 2.0, 3.0], [0.0, 0.6, 0.8], 5), "decode_player_update"),
    "update_players": (lambda p: p.encode_update_players(_players(p)),
                       "decode_update_players"),
    "update_bodies": (lambda p: p.encode_update_bodies(_bodies(p)),
                      "decode_update_bodies"),
    "new_body": (lambda p: p.encode_new_body(2, T16, (0.3, 0.4, 0.5),
                                             (10, 20, 30, 255)),
                 "decode_new_body"),
    "new_body_vel": (lambda p: p.encode_new_body_vel(
        1, T16, (0.15, 0.0, 0.0), (1, 2, 3, 255), linvel=(3.0, 1.0, 0.0),
        angvel=(0.0, 0.5, 0.0)), "decode_new_body_vel"),
}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", list(MESSAGES))
def test_encoder_bytes_equal_jax_and_decoders_read_each_other(name):
    encode, decode = MESSAGES[name]
    data = encode(tproto)
    assert data == encode(jproto)
    assert tproto.peek_type(data).value == jproto.peek_type(data).value
    _equal(getattr(tproto, decode)(data), getattr(jproto, decode)(data))


def test_wire_dtypes_equal_jax():
    assert tproto.BODY_STATE_DTYPE == jproto.BODY_STATE_DTYPE
    assert tproto.PLAYER_STATE_DTYPE == jproto.PLAYER_STATE_DTYPE
    assert (tproto.msg_update_bodies_dtype(512)
            == jproto.msg_update_bodies_dtype(512))
    assert [m.value for m in tproto.MsgType] == [m.value
                                                 for m in jproto.MsgType]


def _drain(hosts, budget):
    events = {id(h): [] for h in hosts}
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        for h in hosts:
            ev = h.service(0.002)
            if ev is not None:
                events[id(h)].append(ev)
    return [events[id(h)] for h in hosts]


@pytest.mark.parametrize("server_kind", ["port_python", "port_native"])
def test_port_host_talks_to_jax_host(server_kind):
    """A JAX Python ``Host`` connects to the port's Python or native host
    and each delivers a fragmented message to the other."""
    server = (TorchHost(port=None, max_peers=4) if server_kind == "port_python"
              else nt.NativeHost(port=None, max_peers=4))
    client = JaxHost(port=None, max_peers=1)
    try:
        peer = client.connect(("127.0.0.1", server.port))
        sev = []
        for _ in range(100):
            s, _ = _drain([server, client], 0.01)
            sev += s
            if peer.connected and sev:
                break
        assert peer.connected
        big = bytes(range(256)) * 400
        peer.send(0, big)
        got = []
        for _ in range(100):
            got += _drain([server, client], 0.01)[0]
            if any(e.type is EventType.RECEIVE for e in got):
                break
        assert [e.data for e in got if e.type is EventType.RECEIVE] == [big]
        speer = next(e.peer for e in sev if e.type is EventType.CONNECT)
        speer.send(0, b"from-port" * 9000)
        back = []
        for _ in range(100):
            back += _drain([server, client], 0.01)[1]
            if any(e.data for e in back):
                break
        assert [e.data for e in back if e.data] == [b"from-port" * 9000]
    finally:
        client.close()
        server.close()


def test_make_host_builds_the_native_library_under_build():
    host = nt.make_host(port=None)
    try:
        assert isinstance(host, nt.NativeHost)
        assert nt.LIB_PATH == ROOT / "build" / "native" / "libtransport.so"
        assert nt.LIB_PATH.exists()
    finally:
        host.close()
    host = nt.make_host(port=None, prefer_native=False)
    try:
        assert isinstance(host, TorchHost)
    finally:
        host.close()


def _mirror_spawn(server, client, sim_world_active):
    """Connect, spawn a sphere at the camera, run 30 broadcast intervals:
    the client mirrors 4 arena boxes and the sphere, which has fallen."""
    for _ in range(200):
        server.pump(0.005)
        client.pump(0.005)
        if client.connected:
            break
    assert client.connected and client.local_id == 0
    client.spawn_at_camera()
    for _ in range(100):
        server.pump(0.005)
        if sim_world_active() >= 5:
            break
    assert sim_world_active() == 5
    for _ in range(30):
        server.tick(1.0 / 60.0)
        server.pump(0.002)
        client.pump(0.01)
    types = client.bodies["type"]
    assert (types == 1).sum() == 1 and (types == 2).sum() == 4
    sphere = int(np.flatnonzero(types == 1)[0])
    assert client.bodies["transform"][sphere][13] < 2.0


@pytest.mark.parametrize("seed", [0, 7])
def test_m_key_body_draws_as_the_jax_client(seed):
    """``m_key_body`` draws the JAX client's ``spawn_random`` bodies, in the
    same order from the same seed."""
    jax_client = object.__new__(JaxClient)      # no socket: spawns recorded
    jax_client.rng = JaxRandStream(seed)
    want = []
    jax_client.spawn_body = lambda *body: want.append(body)
    rng = RandStream(seed)
    for _ in range(40):
        jax_client.spawn_random()
        kind, t16, size, color = m_key_body(rng)
        w_kind, w_t16, w_size, w_color = want[-1]
        assert kind == w_kind and tuple(size) == tuple(w_size)
        assert tuple(color) == tuple(w_color)
        np.testing.assert_array_equal(t16, w_t16)
    assert {body[0] for body in want} == {1, 2}


def test_jax_client_on_port_server():
    server = TorchServer(TorchConfig(**CAPS), port=0, max_players=4,
                         device="cpu")
    assert isinstance(server.host, nt.NativeHost)
    client = JaxClient(("127.0.0.1", server.host.port), max_bodies=16,
                       max_players=4)
    try:
        _mirror_spawn(server, client,
                      lambda: int(server.sim.world.active.sum()))
        assert any("spawned body type 1" in line for line in server.log)
    finally:
        client.close()
        server.close()


def test_port_client_on_jax_server():
    server = JaxServer(JaxConfig(**CAPS), port=0, max_players=4)
    client = TorchClient(("127.0.0.1", server.host.port), max_bodies=16,
                         max_players=4)
    try:
        _mirror_spawn(server, client,
                      lambda: int(np.sum(np.asarray(server.sim.world.active))))
    finally:
        client.close()
        server.close()


def test_port_server_full_rejects():
    server = TorchServer(TorchConfig(**CAPS), port=0, max_players=1,
                         device="cpu")
    clients = [TorchClient(("127.0.0.1", server.host.port), max_players=1)
               for _ in range(2)]
    try:
        for _ in range(150):
            server.pump(0.005)
            for c in clients:
                c.pump(0.005)
        assert sum(c.local_id != -1 for c in clients) == 1
        assert any("full" in line for line in server.log)
    finally:
        for c in clients:
            c.close()
        server.close()


def test_cli_server_and_client_on_cpu():
    """``python -m rl_ode_physics_tpu_torch.net`` server on ``--device
    cpu`` and a client that spawns 3 bodies: it mirrors the 4 arena boxes
    and the 3 bodies."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cli = [sys.executable, "-m", "rl_ode_physics_tpu_torch.net"]
    server = subprocess.Popen(
        cli + ["server", "--device", "cpu", "--port", str(port),
               "--max-bodies", "32", "--duration", "12"],
        cwd=ROOT, env=SUBPROCESS_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        first = server.stdout.readline()
        assert "Server started" in first and "(cpu)" in first, first
        client = subprocess.run(
            cli + ["client", "--port", str(port), "--max-bodies", "32",
                   "--spawn", "3", "--duration", "6"],
            cwd=ROOT, env=SUBPROCESS_ENV, capture_output=True, text=True,
            timeout=60)
        assert "client id=0 mirrored 7 bodies" in client.stdout, (
            client.stdout + client.stderr)
        server.communicate(timeout=60)
        assert server.returncode == 0
    finally:
        server.kill()
        server.wait()
