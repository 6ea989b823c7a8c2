"""ctypes binding for the native C++ transport (``native/transport.cpp``).

The port of ``rl_ode_physics_tpu/net/native_transport.py``: the same
event/host/peer API as ``net.transport`` and the identical wire format, so
the two interoperate (a Python ``Host`` talks to a native one). The library
is built at first use, never at import, from the unedited source into
``build/native/libtransport.so`` at the root of the checkout, with the flags
of ``native/Makefile``; nothing is written into ``native/``.
``NativeHost`` is a drop-in for latency-sensitive servers (no GIL-bound
packet pump).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

from rl_ode_physics_tpu_torch.net.transport import Event, EventType

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "transport.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libtransport.so"
_lib = None


def build() -> bool:
    """Compile ``LIB_PATH`` with g++ (``-O2 -fPIC -std=c++17 -shared``, as
    ``native/Makefile`` does) unless it is newer than its source. Returns
    success."""
    if (LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime):
        return True
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), "-O2", "-fPIC",
                        "-std=c++17", "-shared", "-o", str(tmp),
                        str(SOURCE)], check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)       # atomic: processes may build at once
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        raise OSError(f"could not build {LIB_PATH} from {SOURCE} with g++")
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.rt_host_create.restype = ctypes.c_void_p
    lib.rt_host_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rt_host_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_host_port.restype = ctypes.c_int
    lib.rt_host_port.argtypes = [ctypes.c_void_p]
    lib.rt_host_connect.restype = ctypes.c_int
    lib.rt_host_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.rt_peer_send.restype = ctypes.c_int
    lib.rt_peer_send.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.rt_host_broadcast.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.rt_peer_disconnect.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rt_host_service.restype = ctypes.c_int
    lib.rt_host_service.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rt_event_data.restype = ctypes.c_int
    lib.rt_event_data.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class NativePeer:
    def __init__(self, host: "NativeHost", peer_id: int):
        self.host = host
        self.peer_id = peer_id
        self.connected = False
        self.addr = ("native", peer_id)   # identity key, API parity

    def send(self, channel: int, data: bytes, reliable: bool = True):
        self.host._lib.rt_peer_send(
            self.host._h, self.peer_id, channel, data, len(data),
            1 if reliable else 0)

    def disconnect(self):
        self.host._lib.rt_peer_disconnect(self.host._h, self.peer_id)


class NativeHost:
    """API-compatible with ``net.transport.Host`` (service/broadcast/...)."""

    def __init__(self, port: Optional[int] = None, max_peers: int = 32,
                 bind_host: str = "0.0.0.0"):
        del bind_host  # native lib binds INADDR_ANY
        self._lib = _load()
        self._h = self._lib.rt_host_create(0 if port is None else port,
                                           max_peers)
        self.port = self._lib.rt_host_port(self._h)
        self.peers: Dict[int, NativePeer] = {}

    def connect(self, address: Tuple[str, int]) -> NativePeer:
        pid = self._lib.rt_host_connect(
            self._h, address[0].encode(), address[1])
        peer = self.peers.setdefault(pid, NativePeer(self, pid))
        return peer

    def broadcast(self, channel: int, data: bytes, reliable: bool = True):
        del reliable  # native broadcast is always reliable (like the server)
        self._lib.rt_host_broadcast(self._h, channel, data, len(data))

    def service(self, timeout: float = 0.0) -> Optional[Event]:
        pid = ctypes.c_int()
        ch = ctypes.c_int()
        dlen = ctypes.c_int()
        etype = self._lib.rt_host_service(
            self._h, int(timeout * 1000),
            ctypes.byref(pid), ctypes.byref(ch), ctypes.byref(dlen))
        if etype == 0:
            return None
        peer = self.peers.setdefault(pid.value, NativePeer(self, pid.value))
        data = b""
        if dlen.value > 0:
            buf = (ctypes.c_uint8 * dlen.value)()
            n = self._lib.rt_event_data(self._h, buf, dlen.value)
            data = bytes(buf[:n])
        if etype == 1:
            peer.connected = True
            return Event(EventType.CONNECT, peer)
        if etype == 2:
            return Event(EventType.RECEIVE, peer, ch.value, data)
        peer.connected = False
        return Event(EventType.DISCONNECT, peer)

    def flush(self):
        self.service(0.0)

    def close(self):
        if self._h:
            self._lib.rt_host_destroy(self._h)
            self._h = None


def make_host(port: Optional[int] = None, max_peers: int = 32,
              prefer_native: bool = True):
    """Best transport available: native C++ if it builds, else pure
    Python."""
    if prefer_native and available():
        return NativeHost(port=port, max_peers=max_peers)
    from rl_ode_physics_tpu_torch.net.transport import Host
    return Host(port=port, max_peers=max_peers)
