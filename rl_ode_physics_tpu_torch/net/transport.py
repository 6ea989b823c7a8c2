"""Reliable-UDP transport with ENet-equivalent semantics.

A copy of ``rl_ode_physics_tpu/net/transport.py`` (sockets and numpy only),
kept in the port so that it imports nothing of the JAX package.

Host-side replacement for the ENet surface the reference uses
(``enet_host_create/connect/service``, ``enet_peer_send``,
``enet_host_broadcast``, ``enet_peer_disconnect`` — call sites
``src/main.c:60-68,131,156-157,241-248,280-294``):

* host/peer model with connect & disconnect events,
* channels (the reference allocates 2, uses channel 0 — ``src/main.c:68,157``),
* reliable, *ordered* delivery per (peer, channel) via seq/ack + retransmit,
* fragmentation/reassembly — the 78 KB body snapshot exceeds the 64 KB UDP
  datagram limit, exactly why ENet fragments reliable packets,
* ``service(timeout)`` event polling shaped like ``enet_host_service``.

Pure Python over a nonblocking UDP socket; a C++ implementation with the
same wire format lives in ``native/transport.cpp`` and is preferred
automatically when built (see ``net/native_transport.py``).

This layer is host-only by design: the device's contract is deterministic
stepping + snapshot reads; transport never touches the device (SURVEY.md
§2b ENet row).
"""

from __future__ import annotations

import dataclasses
import enum
import select
import socket
import struct
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

MAGIC = 0x52545055  # 'RTPU'
HEADER = struct.Struct("<IBBHHI")  # magic, flags, channel, frag_idx, frag_cnt, seq
MAX_PAYLOAD = 1200                  # per-datagram fragment payload
RTO = 0.05                          # retransmit timeout (s)
MAX_RETRIES = 300                   # ~15 s before peer considered dead
                                    # (ENet defaults to a ~30 s window; a
                                    # client may stall in a jit compile)
PEER_TIMEOUT = 30.0                 # drop a peer with unacked traffic that
                                    # has been silent this long (ENet's
                                    # default ballpark). Must stay lenient:
                                    # a single-threaded endpoint stalled in
                                    # a jit compile stops pumping and its
                                    # peers go "silent" through no fault of
                                    # their own. The retransmit WINDOW, not
                                    # this timeout, is what bounds the
                                    # dead-peer flood.
RETRANSMIT_WINDOW = 64              # only the oldest N pending messages per
                                    # peer retransmit per pass (ENet-style
                                    # windowing; bounds flood bandwidth)
NUM_CHANNELS = 2                    # src/main.c:68


class Flags(enum.IntFlag):
    RELIABLE = 1
    ACK = 2
    CONNECT = 4
    CONNECT_ACK = 8
    DISCONNECT = 16


class EventType(enum.Enum):
    CONNECT = "connect"
    RECEIVE = "receive"
    DISCONNECT = "disconnect"


@dataclasses.dataclass
class Event:
    type: EventType
    peer: "Peer"
    channel: int = 0
    data: bytes = b""


@dataclasses.dataclass
class _Pending:
    seq: int
    packets: Dict[int, bytes]    # frag_idx → datagram, removed when acked
    sent_at: float
    retries: int = 0


class Peer:
    """Connection state for one remote endpoint."""

    def __init__(self, host: "Host", addr: Tuple[str, int]):
        self.host = host
        self.addr = addr
        self.connected = False
        self.next_out_seq = [0] * NUM_CHANNELS
        self.next_in_seq = [0] * NUM_CHANNELS
        self.pending: Dict[Tuple[int, int], _Pending] = {}  # (ch, seq) → unacked
        self.reorder: Dict[Tuple[int, int], List[Optional[bytes]]] = {}
        self.last_heard = time.monotonic()

    def send(self, channel: int, data: bytes, reliable: bool = True):
        """enet_peer_send equivalent (always reliable in the reference)."""
        seq = self.next_out_seq[channel]
        self.next_out_seq[channel] = (seq + 1) & 0xFFFFFFFF
        frags = [data[i:i + MAX_PAYLOAD]
                 for i in range(0, max(len(data), 1), MAX_PAYLOAD)]
        flags = Flags.RELIABLE if reliable else Flags(0)
        packets = {}
        for idx, frag in enumerate(frags):
            hdr = HEADER.pack(MAGIC, int(flags), channel, idx, len(frags), seq)
            packets[idx] = hdr + frag
        for p in packets.values():
            self.host._sendto(p, self.addr)
        if reliable:
            self.pending[(channel, seq)] = _Pending(
                seq=seq, packets=packets, sent_at=time.monotonic()
            )

    def disconnect(self):
        """enet_peer_disconnect equivalent (src/main.c:165)."""
        hdr = HEADER.pack(MAGIC, int(Flags.DISCONNECT), 0, 0, 1, 0)
        self.host._sendto(hdr, self.addr)
        self.host._drop_peer(self.addr, notify=False)


class Host:
    """enet_host equivalent: bind a socket, service events, manage peers."""

    def __init__(self, port: Optional[int] = None, max_peers: int = 32,
                 bind_host: str = "0.0.0.0"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # 60 Hz × 78 KB snapshots need real buffer depth on loopback
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 4 * 1024 * 1024)
            except OSError:
                pass
        if port is not None:
            self.sock.bind((bind_host, port))
        else:
            self.sock.bind((bind_host, 0))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.max_peers = max_peers
        self.peers: Dict[Tuple[str, int], Peer] = {}
        self.events: deque = deque()
        self._connecting: Dict[Tuple[str, int], float] = {}

    # --- public API -------------------------------------------------------

    def connect(self, address: Tuple[str, int]) -> Peer:
        """enet_host_connect equivalent: begin handshake, CONNECT event is
        delivered through service() once acknowledged."""
        peer = self.peers.get(address)
        if peer is None:
            peer = Peer(self, address)
            self.peers[address] = peer
        hdr = HEADER.pack(MAGIC, int(Flags.CONNECT), 0, 0, 1, 0)
        self._sendto(hdr, address)
        self._connecting[address] = time.monotonic()
        return peer

    def broadcast(self, channel: int, data: bytes, reliable: bool = True):
        """enet_host_broadcast equivalent (src/main.c:242,248)."""
        for peer in list(self.peers.values()):
            if peer.connected:
                peer.send(channel, data, reliable)

    def service(self, timeout: float = 0.0) -> Optional[Event]:
        """Pump the socket; return the next event or None.

        ``timeout`` in seconds (the reference passes milliseconds to
        enet_host_service; callers here use seconds).
        """
        deadline = time.monotonic() + timeout
        while True:
            self._pump()
            self._retransmit()
            if self.events:
                return self.events.popleft()
            now = time.monotonic()
            if now >= deadline:
                return None
            # block until readable (or a short cap so retransmits keep
            # ticking) — select, like native/transport.cpp; recv(0) returns
            # immediately on Linux and would busy-spin the whole timeout
            try:
                select.select([self.sock], [], [],
                              max(0.0, min(deadline - now, 0.01)))
            except OSError:
                pass

    def flush(self):
        self._pump()
        self._retransmit()

    def close(self):
        self.sock.close()

    # --- internals --------------------------------------------------------

    def _sendto(self, packet: bytes, addr):
        try:
            self.sock.sendto(packet, addr)
        except OSError:
            pass

    def _drop_peer(self, addr, notify: bool = True):
        peer = self.peers.pop(addr, None)
        if peer is not None and notify and peer.connected:
            self.events.append(Event(EventType.DISCONNECT, peer))

    def _retransmit(self):
        now = time.monotonic()
        # connect retries
        for addr, t0 in list(self._connecting.items()):
            if now - t0 > RTO:
                hdr = HEADER.pack(MAGIC, int(Flags.CONNECT), 0, 0, 1, 0)
                self._sendto(hdr, addr)
                self._connecting[addr] = now
        for peer in list(self.peers.values()):
            if (peer.pending
                    and now - peer.last_heard > PEER_TIMEOUT):
                self._drop_peer(peer.addr)      # silent peer with unacked data
                continue
            # windowed retransmit: oldest messages first, bounded per pass
            for key, pend in list(peer.pending.items())[:RETRANSMIT_WINDOW]:
                if now - pend.sent_at > RTO:
                    pend.retries += 1
                    if pend.retries > MAX_RETRIES:
                        self._drop_peer(peer.addr)
                        break
                    for p in pend.packets.values():   # only unacked fragments
                        self._sendto(p, peer.addr)
                    pend.sent_at = now

    def _pump(self):
        while True:
            try:
                data, addr = self.sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                return
            if len(data) < HEADER.size:
                continue
            magic, flags, channel, frag_idx, frag_cnt, seq = HEADER.unpack(
                data[:HEADER.size]
            )
            if magic != MAGIC:
                continue
            flags = Flags(flags)
            payload = data[HEADER.size:]
            self._handle(addr, flags, channel, frag_idx, frag_cnt, seq, payload)

    def _handle(self, addr, flags, channel, frag_idx, frag_cnt, seq, payload):
        now = time.monotonic()

        if Flags.CONNECT in flags:
            # server side of the handshake
            peer = self.peers.get(addr)
            if peer is None:
                if len(self.peers) >= self.max_peers:
                    # ENet parity: a host created with peerCount slots simply
                    # has no peer for the overflow connect — the datagram is
                    # ignored and the client times out (the application-level
                    # server-full path, src/main.c:164-167, fires when the
                    # transport accepted but the player table is full;
                    # GameServer allocates peer headroom for exactly that)
                    return
                peer = Peer(self, addr)
                self.peers[addr] = peer
            ack = HEADER.pack(MAGIC, int(Flags.CONNECT_ACK), 0, 0, 1, 0)
            self._sendto(ack, addr)
            if not peer.connected:
                peer.connected = True
                peer.last_heard = now
                self.events.append(Event(EventType.CONNECT, peer))
            return

        if Flags.CONNECT_ACK in flags:
            peer = self.peers.get(addr)
            if peer is not None and not peer.connected:
                peer.connected = True
                peer.last_heard = now
                self._connecting.pop(addr, None)
                self.events.append(Event(EventType.CONNECT, peer))
            return

        if Flags.DISCONNECT in flags:
            self._drop_peer(addr)
            return

        peer = self.peers.get(addr)
        if peer is None:
            return
        peer.last_heard = now

        if Flags.ACK in flags:
            # per-fragment ack: frag_idx identifies the acknowledged datagram
            pend = peer.pending.get((channel, seq))
            if pend is not None:
                pend.packets.pop(frag_idx, None)
                if not pend.packets:
                    peer.pending.pop((channel, seq), None)
            return

        if Flags.RELIABLE in flags:
            ack = HEADER.pack(MAGIC, int(Flags.ACK), channel, frag_idx, 1, seq)
            self._sendto(ack, addr)

        # drop stale/duplicate messages (already delivered)
        expected = peer.next_in_seq[channel]
        if _seq_lt(seq, expected):
            return

        # reassemble fragments
        key = (channel, seq)
        if frag_cnt > 1:
            buf = peer.reorder.get(key)
            if buf is None:
                buf = [None] * frag_cnt
                peer.reorder[key] = buf
            elif not isinstance(buf, list):
                # duplicate fragment of an already-assembled message still
                # waiting for in-order delivery (retransmit after a lost
                # ACK) — the entry holds the completed bytes; drop the dup
                # (mirrors the C++ transport's frag_done guard)
                return
            if frag_idx < len(buf):
                buf[frag_idx] = payload
            if any(b is None for b in buf):
                return
            payload = b"".join(buf)  # complete
        # deliver in order: stash, then flush the run of consecutive seqs
        peer.reorder[key] = payload
        while True:
            nxt = peer.next_in_seq[channel]
            item = peer.reorder.get((channel, nxt))
            if item is None or isinstance(item, list):
                break
            peer.reorder.pop((channel, nxt))
            peer.next_in_seq[channel] = (nxt + 1) & 0xFFFFFFFF
            self.events.append(
                Event(EventType.RECEIVE, peer, channel, item)
            )


def _seq_lt(a: int, b: int) -> bool:
    """Serial-number arithmetic a < b (mod 2^32)."""
    return ((a - b) & 0xFFFFFFFF) > 0x80000000
