"""Wire protocol: explicit little-endian layout for the 5 reference messages.

A copy of ``rl_ode_physics_tpu/net/protocol.py`` (numpy only): the port
keeps its own so that it imports nothing of the JAX package. The wire bytes
are the same, so a client of either package talks to a server of the other.

The reference sends raw C structs over ENet (``inc/msgs.h:1-38``,
``*(MsgType*)packet->data`` dispatch at ``src/main.c:171,420``) — an
architecture-dependent format (SURVEY.md §2e). This module pins an explicit
layout: little-endian, the x86-64 alignment the reference de-facto uses
(``dReal`` = f64, 8-byte alignment inside BodyState; 4-byte elsewhere), so
the snapshot packet is the same ~78 KB the reference broadcasts
(512 × 152 B + 8 B header, ``src/main.c:239-242``).

Message set (``inc/msgs.h:6-13``):
    C_PLAYER_ID(0)     server→client   assigned slot        (src/main.c:155-157)
    C_UPDATE_PLAYERS(1) server→client  full player array    (src/main.c:245-248)
    S_PLAYER_UPDATE(2) client→server   one player state     (src/main.c:481-483)
    C_UPDATE_BODIES(3) server→client   full body snapshot   (src/main.c:239-242)
    S_NEW_BODY(4)      client→server   spawn request        (src/main.c:772-776)

Capacities are parameters (defaults = the reference's MAX_PLAYERS=32 /
MAX_BODIES=512) because our worlds are shape-configurable.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

import numpy as np

MAX_PLAYERS = 32   # inc/player.h:8
MAX_BODIES = 512   # inc/body.h:6


class MsgType(enum.IntEnum):
    C_PLAYER_ID = 0
    C_UPDATE_PLAYERS = 1
    S_PLAYER_UPDATE = 2
    C_UPDATE_BODIES = 3
    S_NEW_BODY = 4
    # framework extension (not in inc/msgs.h): spawn with initial velocity —
    # completes the reference's TODO "allow clients to create bodies with
    # initial forces" (src/main.c:531-532)
    X_NEW_BODY_VEL = 5


# --- struct layouts (numpy structured dtypes, explicit offsets) -----------

PLAYER_STATE_DTYPE = np.dtype({
    "names": ["pos", "dir", "id"],
    "formats": [("<f4", (3,)), ("<f4", (3,)), "<i4"],
    "offsets": [0, 12, 24],
    "itemsize": 28,
})  # struct playerState (inc/player.h:10-13)

BODY_STATE_DTYPE = np.dtype({
    "names": ["type", "transform", "size", "col"],
    "formats": ["<i4", ("<f8", (16,)), ("<f4", (3,)), ("u1", (4,))],
    "offsets": [0, 8, 136, 148],       # dReal f64 ⇒ 8-byte alignment pad
    "itemsize": 152,
})  # struct bodyState (inc/body.h:26-31)


def msg_player_id_dtype():
    return np.dtype({
        "names": ["msg", "playerID"],
        "formats": ["<u4", "<i4"],
        "offsets": [0, 4],
        "itemsize": 8,
    })


def msg_player_update_dtype():
    return np.dtype({
        "names": ["msg", "player"],
        "formats": ["<u4", PLAYER_STATE_DTYPE],
        "offsets": [0, 4],
        "itemsize": 32,
    })


@functools.lru_cache(maxsize=None)
def msg_update_players_dtype(max_players: int = MAX_PLAYERS):
    return np.dtype({
        "names": ["msg", "players"],
        "formats": ["<u4", (PLAYER_STATE_DTYPE, (max_players,))],
        "offsets": [0, 4],
        "itemsize": 4 + 28 * max_players,
    })


@functools.lru_cache(maxsize=None)
def msg_update_bodies_dtype(max_bodies: int = MAX_BODIES):
    return np.dtype({
        "names": ["msg", "bodies"],
        "formats": ["<u4", (BODY_STATE_DTYPE, (max_bodies,))],
        "offsets": [0, 8],             # 8-byte alignment of BodyState
        "itemsize": 8 + 152 * max_bodies,
    })


def msg_new_body_dtype():
    return np.dtype({
        "names": ["msg", "body"],
        "formats": ["<u4", BODY_STATE_DTYPE],
        "offsets": [0, 8],
        "itemsize": 160,
    })


# --- encode/decode ---------------------------------------------------------

def peek_type(data: bytes) -> MsgType:
    """Dispatch on the leading MsgType field (src/main.c:171,420)."""
    return MsgType(int(np.frombuffer(data[:4], "<u4")[0]))


def encode_player_id(player_id: int) -> bytes:
    rec = np.zeros((), msg_player_id_dtype())
    rec["msg"] = MsgType.C_PLAYER_ID
    rec["playerID"] = player_id
    return rec.tobytes()


def decode_player_id(data: bytes) -> int:
    rec = np.frombuffer(data, msg_player_id_dtype(), count=1)[0]
    return int(rec["playerID"])


def encode_player_update(pos, direction, player_id: int) -> bytes:
    rec = np.zeros((), msg_player_update_dtype())
    rec["msg"] = MsgType.S_PLAYER_UPDATE
    rec["player"]["pos"] = pos
    rec["player"]["dir"] = direction
    rec["player"]["id"] = player_id
    return rec.tobytes()


def decode_player_update(data: bytes):
    rec = np.frombuffer(data, msg_player_update_dtype(), count=1)[0]
    p = rec["player"]
    return dict(pos=np.array(p["pos"]), dir=np.array(p["dir"]),
                id=int(p["id"]))


def encode_update_players(players: np.ndarray) -> bytes:
    """players: structured array of PLAYER_STATE_DTYPE, shape (max_players,)."""
    dt = msg_update_players_dtype(players.shape[0])
    rec = np.zeros((), dt)
    rec["msg"] = MsgType.C_UPDATE_PLAYERS
    rec["players"] = players
    return rec.tobytes()


def decode_update_players(data: bytes, max_players: Optional[int] = None):
    """max_players=None infers the roster size from the buffer length —
    robust to peers compiled with a different MAX_PLAYERS."""
    if max_players is None:
        max_players = (len(data) - 4) // PLAYER_STATE_DTYPE.itemsize
    dt = msg_update_players_dtype(max_players)
    rec = np.frombuffer(data[:dt.itemsize], dt, count=1)[0]
    return np.array(rec["players"])


def encode_update_bodies(bodies: np.ndarray) -> bytes:
    """bodies: structured array of BODY_STATE_DTYPE, shape (max_bodies,)."""
    dt = msg_update_bodies_dtype(bodies.shape[0])
    rec = np.zeros((), dt)
    rec["msg"] = MsgType.C_UPDATE_BODIES
    rec["bodies"] = bodies
    return rec.tobytes()


def decode_update_bodies(data: bytes, max_bodies: Optional[int] = None):
    """max_bodies=None infers the body count from the buffer length."""
    if max_bodies is None:
        max_bodies = (len(data) - 8) // BODY_STATE_DTYPE.itemsize
    dt = msg_update_bodies_dtype(max_bodies)
    rec = np.frombuffer(data[:dt.itemsize], dt, count=1)[0]
    return np.array(rec["bodies"])


def encode_new_body(body_type: int, transform16, size, color) -> bytes:
    rec = np.zeros((), msg_new_body_dtype())
    rec["msg"] = MsgType.S_NEW_BODY
    rec["body"]["type"] = body_type
    rec["body"]["transform"] = np.asarray(transform16, np.float64)
    rec["body"]["size"] = np.asarray(size, np.float32)
    rec["body"]["col"] = np.asarray(color, np.uint8)
    return rec.tobytes()


def msg_new_body_vel_dtype():
    """Extension: MsgNewBody + linear & angular velocity (wire-stable)."""
    return np.dtype({
        "names": ["msg", "body", "linvel", "angvel"],
        "formats": ["<u4", BODY_STATE_DTYPE, ("<f4", (3,)), ("<f4", (3,))],
        "offsets": [0, 8, 160, 172],
        "itemsize": 184,
    })


def encode_new_body_vel(body_type: int, transform16, size, color,
                        linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0)) -> bytes:
    rec = np.zeros((), msg_new_body_vel_dtype())
    rec["msg"] = MsgType.X_NEW_BODY_VEL
    rec["body"]["type"] = body_type
    rec["body"]["transform"] = np.asarray(transform16, np.float64)
    rec["body"]["size"] = np.asarray(size, np.float32)
    rec["body"]["col"] = np.asarray(color, np.uint8)
    rec["linvel"] = np.asarray(linvel, np.float32)
    rec["angvel"] = np.asarray(angvel, np.float32)
    return rec.tobytes()


def decode_new_body_vel(data: bytes):
    rec = np.frombuffer(data, msg_new_body_vel_dtype(), count=1)[0]
    b = rec["body"]
    return dict(
        type=int(b["type"]),
        transform=np.array(b["transform"]),
        size=np.array(b["size"]),
        color=np.array(b["col"]),
        linvel=np.array(rec["linvel"]),
        angvel=np.array(rec["angvel"]),
    )


def decode_new_body(data: bytes):
    rec = np.frombuffer(data, msg_new_body_dtype(), count=1)[0]
    b = rec["body"]
    return dict(
        type=int(b["type"]),
        transform=np.array(b["transform"]),
        size=np.array(b["size"]),
        color=np.array(b["col"]),
    )


def empty_players(max_players: int = MAX_PLAYERS) -> np.ndarray:
    """Fresh player table: all ids -1 (src/main.c:330-333)."""
    players = np.zeros((max_players,), PLAYER_STATE_DTYPE)
    players["id"] = -1
    return players
