"""Deterministic PRNG, bit-compatible with the reference game's generator.

The numpy path of ``rl_ode_physics_tpu/utils/prng.py``: a 32-bit state that
each draw advances by the Weyl constant ``0xE120FC15`` and mixes with two
multiply-xor-fold rounds. Scenes are built on the host from this stream, so
the port's scenes are bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np

WEYL = np.uint32(0xE120FC15)
MIX1 = np.uint32(0x4A39B70D)
MIX2 = np.uint32(0x12FAD5C9)


def _mulhilo32(a, b_const: int):
    """(high, low) 32-bit halves of the 64-bit product a * b_const, in
    16-bit limbs of uint32 arithmetic."""
    a = np.asarray(a).astype(np.uint32)
    b = np.uint32(b_const)
    al = a & np.uint32(0xFFFF)
    ah = a >> np.uint32(16)
    bl = b & np.uint32(0xFFFF)
    bh = b >> np.uint32(16)
    ll = al * bl
    u = al * bh + (ll >> np.uint32(16))
    v = ah * bl + (u & np.uint32(0xFFFF))
    hi = ah * bh + (u >> np.uint32(16)) + (v >> np.uint32(16))
    lo = (v << np.uint32(16)) | (ll & np.uint32(0xFFFF))
    return hi, lo


def _mix(state):
    """The two multiply-xor-fold rounds of ``Rand_Next``."""
    hi, lo = _mulhilo32(state, MIX1)
    m1 = hi ^ lo
    hi, lo = _mulhilo32(m1, MIX2)
    return hi ^ lo


def raw(seed, counter):
    """Counter-based draw: the value of the (counter+1)-th ``Rand_Next``
    call from state ``seed``; ``counter`` may be any-shaped."""
    seed = np.asarray(seed, dtype=np.uint32)
    counter = np.asarray(counter, dtype=np.uint32)
    return _mix(seed + (counter + np.uint32(1)) * WEYL)


def next_u32(state):
    """Sequential draw: (value, new_state)."""
    state = np.asarray(state, dtype=np.uint32)
    new_state = state + WEYL
    return _mix(new_state), new_state


def rand_int(value_u32, lo: int, hi: int):
    """Map a raw draw to [lo, hi) like ``Rand_Int``, modulo bias included;
    ``lo >= hi`` returns 0."""
    if lo >= hi:
        return np.zeros_like(value_u32, dtype=np.int32)
    span = np.uint32(hi - lo)
    return (value_u32 % span).astype(np.int32) + np.int32(lo)


def rand_double(value_u32, lo: float, hi: float):
    """Map a raw draw to [lo, hi] like ``Rand_Double`` (f64, divided by
    0xFFFFFFFF)."""
    v = np.asarray(value_u32).astype(np.float64) / np.float64(0xFFFFFFFF)
    return lo + v * (float(hi) - float(lo))


def rand_color(state):
    """Three sequential raw draws, as ``Rand_Color`` burns three
    ``Rand_Next`` calls: ((v0, v1, v2), new_state). The caller maps each
    with ``rand_int`` to its bounds."""
    v0, state = next_u32(state)
    v1, state = next_u32(state)
    v2, state = next_u32(state)
    return (v0, v1, v2), state


class RandStream:
    """Host-side stream with the reference's draw-by-draw semantics."""

    def __init__(self, seed: int):
        self.state = np.uint32(seed)

    def next(self) -> int:
        v, self.state = next_u32(self.state)
        return int(v)

    def randint(self, lo: int, hi: int) -> int:
        if lo >= hi:
            return 0
        return int(rand_int(np.uint32(self.next()), lo, hi))

    def double(self, lo: float, hi: float) -> float:
        return float(rand_double(np.uint32(self.next()), lo, hi))

    def color(self, lo: int = 30, hi: int = 190):
        """(r, g, b, 255) — ``Rand_Color``."""
        return (
            self.randint(lo, hi),
            self.randint(lo, hi),
            self.randint(lo, hi),
            255,
        )
