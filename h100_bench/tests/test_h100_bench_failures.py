"""The failure count: world-calls that dropped a contact row or left a
non-finite state, counted on the device."""

from __future__ import annotations

import torch

from benchlib import window


class _Batch:
    def __init__(self, worlds: int = 6, slots: int = 3):
        self.pos = torch.zeros(worlds, slots, 3)
        self.quat = torch.zeros(worlds, slots, 4)
        self.linvel = torch.zeros(worlds, slots, 3)
        self.angvel = torch.zeros(worlds, slots, 3)
        self.overflow = torch.zeros(worlds, dtype=torch.int32)
        self.device = self.pos.device


def test_overflow_rise_counts_once_per_world_call():
    b = _Batch()
    fail = window.Failures(b)
    b.overflow[2] += 5                 # five rows dropped in one call
    fail.update(b)
    assert int(fail.count) == 1
    fail.update(b)                     # no rise in the next call
    assert int(fail.count) == 1
    b.overflow[[0, 2]] += 1
    fail.update(b)
    assert int(fail.count) == 3


def test_non_finite_state_counts():
    b = _Batch()
    fail = window.Failures(b)
    b.linvel[4, 1, 0] = float("nan")
    b.pos[1, 0, 2] = float("inf")
    fail.update(b)
    assert int(fail.count) == 2


def test_a_clean_call_counts_nothing():
    b = _Batch()
    fail = window.Failures(b)
    for _ in range(3):
        b.pos += 1.0
        fail.update(b)
    assert int(fail.count) == 0


def test_resets_follow_the_staggered_schedule():
    """World i restarts before every call c with (2c - 2i) mod 288 == 0,
    from the pool world the schedule names, and no other world moves."""
    import json

    import numpy as np

    from benchlib import manifest, traffic as traffic_m
    with open(manifest.BENCH_DIR / "configs" / "arena64-hb8.json") as f:
        cfg = json.load(f)
    traffic = dict(manifest.traffic_of({"traffic": "settled-8192"}),
                   worlds=300, pool_worlds=8)
    pool = traffic_m.pool(cfg, traffic, 123456789012)
    batch = traffic_m.initial_batch(pool, traffic, "cpu")
    resets = traffic_m.Resets(pool, traffic, "cpu")
    for call in (0, 1, 143, 144, 290):
        batch.pos.fill_(7.0)
        worlds, src = resets.due(call)
        assert set(worlds) == {i for i in range(300)
                               if (2 * call - 2 * i) % 288 == 0}
        resets.apply(batch, call)
        moved = np.flatnonzero((batch.pos != 7.0).any(-1).any(-1).numpy())
        assert set(moved) == set(worlds)
        assert torch.equal(batch.pos[worlds], pool.pos[src])


def test_a_pool_that_differs_beyond_the_pose_takes_no_resets():
    """A rain pool's worlds differ in their bodies' types and sizes, which
    a reset does not write: asking it for resets is refused."""
    import json

    import pytest

    from benchlib import manifest, traffic as traffic_m
    with open(manifest.BENCH_DIR / "configs" / "quickstep-f64.json") as f:
        cfg = json.load(f)
    traffic = dict(manifest.traffic_of({"traffic": "stack-1024"}),
                   worlds=4, pool_worlds=4, episode_substeps=8)
    pool = traffic_m.pool(cfg, traffic, 3)
    with pytest.raises(ValueError):
        traffic_m.Resets(pool, traffic, "cpu")
