"""The port's ``SimCore``, lockstep replay, diagnostics and checkpoints
against the JAX package's, on the CPU.

The same intent stream (two capsule players, one walking; spheres and
boxes spawned from wire transforms, one of them rotated) goes through the
JAX ``SimCore`` and the port's for 60 ticks under the CLI's classic policy
and the throughput policy, at 16 slots: ``body_states`` types, sizes and
colours exact, transforms within 1e-4. Intent logs and checkpoints are read
across the packages.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_port import single_cpu_thread  # noqa: F401  (autouse)
from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jscenes
from rl_ode_physics_tpu.net import replay as jreplay
from rl_ode_physics_tpu.net.server import SimCore as JaxSim
from rl_ode_physics_tpu.utils import checkpoint as jckpt
from rl_ode_physics_tpu.utils import transforms as jtf
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.models import scenes as tscenes
from rl_ode_physics_tpu_torch.net import replay as treplay
from rl_ode_physics_tpu_torch.net.server import SimCore as TorchSim
from rl_ode_physics_tpu_torch.utils import bridge
from rl_ode_physics_tpu_torch.utils import checkpoint as tckpt

CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=64)
# the throughput policy without the plane buckets: the arena has no plane
# (6 buckets instead of 9, a shorter JAX compile)
THROUGHPUT = dict(CAPS, enable_planes=False)
POLICIES = {
    "cli": (JaxConfig(**CAPS), TorchConfig(**CAPS)),
    "throughput": (JaxConfig.throughput(**THROUGHPUT),
                   TorchConfig.throughput(**THROUGHPUT)),
}
TICKS = 60


def _transforms():
    """Row-major wire transforms of 6 spawns: at rest, from 1-3.5 m up,
    one of them rotated (the spawn path's ``from_matrix``)."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(6):
        pos = np.array([rng.uniform(-2, 2), 1.0 + 0.5 * k, rng.uniform(-1, 1)])
        euler = np.array([0.0, 0.7, 0.0]) if k == 3 else np.zeros(3)
        out.append(np.asarray(jtf.mat16_rowmajor_from_pos_euler(
            pos, euler), np.float64))
    return out


def _drive(sim, ticks=TICKS):
    """Players 0 and 1 join, player 0 walks 30 ticks; a sphere or a box
    spawns every 8 ticks; one spawn carries a velocity."""
    for pid in (0, 1):
        sim.player_join(pid)
    spawns = _transforms()
    while sim.tick < ticks:
        t = sim.tick
        if t % 8 == 0 and t // 8 < len(spawns):
            k = t // 8
            sim.spawn_body(1 + k % 2, spawns[k], (0.3, 0.35, 0.4),
                           (k, 2 * k, 3 * k, 255),
                           linvel=(1.0, 0.0, 0.0) if k == 2 else (0, 0, 0))
        if t < 30:
            sim.player_move(0, (0.02 * t, 2.0, -3.0 + 0.05 * t))
        sim.advance(1)
    return sim


def _same_snapshots(jax_sim, torch_sim, atol=1e-4):
    want, got = jax_sim.body_states(), torch_sim.body_states()
    for name in ("type", "size", "col"):
        assert np.array_equal(got[name], want[name]), name
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=0,
                               atol=atol)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_simcore_matches_jax_over_60_ticks(policy):
    jcfg, tcfg = POLICIES[policy]
    jsim = _drive(JaxSim(jcfg, seed=3, player_capsules=True))
    tsim = _drive(TorchSim(tcfg, seed=3, player_capsules=True,
                           device="cpu"))
    assert tsim.player_slots == jsim.player_slots
    assert tsim.check_overflow() == 0
    assert int(tsim.world.active.sum()) == 4 + 2 + 6
    _same_snapshots(jsim, tsim)


def test_port_replays_a_jax_intent_log(tmp_path):
    """A log saved by the JAX package, replayed twice by the port: equal
    digests, and the JAX live run's snapshot within 1e-4."""
    jcfg, tcfg = POLICIES["cli"]
    jsim = _drive(JaxSim(jcfg, seed=5, player_capsules=True))
    path = str(tmp_path / "jax_intents.jsonl")
    jreplay.save_log(jsim.intent_log, path)
    log = treplay.load_log(path)
    assert [(i.tick, i.kind) for i in log] == [
        (i.tick, i.kind) for i in jsim.intent_log]
    first = treplay.replay(log, TICKS, tcfg, seed=5, player_capsules=True,
                           device="cpu")
    second = treplay.replay(log, TICKS, tcfg, seed=5, player_capsules=True,
                            device="cpu")
    assert first.state_digest() == second.state_digest()
    _same_snapshots(jsim, first)


def test_jax_replays_a_port_intent_log(tmp_path):
    jcfg, tcfg = POLICIES["cli"]
    tsim = _drive(TorchSim(tcfg, seed=5, player_capsules=True,
                           device="cpu"))
    live = tsim.state_digest()
    path = str(tmp_path / "port_intents.jsonl")
    treplay.save_log(tsim.intent_log, path)
    again = treplay.replay(treplay.load_log(path), TICKS, tcfg, seed=5,
                           player_capsules=True, device="cpu")
    assert again.state_digest() == live
    jsim = jreplay.replay(jreplay.load_log(path), TICKS, jcfg, seed=5,
                          player_capsules=True)
    _same_snapshots(jsim, tsim)


def test_diagnostics_rows_match_jax():
    """``diagnostics=True``: each tick's row (world 0) against the JAX row,
    counts exact and floats within 1e-5; the trajectory is the plain
    one's, digest for digest."""
    jcfg, tcfg = POLICIES["cli"]
    jsim = _drive(JaxSim(jcfg, seed=2, player_capsules=True,
                         diagnostics=True), 40)
    tsim = _drive(TorchSim(tcfg, seed=2, player_capsules=True,
                           diagnostics=True, device="cpu"), 40)
    assert len(tsim.metrics.rows) == len(jsim.metrics.rows) == 40
    counts = ("num_pairs", "num_contacts", "pair_overflow",
              "contact_overflow", "num_bodies")
    for want, got in zip(jsim.metrics.rows, tsim.metrics.rows):
        assert got.keys() == want.keys()
        for k in want:
            if k == "tick" or k in counts:
                assert got[k] == want[k], k
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    assert tsim.metrics.last()["num_contacts"] >= 1
    assert tsim.metrics.summary().keys() == jsim.metrics.summary().keys()
    plain = _drive(TorchSim(tcfg, seed=2, player_capsules=True,
                            device="cpu"), 40)
    assert plain.state_digest() == tsim.state_digest()


def test_player_capsule_pushes_and_replays_bitwise():
    _, tcfg = POLICIES["cli"]
    sim = TorchSim(tcfg, seed=9, player_capsules=True, device="cpu")
    slot = sim.player_join(3)
    assert slot == 4
    t16 = np.eye(4).flatten(order="F")
    t16[12:15] = [0.0, 1.2, -1.0]
    sphere = sim.spawn_body(1, t16, (0.3, 0, 0), (1, 1, 1, 255))
    sim.advance(60)
    z0 = float(sim.world.pos[0, sphere, 2])
    for i in range(30):
        sim.player_move(3, (0.0, 1.0, -2.9 + i * 0.1))
        sim.advance(2)
    assert float(sim.world.pos[0, sphere, 2]) > z0 + 0.1
    sim.player_leave(3)
    sim.advance(10)
    assert not bool(sim.world.active[0, slot])
    again = treplay.replay(sim.intent_log, sim.tick, tcfg, seed=9,
                           player_capsules=True, device="cpu")
    assert again.state_digest() == sim.state_digest()


def test_spawn_with_velocity_flies_ballistically():
    _, tcfg = POLICIES["cli"]
    sim = TorchSim(tcfg, seed=1, device="cpu")
    t16 = np.eye(4).flatten(order="F")
    t16[12:15] = [0.0, 2.0, 0.0]
    slot = sim.spawn_body(1, t16, (0.15, 0, 0), (1, 1, 1, 255),
                          linvel=(5.0, 2.0, 0.0))
    sim.advance(12)          # 0.1 s
    assert 0.3 < float(sim.world.pos[0, slot, 0]) < 0.6


def test_overflow_warns_when_rows_are_dropped():
    cfg = TorchConfig(max_bodies=16, max_pair_candidates=4, max_contacts=8)
    sim = TorchSim(cfg, seed=0, device="cpu")
    t16 = np.eye(4).flatten(order="F")
    for k in range(8):
        t16[12:15] = [0.3 * k, 0.8, 0.0]
        sim.spawn_body(2, t16, (0.5, 0.5, 0.5), (1, 1, 1, 255))
    with pytest.warns(RuntimeWarning, match="capacity overflow"):
        sim.advance(120)
    assert sim.check_overflow() == int(sim.world.overflow[0]) > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim.check_overflow()           # no growth, no second warning


def _jax_steps(cfg, w, n=10):
    """``n`` substeps through SimCore's compiled one-substep step."""
    step = jax_make_step_fn(cfg, substeps=1, donate=False)
    for _ in range(n):
        w = step(w)
    return w


def test_jax_checkpoint_loads_into_the_port_and_steps_equally(tmp_path):
    jcfg, tcfg = POLICIES["cli"]
    w = _jax_steps(jcfg, jscenes.stack_world(jcfg, num_bodies=3, seed=5))
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, w, jcfg)
    state, cfg = tckpt.load(path, device="cpu")
    assert cfg == tcfg and state.num_worlds == 1
    got = bridge.world_to_numpy(state, 0)
    for f in dataclasses.fields(w):
        assert np.array_equal(got[f.name], np.asarray(getattr(w, f.name)))
    w2 = _jax_steps(jcfg, w)
    state2 = make_step_fn(tcfg, substeps=10)(state)
    np.testing.assert_allclose(state2.pos[0].numpy(), np.asarray(w2.pos),
                               rtol=0, atol=1e-5)
    assert int(state2.tick[0]) == int(w2.tick) == 20


def test_port_checkpoint_loads_into_jax_and_steps_equally(tmp_path):
    jcfg, tcfg = POLICIES["cli"]
    state = make_step_fn(tcfg, substeps=10)(
        tscenes.stack_world(tcfg, num_bodies=3, seed=5, device="cpu"))
    path = str(tmp_path / "port.npz")
    tckpt.save(path, state, tcfg)
    w, cfg = jckpt.load(path)
    assert cfg == jcfg
    want = bridge.world_to_numpy(state, 0)
    for f in dataclasses.fields(w):
        a = np.asarray(getattr(w, f.name))
        assert a.dtype == want[f.name].dtype and np.array_equal(
            a, want[f.name]), f.name
    w2 = _jax_steps(jcfg, w)
    state2 = make_step_fn(tcfg, substeps=10)(state)
    np.testing.assert_allclose(state2.pos[0].numpy(), np.asarray(w2.pos),
                               rtol=0, atol=1e-5)


def test_port_checkpoint_round_trip_resumes_bitwise(tmp_path):
    _, tcfg = POLICIES["throughput"]
    step = make_step_fn(tcfg, substeps=5)
    batch = bridge.world_from_numpy(
        {k: np.stack([v, v, v]) for k, v in bridge.world_to_numpy(
            tscenes.stack_world(tcfg, num_bodies=3, seed=6, device="cpu"),
            0).items()}, device="cpu")
    batch = step(batch)
    path = str(tmp_path / "batch.npz")
    tckpt.save(path, batch, tcfg)
    restored, cfg = tckpt.load(path, device="cpu")
    assert cfg == tcfg and restored.num_worlds == 3
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(restored, f.name), getattr(batch, f.name))
    a, b = step(batch), step(restored)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.quat, b.quat)
