"""The port's ``PhysicsEnv`` against the JAX package's, on the CPU.

Both sides run the small throughput configuration of ``_torch_port`` (16
slots, 12 bodies, bucket caps (32, 32, 16), 32 contacts) on the same
world, with the same actions from numpy with a seed. The compared steps
start from the JAX scene settled 30 substeps, where the first impacts
happen, so the actions meet contacts. Tolerances: ``reset``'s
observations exact (the scene is drawn by the same host code); state,
observations and lidar at atol 1e-4 after up to 20 substeps (as
``test_torch_step.py`` holds the bare step), tick, overflow and rng_state
exact. What the port promises of itself is held exactly: ``rollout``
equals repeated ``step``, chunked equals unchunked, ``obs_slots`` picks
rows, duplicate actor slots sum, no actors is the bare step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.models.env import PhysicsEnv as JaxEnv
from rl_ode_physics_tpu.parallel.batch import replicate as jax_replicate
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.models.env import PhysicsEnv, observe
from rl_ode_physics_tpu_torch.models.scenes import bench_world
from rl_ode_physics_tpu_torch.parallel.batch import (
    make_batched_step_fn, replicate)
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import SMALL_BODIES, configs, settled_state, to_numpy

ATOL = 1e-4
WORLDS = 3
ACTORS = [4, 5]                     # the first box and the first sphere
RAYS = 8
STATE_FIELDS = ("pos", "quat", "linvel", "angvel")
EXACT_FIELDS = ("tick", "overflow", "rng_state")


def _lidar_dirs():
    ang = np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    # alternately below and above the horizon: floor and walls, or nothing
    tilt = np.where(np.arange(RAYS) % 2, 0.3, -0.3)
    return np.stack([np.cos(ang), tilt, np.sin(ang)], -1).astype(np.float32)


def _scene(cfg, seed):
    return bench_world(cfg, num_bodies=SMALL_BODIES, seed=seed, device="cpu")


def _jax_scene(cfg, seed):
    return jax_scenes.bench_world(cfg, num_bodies=SMALL_BODIES, seed=seed)


def _env(**kw):
    _, tcfg = configs()
    kw = dict(dict(actor_slots=ACTORS, num_worlds=WORLDS, substeps=2,
                   device="cpu"), **kw)
    return PhysicsEnv(tcfg, _scene, **kw)


def _settled(num_worlds=WORLDS):
    """(JAX batch, port batch): the scene after 30 JAX substeps, in
    ``num_worlds`` worlds."""
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in
                              settled_state(30).items()})
    jbatch = jax_replicate(jstate, num_worlds)
    return jbatch, bridge.world_from_numpy(to_numpy(jbatch), device="cpu")


def _actions(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _hold_state(tstate, jstate):
    ref, got = to_numpy(jstate), bridge.world_to_numpy(tstate)
    for name in STATE_FIELDS:
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in EXACT_FIELDS:
        assert np.array_equal(got[name], ref[name]), name


@pytest.fixture(scope="module")
def jax_lidar_env():
    """The JAX env with actors and a lidar: compiled once for the file."""
    jcfg, _ = configs()
    return JaxEnv(jcfg, _jax_scene, actor_slots=ACTORS, num_worlds=WORLDS,
                  substeps=2, lidar_dirs=_lidar_dirs(), lidar_range=20.0)


def test_reset_matches_jax(jax_lidar_env):
    env = _env(lidar_dirs=_lidar_dirs(), lidar_range=20.0)
    jstate, jobs = jax_lidar_env.reset(seed=7)
    tstate, tobs = env.reset(seed=7)
    assert tobs.shape == (WORLDS, 16, 13)
    assert np.array_equal(tobs.numpy(), np.asarray(jobs))
    ref, got = to_numpy(jstate), bridge.world_to_numpy(tstate)
    for name in ref:
        assert np.array_equal(got[name], ref[name]), name
    assert env.num_actors == jax_lidar_env.num_actors == 2
    assert env.num_obs_slots == jax_lidar_env.num_obs_slots == 16


def test_steps_match_jax_with_lidar(jax_lidar_env):
    """5 control steps of 2 substeps under non-zero actions."""
    env = _env(lidar_dirs=_lidar_dirs(), lidar_range=20.0)
    jstate, tstate = _settled()
    acts = _actions((5, WORLDS, 2, 6), seed=1)
    for t in range(5):
        jstate, (jobs, jlid) = jax_lidar_env.step(jstate, jnp.asarray(acts[t]))
        tstate, (tobs, tlid) = env.step(tstate, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tlid.numpy(), np.asarray(jlid), atol=ATOL,
                                   rtol=0)
    _hold_state(tstate, jstate)
    assert tlid.shape == (WORLDS, 2, RAYS)
    assert (tstate.tick == 40).all()
    lid = tlid.numpy()
    assert (lid < 1.0).any() and (lid == 1.0).any()     # hits and misses
    # the actions moved the actors: the worlds differ
    assert float((tstate.pos[0, ACTORS] - tstate.pos[1, ACTORS]).abs().max()
                 ) > 1e-4


def test_rollout_matches_jax_with_lidar(jax_lidar_env):
    """A 10-step rollout (20 substeps, through the first impacts)."""
    env = _env(lidar_dirs=_lidar_dirs(), lidar_range=20.0)
    jstate, tstate = _settled()
    acts = _actions((10, WORLDS, 2, 6), seed=2)
    jfinal, (jtraj, jlid) = jax_lidar_env.rollout(jstate, jnp.asarray(acts))
    tfinal, (ttraj, tlid) = env.rollout(tstate, torch.from_numpy(acts))
    assert ttraj.shape == (10, WORLDS, 16, 13)
    assert tlid.shape == (10, WORLDS, 2, RAYS)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tlid.numpy(), np.asarray(jlid), atol=ATOL,
                               rtol=0)
    _hold_state(tfinal, jfinal)
    assert (tfinal.tick == 50).all()


# ---------------------------------------------------------------------------
# tests/test_env.py and tests/test_raycast.py:124-130, case for case
# ---------------------------------------------------------------------------

def test_reset_step_shapes():
    env = _env(actor_slots=[4], num_worlds=4)
    state, obs = env.reset()
    assert obs.shape == (4, 16, 13)
    state, obs = env.step(state, torch.zeros((4, 1, 6)))
    assert obs.shape == (4, 16, 13)
    assert int(state.tick[0]) == 2


def test_action_force_lifts_body():
    """An upward force above gravity's accelerates the actor upward; with
    no action it falls."""
    env = _env(actor_slots=[5], num_worlds=2)
    state, _ = env.reset()
    weight = 9.8 / float(state.inv_mass[0, 5])
    start_y = float(state.pos[0, 5, 1])
    up = torch.zeros((2, 1, 6))
    up[:, 0, 1] = 3.0 * weight
    for _ in range(5):
        state, _ = env.step(state, up)
    assert float(state.linvel[0, 5, 1]) > 0.0
    assert float(state.pos[0, 5, 1]) > start_y
    state2, _ = env.reset()
    for _ in range(5):
        state2, _ = env.step(state2, torch.zeros((2, 1, 6)))
    assert float(state2.linvel[0, 5, 1]) < 0.0


def test_rollout_equals_repeated_step():
    env = _env(lidar_dirs=_lidar_dirs(), lidar_range=20.0)
    _, start = _settled()
    acts = torch.from_numpy(_actions((6, WORLDS, 2, 6), seed=3))
    final, (traj, lidar) = env.rollout(start, acts)
    state = start
    for t in range(6):
        state, (obs, lid) = env.step(state, acts[t])
        assert torch.equal(traj[t], obs)
        assert torch.equal(lidar[t], lid)
    assert torch.equal(observe(state), observe(final))
    assert int(final.tick[0]) == 30 + 12


def test_chunked_env_matches_unchunked():
    env_u = _env(num_worlds=4)
    env_c = _env(num_worlds=4, chunk=2)
    _, s_u = _settled(4)
    s_c = s_u
    acts = torch.from_numpy(_actions((5, 4, 2, 6), seed=4, scale=0.3))
    for t in range(5):
        s_u, o_u = env_u.step(s_u, acts[t])
        s_c, o_c = env_c.step(s_c, acts[t])
    for name in STATE_FIELDS + EXACT_FIELDS:
        assert torch.equal(getattr(s_u, name), getattr(s_c, name)), name
    assert torch.equal(o_u, o_c)


def test_chunked_rollout_matches_unchunked():
    lidar = dict(lidar_dirs=_lidar_dirs(), lidar_range=20.0)
    env_u = _env(num_worlds=4, **lidar)
    env_c = _env(num_worlds=4, chunk=2, **lidar)
    _, start = _settled(4)
    acts = torch.from_numpy(_actions((5, 4, 2, 6), seed=5, scale=0.3))
    f_u, (traj_u, lid_u) = env_u.rollout(start, acts)
    f_c, (traj_c, lid_c) = env_c.rollout(start, acts)
    assert traj_u.shape == traj_c.shape == (5, 4, 16, 13)
    for name in STATE_FIELDS + EXACT_FIELDS:
        assert torch.equal(getattr(f_u, name), getattr(f_c, name)), name
    assert torch.equal(traj_u, traj_c) and torch.equal(lid_u, lid_c)


def test_obs_slots_selects_actor_rows():
    env_all = _env(num_worlds=2)
    env_sel = _env(num_worlds=2, obs_slots=ACTORS)
    s_a, o_a = env_all.reset()
    s_s, o_s = env_sel.reset()
    assert o_a.shape == (2, 16, 13) and o_s.shape == (2, 2, 13)
    assert env_sel.num_obs_slots == 2
    acts = torch.full((2, 2, 6), 0.5)
    s_a, o_a = env_all.step(s_a, acts)
    s_s, o_s = env_sel.step(s_s, acts)
    assert torch.equal(o_a[:, ACTORS, :], o_s)
    _, traj = env_sel.rollout(s_s, torch.zeros((3, 2, 2, 6)))
    assert traj.shape == (3, 2, 2, 13)


def test_duplicate_actor_slots_sum():
    """An actor slot named twice gets both actions, as the reference's
    one-hot projection gives it."""
    twice = _env(actor_slots=[4, 4, 5])
    once = _env(actor_slots=[4, 5])
    _, start = _settled()
    acts = torch.from_numpy(_actions((WORLDS, 3, 6), seed=6))
    summed = torch.stack([acts[:, 0] + acts[:, 1], acts[:, 2]], dim=1)
    s_t, _ = twice.step(start, acts)
    s_o, _ = once.step(start, summed)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(s_t, name), getattr(s_o, name)), name
    still, _ = once.step(start, torch.zeros_like(summed))
    assert not torch.equal(s_o.linvel, still.linvel)


def test_zero_actors_is_the_bare_step():
    env = _env(actor_slots=[], lidar_dirs=_lidar_dirs())
    _, tcfg = configs()
    _, start = _settled()
    state, obs = env.step(start, torch.zeros((WORLDS, 0, 6)))
    assert isinstance(obs, torch.Tensor)         # no actors, no lidar
    ref = make_batched_step_fn(tcfg, substeps=2, device="cpu")(start)
    for name in STATE_FIELDS + EXACT_FIELDS:
        assert torch.equal(getattr(state, name), getattr(ref, name)), name
    assert env.num_actors == 0


def test_bad_chunk_raises():
    with pytest.raises(ValueError):
        _env(num_worlds=6, chunk=4)


def test_state_on_other_device_raises():
    _, tcfg = configs()
    env = PhysicsEnv(tcfg, _scene, actor_slots=[4], num_worlds=2,
                     device="meta")
    batch = replicate(_scene(tcfg, 0), 2, device="cpu")
    with pytest.raises(ValueError):
        env.step(batch, torch.zeros((2, 1, 6)))


def test_env_lidar_channel():
    """A sphere above a floor: the down ray sees the floor, the up ray
    misses and reads 1."""
    _, tcfg = configs()

    def scene(cfg, seed):
        b = WorldBuilder(cfg, seed)
        b.add_body_map((0.0, -0.5, 0.0), (0.0, 0.0, 0.0), (40.0, 1.0, 40.0))
        b.add_body(BodyType.SPHERE, (0.0, 3.0, 0.0), (0.3, 0.0, 0.0))
        return b.finish("cpu")

    dirs = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    env = PhysicsEnv(tcfg, scene, actor_slots=[1], num_worlds=2, substeps=1,
                     lidar_dirs=dirs, lidar_range=20.0, device="cpu")
    state, _ = env.reset()
    state, (obs, lidar) = env.step(state, torch.zeros((2, 1, 6)))
    assert lidar.shape == (2, 1, 3)
    assert 2.0 < float(lidar[0, 0, 0]) * 20.0 < 3.2
    assert abs(float(lidar[0, 0, 2]) - 1.0) < 1e-5
