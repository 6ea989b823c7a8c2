"""The port's state, scenes, quaternions and PRNG against the JAX package's.

Scenes are built on the host from the same ``RandStream``, so the port's
``bench_world`` must equal the JAX one field for field, bit for bit.
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core import state as jax_state
from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.parallel.batch import replicate as jax_replicate
from rl_ode_physics_tpu.utils import prng as jax_prng
from rl_ode_physics_tpu.utils import quat as jax_quat
from rl_ode_physics_tpu_torch.core import state as t_state
from rl_ode_physics_tpu_torch.core.config import EngineConfig, bench_config
from rl_ode_physics_tpu_torch.models import scenes as t_scenes
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.utils import bridge
from rl_ode_physics_tpu_torch.utils import prng as t_prng
from rl_ode_physics_tpu_torch.utils import quat as t_quat

from _torch_port import SMALL_BODIES, configs, to_numpy

FIELDS = [f.name for f in dataclasses.fields(t_state.WorldState)]


def _worlds():
    jcfg, tcfg = configs()
    ref = to_numpy(jax_scenes.bench_world(jcfg, num_bodies=SMALL_BODIES))
    got = bridge.world_to_numpy(
        t_scenes.bench_world(tcfg, num_bodies=SMALL_BODIES, device="cpu"), 0)
    return ref, got


@pytest.mark.parametrize("field", FIELDS)
def test_bench_world_field_exact(field):
    ref, got = _worlds()
    assert got[field].dtype == ref[field].dtype
    assert got[field].shape == ref[field].shape
    assert np.array_equal(got[field], ref[field])


def test_grass_plane_world_exact():
    jcfg, tcfg = configs()
    ref = to_numpy(jax_scenes.grass_plane_world(jcfg, seed=5))
    got = bridge.world_to_numpy(
        t_scenes.grass_plane_world(tcfg, seed=5, device="cpu"), 0)
    for name in FIELDS:
        assert np.array_equal(got[name], ref[name]), name


def test_create_world_exact():
    jcfg, tcfg = configs()
    ref = to_numpy(jax_state.create_world(jcfg, seed=9))
    got = bridge.world_to_numpy(t_state.create_world(tcfg, seed=9,
                                                     device="cpu"), 0)
    for name in FIELDS:
        assert got[name].dtype == ref[name].dtype, name
        assert np.array_equal(got[name], ref[name]), name


def test_bridge_round_trip():
    ref, _ = _worlds()
    back = bridge.world_to_numpy(bridge.world_from_numpy(ref, device="cpu"), 0)
    for name in FIELDS:
        assert back[name].dtype == ref[name].dtype, name
        assert np.array_equal(back[name], ref[name]), name


@pytest.mark.parametrize("fn", ["from_euler_xyz", "to_matrix", "integrate",
                                "rotate", "mul", "normalize"])
def test_quat_matches_jax(fn):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    if fn == "from_euler_xyz":
        args = (v,)
    elif fn == "integrate":
        args = (q, v, 1.0 / 120.0)
    elif fn == "rotate":
        args = (q, v)
    elif fn == "mul":
        args = (q, q2)
    elif fn == "normalize":
        args = (q2,)
    else:
        args = (q,)
    ref = getattr(jax_quat, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args])
    got = getattr(t_quat, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                                else a for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("seed", [42, 0xFFFFFFFE])
def test_replicate_reseed_rng_state_exact(seed):
    jcfg, tcfg = configs()
    jw = jax_scenes.grass_plane_world(jcfg, seed=seed)
    tw = t_scenes.grass_plane_world(tcfg, seed=seed, device="cpu")
    ref = to_numpy(jax_replicate(jw, 5))
    got = bridge.world_to_numpy(replicate(tw, 5, device="cpu"))
    assert got["rng_state"].dtype == np.uint32
    assert np.array_equal(got["rng_state"], ref["rng_state"])
    for name in FIELDS:
        assert np.array_equal(got[name], ref[name].reshape(got[name].shape)), name


def test_rand_stream_matches_jax():
    a, b = jax_prng.RandStream(1234), t_prng.RandStream(1234)
    for _ in range(50):
        assert a.next() == b.next()
        assert a.randint(-3, 17) == b.randint(-3, 17)
        assert a.double(-0.05, 0.05) == b.double(-0.05, 0.05)
        assert a.color() == b.color()
    counters = np.arange(100, dtype=np.uint32)
    assert np.array_equal(jax_prng.raw(np.uint32(7), counters),
                          t_prng.raw(np.uint32(7), counters))


def _fields(cfg) -> dict:
    return {f.name: (v.value if hasattr(v, "value") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def test_engine_config_defaults_match_jax():
    assert _fields(EngineConfig()) == _fields(JaxConfig())
    assert (_fields(EngineConfig.throughput(max_bodies=64))
            == _fields(JaxConfig.throughput(max_bodies=64)))


def test_bench_config_matches_bench_py(monkeypatch):
    """The port's copy of ``bench.bench_config(64)`` at its defaults, with
    the compaction through the kernel (``BENCH_PALLAS_COMPACT=1``)."""
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("BENCH_PALLAS_COMPACT", "1")
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    sys.modules.pop("bench", None)
    import bench
    assert _fields(bench_config(64)) == _fields(bench.bench_config(64))


def test_mass_helpers_and_world_inertia_match_jax():
    rng = np.random.default_rng(12)
    r = rng.uniform(0.1, 0.6, size=8).astype(np.float32)
    sides = rng.uniform(0.2, 1.0, size=(8, 3)).astype(np.float32)
    length = rng.uniform(0.3, 1.5, size=8).astype(np.float32)
    pairs = [
        (jax_state.sphere_mass(jnp.asarray(r)),
         t_state.sphere_mass(torch.from_numpy(r))),
        (jax_state.box_mass(jnp.asarray(sides)),
         t_state.box_mass(torch.from_numpy(sides))),
        (jax_state.capsule_mass(jnp.asarray(r), jnp.asarray(length)),
         t_state.capsule_mass(torch.from_numpy(r), torch.from_numpy(length))),
        (jax_state.default_mass(), t_state.default_mass()),
    ]
    for ref, got in pairs:
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    arrays = _worlds()[0]
    arrays["quat"] = rng.normal(size=arrays["quat"].shape).astype(np.float32)
    arrays["quat"] /= np.linalg.norm(arrays["quat"], axis=-1, keepdims=True)
    jw = jax_state.WorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tw = bridge.world_from_numpy(arrays, device="cpu")
    np.testing.assert_allclose(t_state.world_inv_inertia(tw)[0].numpy(),
                               np.asarray(jax_state.world_inv_inertia(jw)),
                               atol=1e-6, rtol=0)
