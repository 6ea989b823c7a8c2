"""The port's world axis split over devices (``parallel/mesh.py``), held
to the unsharded step and to JAX's batched step.

The cases of ``tests/test_mesh.py`` on a mesh of 8 CPU "devices": both
step functions, sharded bitwise equal to unsharded. JAX's claim of no
collectives in the HLO has no counterpart to check here: a port step that
mixed devices would raise (``tests/test_torch_cuda.py`` steps a mesh of
the CPU and the card).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.parallel.batch import (
    make_batched_step_fn as jax_batched_step_fn)
from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.parallel import batch as pbatch
from rl_ode_physics_tpu_torch.parallel import mesh as pmesh
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import single_cpu_thread, to_numpy  # noqa: F401

CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=128)
CFG = EngineConfig(**CAPS)
WORLDS = 16
SUBSTEPS = 3
ATOL = 1e-4      # tests/test_torch_step.py's tolerance against JAX


def _batch(num_worlds: int = WORLDS) -> WorldState:
    """``tests/test_mesh.py``'s batch: the stack world in ``num_worlds``
    copies, every dynamic body raised by 0.013 m a world index."""
    w = scenes.stack_world(CFG, num_bodies=10, seed=3, device="cpu")
    b = pbatch.replicate(w, num_worlds, device="cpu")
    bump = torch.arange(num_worlds, dtype=b.pos.dtype) * 0.013
    lift = bump[:, None] * (b.inv_mass > 0)
    return b.replace(pos=b.pos + torch.nn.functional.pad(
        lift[..., None], (1, 1)))


def _assert_bitwise_equal(a: WorldState, b: WorldState):
    for f in dataclasses.fields(WorldState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.device == y.device, f.name
        assert torch.equal(x, y), f.name


@pytest.fixture(scope="module")
def mesh():
    return pmesh.make_mesh(["cpu"] * 8)


@pytest.mark.parametrize("path", ["sharded", "shard_map"])
def test_sharded_step_bitwise_matches_single_device(mesh, path):
    b0 = _batch()
    ref = pbatch.make_batched_step_fn(CFG, substeps=SUBSTEPS,
                                      device="cpu")(b0)
    make = (pmesh.make_sharded_step_fn if path == "sharded"
            else pmesh.make_shard_map_step_fn)
    out = make(CFG, mesh, substeps=SUBSTEPS)(pmesh.shard_batch(b0, mesh))
    assert len(out) == 8
    assert all(s.num_worlds == 2 for s in out)
    _assert_bitwise_equal(ref, pmesh.gather_batch(out))


def test_unsharded_step_matches_jax():
    b0 = _batch()
    arrays = bridge.world_to_numpy(b0)
    jbatch = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jout = jax_batched_step_fn(JaxConfig(**CAPS), substeps=SUBSTEPS,
                               donate=False)(jbatch)
    got = bridge.world_to_numpy(
        pbatch.make_batched_step_fn(CFG, substeps=SUBSTEPS, device="cpu")(b0))
    ref = to_numpy(jout)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[name], ref[name]), name


def test_shard_batch_places_worlds_across_devices(mesh):
    b0 = _batch()
    shards = pmesh.shard_batch(b0, mesh)
    assert len(shards) == 8
    for i, shard in enumerate(shards):
        assert shard.pos.shape == (2,) + b0.pos.shape[1:]
        assert shard.device == mesh.devices[i]
        # a copy, not a view of the batch
        assert shard.pos.data_ptr() != b0.pos[2 * i:].data_ptr()
        _assert_bitwise_equal(shard, pbatch.take_worlds(b0, 2 * i, 2 * i + 2))
    _assert_bitwise_equal(pmesh.gather_batch(shards), b0)


def test_uneven_batch_raises(mesh):
    with pytest.raises(ValueError, match="evenly"):
        pmesh.shard_batch(_batch(12), mesh)


def test_shards_off_their_devices_raise(mesh):
    fn = pmesh.make_sharded_step_fn(CFG, pmesh.make_mesh(["cpu"] * 2))
    shards = pmesh.shard_batch(_batch(), mesh)
    with pytest.raises(ValueError, match="shards"):
        fn(shards)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pmesh.make_mesh()


def test_batch_sharding_is_contiguous_blocks_in_mesh_order(mesh):
    spans = pmesh.batch_sharding(mesh).spans(WORLDS)
    assert [(s, e) for _, s, e in spans] == [(2 * i, 2 * i + 2)
                                            for i in range(8)]
    assert [d for d, _, _ in spans] == list(mesh.devices)


def test_batched_step_is_one_substep():
    b0 = _batch(4)
    one = pbatch.batched_step(b0, CFG)
    _assert_bitwise_equal(
        one, pbatch.make_batched_step_fn(CFG, substeps=1, device="cpu")(b0))
    assert (one.tick == 1).all()
