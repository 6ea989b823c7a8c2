"""The port's ``step_with_diagnostics`` against the JAX package's.

One substep of each pipeline from the same state on both sides, the JAX
step under ``vmap``: ``mini_stack_world`` settled 48 substeps in 2 kicked
worlds through the classic pipeline (with and without exact box clipping
and PGS), the component-major and row-major typed paths, the dense
pipeline, and the classic and typed paths at capacities too small for the
scene (pairs and rows dropped); and the ridge scene's sphere and capsule
pressed into its mesh through the typed and the classic paths (the box
taken out: a box on the ridge rests on edge-clip rows, whose validity
roundoff decides). Every counter per world: the counts exact, the kinetic
energy and the deepest penetration at rtol 1e-5, atol 1e-6. The state that
comes with them is the one ``step`` gives.
"""

import jax
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.world import (
    step_with_diagnostics as jax_diagnostics)
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu_torch.core import world
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import STACK, jax_state, settled_mini_stack, to_numpy

RTOL, ATOL = 1e-5, 1e-6
COUNTS = ("num_pairs", "num_contacts", "pair_overflow", "contact_overflow",
          "num_bodies")
FLOATS = ("kinetic_energy", "max_penetration")
TIGHT = dict(max_bodies=12, max_pair_candidates=3, max_contacts=10)

PIPELINES = {
    "classic": dict(),
    "classic-exact-clip-pgs": dict(exact_box_clip=True, solver="PGS"),
    "typed-cm": "throughput",
    "typed-row-major": dict(typed_buckets=True, cm_narrowphase=False),
    "dense": dict(dense_pipeline=True),
    "classic-overflowing": dict(TIGHT),
    "typed-overflowing": dict(TIGHT, typed_buckets=True,
                              bucket_caps=((1, 1, 2), (1, 2, 2), (2, 2, 2))),
}


def _configs(kw, **extra):
    if kw == "throughput":
        return (JaxConfig.throughput(**STACK, **extra),
                EngineConfig.throughput(**STACK, **extra))
    kw = dict(kw, **extra)
    solver = kw.pop("solver", "JACOBI")
    caps = {} if "max_bodies" in kw else STACK
    return (JaxConfig(**caps, **kw, solver=JaxSolverKind[solver]),
            EngineConfig(**caps, **kw, solver=SolverKind[solver]))


def _compare(ref_metrics, got_metrics, worlds):
    ref = {k: np.asarray(v).reshape(worlds) for k, v in ref_metrics.items()}
    got = bridge.metrics_to_numpy(got_metrics)
    assert set(got) == set(ref)
    for name in COUNTS:
        assert got[name].dtype == np.int32, name
        assert got[name].shape == (worlds,), name
        assert np.array_equal(got[name], ref[name]), (name, got[name],
                                                      ref[name])
    for name in FLOATS:
        assert got[name].shape == (worlds,), name
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    return ref


@pytest.mark.parametrize("name", list(PIPELINES))
def test_diagnostics_match_jax(name):
    jcfg, tcfg = _configs(PIPELINES[name])
    arrays = settled_mini_stack()
    _, ref = jax.jit(jax.vmap(lambda s: jax_diagnostics(s, jcfg)))(
        jax_state(arrays))
    tstate = bridge.world_from_numpy(arrays, device="cpu")
    nxt, got = world.step_with_diagnostics(tstate, tcfg)
    ref = _compare(ref, got, 2)
    assert (ref["num_contacts"] > 0).all()
    assert (ref["kinetic_energy"] > 0).all()
    # six dynamic bodies and the kinematic player capsule
    assert (ref["num_bodies"] == 7).all()
    if "overflowing" in name:
        assert (ref["pair_overflow"] + ref["contact_overflow"] > 0).all()
        assert torch.equal(nxt.overflow, tstate.overflow
                           + got["pair_overflow"] + got["contact_overflow"])
    else:
        assert (ref["pair_overflow"] == 0).all()
        assert (ref["contact_overflow"] == 0).all()
    plain = world.step(tstate, tcfg)
    for field in ("pos", "quat", "linvel", "angvel", "overflow", "tick"):
        assert torch.equal(getattr(nxt, field), getattr(plain, field)), field


def _ridge_without_box(jcfg):
    state, mesh = jax_scenes.ridge_mesh_scene(jcfg)
    arrays = {k: v.copy() for k, v in to_numpy(state).items()}
    arrays["pos"][1] = [-0.6, 0.35, 0.4]       # the sphere, into the ground
    arrays["pos"][3] = [0.6, 0.3, 0.2]         # the capsule, into a ridge
    arrays["body_type"][2] = int(BodyType.NULL)
    return arrays, mesh


@pytest.mark.parametrize("kw", ["throughput", dict()], ids=["typed", "classic"])
def test_mesh_step_diagnostics_match_jax(kw):
    caps = dict(max_bodies=8, max_pair_candidates=16, max_contacts=64,
                enable_planes=False, enable_capsules=True)
    if kw == "throughput":
        jcfg = JaxConfig.throughput(**caps)
        tcfg = EngineConfig.throughput(**caps)
    else:
        jcfg, tcfg = JaxConfig(**caps), EngineConfig(**caps)
    arrays, jmesh = _ridge_without_box(jcfg)
    _, ref = jax.jit(lambda s: jax_diagnostics(s, jcfg, jmesh,
                                               use_pallas=False))(
        jax_state(arrays))
    mesh = bridge.trimesh_from_numpy(to_numpy(jmesh), device="cpu")
    _, got = world.step_with_diagnostics(
        bridge.world_from_numpy(arrays, device="cpu"), tcfg, mesh)
    ref = _compare(ref, got, 1)
    assert ref["num_contacts"] >= 2           # the sphere and the capsule
    assert ref["max_penetration"] > 0.01


def test_metrics_bridge_round_trip():
    jcfg, tcfg = _configs(dict())
    arrays = settled_mini_stack()
    _, ref = jax.jit(jax.vmap(lambda s: jax_diagnostics(s, jcfg)))(
        jax_state(arrays))
    back = bridge.metrics_from_numpy({k: np.asarray(v)
                                      for k, v in ref.items()}, device="cpu")
    assert all(v.shape == (2,) for v in back.values())
    for name, value in bridge.metrics_to_numpy(back, world=1).items():
        assert np.array_equal(value, np.asarray(ref[name])[1]), name
    # one world's scalars become (1,) tensors
    one = bridge.metrics_from_numpy(
        {k: np.asarray(v)[0] for k, v in ref.items()}, device="cpu")
    assert all(v.shape == (1,) for v in one.values())


def test_float64_diagnostics():
    """A float64 world's float counters are float64."""
    tcfg = EngineConfig.conformance(**STACK, dtype="float64")
    arrays = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
              for k, v in settled_mini_stack().items()}
    _, got = world.step_with_diagnostics(
        bridge.world_from_numpy(arrays, device="cpu"), tcfg)
    for name in FLOATS:
        assert got[name].dtype == torch.float64, name
    for name in COUNTS:
        assert got[name].dtype == torch.int32, name
    assert bool((got["num_contacts"] > 0).all())
