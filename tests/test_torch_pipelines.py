"""Every narrowphase pipeline of the port's step against the JAX package.

``mini_stack_world`` (a 3-box tower, two spheres, a lying capsule,
a kinematic player capsule on the floor) settled 48 JAX substeps, in 2
worlds whose velocities are kicked differently, then 8 substeps on each
side of: the classic pipeline (``EngineConfig()``), the same with exact box
clipping, the row-major typed path (``cm_narrowphase=False``), the
component-major path with sweep-and-prune, the dense pipeline and the
throughput policy with capsules and planes. pos/quat/linvel/angvel within
1e-4, tick, overflow and rng_state exact. The tower's boxes rest on four
deep face contacts each, so no grazing row decides a step.
"""

import numpy as np
import pytest

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.parallel.batch import (
    make_batched_step_fn as jax_batched_step_fn)
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (MINI_SETTLE, STACK, jax_state, settled_mini_stack,
                         to_numpy)

ATOL = 1e-4
SUBSTEPS = 8

PIPELINES = {
    "classic": dict(),
    "classic-exact-clip": dict(exact_box_clip=True),
    "typed-row-major": dict(typed_buckets=True, cm_narrowphase=False),
    "typed-sap": dict(typed_buckets=True, sap_window=6, sap_broad=2),
    "dense": dict(dense_pipeline=True),
    "throughput-capsules": "throughput",
}


def _configs(name):
    kw = PIPELINES[name]
    if kw == "throughput":
        return JaxConfig.throughput(**STACK), TorchConfig.throughput(**STACK)
    return JaxConfig(**STACK, **kw), TorchConfig(**STACK, **kw)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_step_matches_jax(name):
    jcfg, tcfg = _configs(name)
    arrays = settled_mini_stack()
    jbatch = jax_batched_step_fn(jcfg, substeps=SUBSTEPS, donate=False)(
        jax_state(arrays))
    tbatch = make_batched_step_fn(tcfg, substeps=SUBSTEPS, device="cpu")(
        bridge.world_from_numpy(arrays, device="cpu"))
    ref, got = to_numpy(jbatch), bridge.world_to_numpy(tbatch)
    for field in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[field], ref[field], atol=ATOL, rtol=0,
                                   err_msg=field)
    for field in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[field], ref[field]), field
    assert (got["tick"] == MINI_SETTLE + SUBSTEPS).all()
    assert (got["overflow"] == 0).all()
    # the tower stands and the kicks moved the worlds apart
    assert (got["pos"][:, 1:4, 1] > 0.7).all()
    assert np.abs(got["linvel"][0] - got["linvel"][1]).max() > 1e-3


def test_every_pipeline_steps_without_raising():
    """The configurations the port now takes, through ``make_step_fn``."""
    for name in PIPELINES:
        _, tcfg = _configs(name)
        make_step_fn(tcfg)(scenes.mini_stack_world(tcfg, device="cpu"))
