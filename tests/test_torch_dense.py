"""The port's dense all-pairs pipeline against the JAX package's.

``dense_narrowphase`` on the settled 25-body pile of ``_torch_port`` (every
slot pair of the 32-slot grid at K=8 and K=4): validity exact but for
grazing slots (|depth| < 1e-6), point, normal and depth within 1e-5 on
valid slots. ``dense_solve`` on the JAX package's own manifold of that
pile, so that the solver alone is compared: velocities within 1e-5, with
and without friction and at finite friction. The memory check of
``make_batched_step_fn`` is arithmetic on the card's free memory, held
here on its formula.
"""

import jax
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.ops import dense as jax_dense
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.ops import dense
from rl_ode_physics_tpu_torch.parallel.batch import dense_pipeline_bytes
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import PILE, jax_state, settled_pile

ATOL = 1e-5


def _setup(**kw):
    kw = dict(PILE, dense_pipeline=True, **kw)
    arrays = settled_pile(60)
    return (JaxConfig(**kw), TorchConfig(**kw), jax_state(arrays),
            bridge.world_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("k", [8, 4])
def test_dense_narrowphase_matches(k):
    jcfg, tcfg, jstate, tstate = _setup(max_contacts_per_pair=k)
    ref = [np.asarray(x) for x in jax.jit(
        lambda s: jax_dense.dense_narrowphase(s, jcfg))(jstate)]
    got = [x[0].numpy() for x in dense.dense_narrowphase(tstate, tcfg)]
    rp, rn, rd, rv = ref
    gp, gn, gd, gv = got
    graze = np.abs(rd) < 1e-6
    assert np.array_equal(rv | graze, gv | graze)
    both = rv & gv
    for r, g, name in ((rp, gp, "point"), (rn, gn, "normal"),
                       (rd, gd, "depth")):
        np.testing.assert_allclose(g[both], r[both], rtol=ATOL, atol=ATOL,
                                   err_msg=name)
    assert rv.sum() >= 20


@pytest.mark.parametrize("kw", [dict(), dict(friction=False), dict(mu=0.6),
                                dict(jacobi_omega=0.7, solver_iterations=7)],
                         ids=["mu-inf", "frictionless", "mu-0.6", "omega"])
def test_dense_solve_matches(kw):
    jcfg, tcfg, jstate, tstate = _setup(**kw)
    manifold = jax.jit(lambda s: jax_dense.dense_narrowphase(s, jcfg))(jstate)
    ref = jax.jit(lambda s, m: jax_dense.dense_solve(s, m, jcfg))(
        jstate, manifold)
    got = dense.dense_solve(
        tstate, tuple(torch.from_numpy(np.array(x))[None]
                      for x in manifold), tcfg)
    for name in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), r,
                                   rtol=ATOL, atol=ATOL, err_msg=name)
    moved = np.abs(np.asarray(ref.linvel) - np.asarray(jstate.linvel))
    assert moved.max() > 1e-3                  # the contacts did push


def test_dense_memory_estimate():
    cfg = TorchConfig(max_bodies=16, max_contacts_per_pair=8)
    per_world = dense.LIVE_PAIR_TENSORS * 16 * 16 * 8 * 3 * 4
    assert dense_pipeline_bytes(cfg, 1) == per_world
    assert dense_pipeline_bytes(cfg, 1000) == 1000 * per_world
