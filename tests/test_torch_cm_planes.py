"""The port's component-major narrowphase with capsules, planes and joint
exclusions against the JAX package's.

The plane scene of ``tests/test_narrowphase_cm.py:144-156`` (a kinematic
PLANE body under boxes, spheres and capsules) at K=8 and K=4, the settled
25-body pile of ``_torch_port`` with capsules, and the same pile with a
random exclusion mask; both selector dtypes. Keys, counts and overflow
exact; values within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models.builder import WorldBuilder as JaxBuilder
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import PILE, compare_contacts, jax_state, settled_pile, to_numpy


def _settled_pile_states():
    arrays = settled_pile(60)
    return jax_state(arrays), bridge.world_from_numpy(arrays, device="cpu")


def _plane_scene(cfg):
    """tests/test_narrowphase_cm.py:144-156: a kinematic PLANE body and
    boxes, spheres and capsules above and across it."""
    def build(cls):
        b = cls(cfg, 0)
        b.add_body(4, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), kinematic=True)
        rng = np.random.default_rng(7)
        for i in range(8):
            kind = (2, 1, 3)[i % 3]
            size = ((0.4, 0.5, 0.6) if kind == 2
                    else (0.3, 0.8, 0.0) if kind == 3 else (0.3, 0.0, 0.0))
            b.add_body(kind, (float(rng.uniform(-1, 1)), 0.1 + 0.3 * i,
                              float(rng.uniform(-1, 1))), size)
        return b
    return build(JaxBuilder).finish(), build(WorldBuilder).finish("cpu")


@pytest.mark.parametrize("k", [8, 4])
@pytest.mark.parametrize("sel", ["float32", "bfloat16"])
def test_cm_with_planes_matches(k, sel):
    kw = dict(max_bodies=16, max_pair_candidates=64, max_contacts=128,
              typed_buckets=True, max_contacts_per_pair=k,
              selector_dtype=sel)
    jcfg, tcfg = JaxConfig(**kw), TorchConfig(**kw)
    assert t_cm.supports_cm(tcfg) and jax_cm.supports_cm(jcfg)
    jstate, tstate = _plane_scene(jcfg)
    ref, ref_pairs = jax.jit(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    got, got_pairs = t_cm.narrowphase_typed_cm(tstate, tcfg)
    out = compare_contacts(ref, got)
    assert int(got_pairs[0]) == int(ref_pairs)
    v = out["valid"]
    types = to_numpy(jstate)["body_type"]
    planes = (types[out["a"][v]] == 4) | (types[out["b"][v]] == 4)
    assert out["overflow"] == 0 and planes.sum() >= 6


@pytest.mark.parametrize("sel", ["float32", "bfloat16", "float16"])
def test_cm_with_capsules_matches(sel):
    kw = dict(PILE, typed_buckets=True, max_contacts_per_pair=4,
              selector_dtype=sel)
    jcfg, tcfg = JaxConfig(**kw), TorchConfig(**kw)
    jstate, tstate = _settled_pile_states()
    ref, ref_pairs = jax.jit(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    got, got_pairs = t_cm.narrowphase_typed_cm(tstate, tcfg)
    out = compare_contacts(ref, got)
    assert int(got_pairs[0]) == int(ref_pairs)
    assert out["overflow"] == 0 and out["count"] >= 10


def test_cm_exclude_matches():
    kw = dict(PILE, typed_buckets=True, max_contacts_per_pair=4)
    jcfg, tcfg = JaxConfig(**kw), TorchConfig(**kw)
    jstate, tstate = _settled_pile_states()
    n = PILE["max_bodies"]
    exclude = np.random.default_rng(5).uniform(size=(n, n)) < 0.3
    ref, _ = jax.jit(lambda s: jax_cm.narrowphase_typed_cm(
        s, jcfg, exclude=jnp.asarray(exclude)))(jstate)
    got, _ = t_cm.narrowphase_typed_cm(tstate, tcfg,
                                       exclude=torch.from_numpy(exclude))
    compare_contacts(ref, got)
