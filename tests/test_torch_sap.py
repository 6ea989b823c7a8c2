"""The port's sweep-and-prune pair phase against the JAX package's.

SAP (``sap_window``): the windowed masks bitwise (permutation, hit,
type codes, window-miss count), then the contacts of the scenes of
``tests/test_sap.py``: a sphere pile at window 12, a box/sphere/capsule
pile at window 20, and 8 spheres in one x-column at window 2 with one
broad body, whose misses must be counted loudly; and the settled 25-body
pile of ``_torch_port`` at window 8 with two broad bodies. Keys, counts
and overflow exact; values within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models.builder import WorldBuilder as JaxBuilder
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
from rl_ode_physics_tpu_torch.ops import narrowphase as t_np
from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (PILE, compare_contacts, jax_state, mixed_pile,
                         settled_pile, to_numpy)

# tests/test_sap.py's configuration
BASE = dict(max_bodies=32, max_pair_candidates=256, max_contacts=256,
            typed_buckets=True, cm_narrowphase=True,
            max_contacts_per_pair=4, selector_dtype="float32")


def _both(build):
    """One scene built on each side: (JAX state, port state on the CPU)."""
    return build(JaxBuilder).finish(), build(WorldBuilder).finish("cpu")


def _sphere_pile(cfg, seed=3, n=20):
    def build(cls):
        rng = np.random.default_rng(seed)
        b = cls(cfg, 0)
        b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (40.0, 1.0, 40.0))
        for _ in range(n):
            b.add_body(1, (float(rng.uniform(-1.5, 1.5)),
                           float(rng.uniform(0.7, 2.5)),
                           float(rng.uniform(-1.5, 1.5))),
                       (float(rng.uniform(0.25, 0.5)), 0.0, 0.0))
        return b
    return _both(build)


def _mixed_pile(cfg, seed=11):
    def build(cls):
        rng = np.random.default_rng(seed)
        b = cls(cfg, 0)
        b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (40.0, 1.0, 40.0))
        for i in range(22):
            kind = (2, 1, 3)[i % 3]
            pos = (float(rng.uniform(-2, 2)), float(rng.uniform(0.8, 3.0)),
                   float(rng.uniform(-2, 2)))
            if kind == 1:
                size = (float(rng.uniform(0.2, 0.5)), 0.0, 0.0)
            elif kind == 2:
                size = tuple(float(rng.uniform(0.3, 0.9)) for _ in range(3))
            else:
                size = (float(rng.uniform(0.15, 0.3)),
                        float(rng.uniform(0.4, 1.0)), 0.0)
            b.add_body(kind, pos, size)
        return b
    return _both(build)


def _column(cfg):
    def build(cls):
        b = cls(cfg, 0)
        b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (40.0, 1.0, 40.0))
        for i in range(8):
            b.add_body(1, (0.0, 0.8 + 0.3 * i, 0.0), (0.3, 0.0, 0.0))
        return b
    return _both(build)


def _settled_pile_states():
    arrays = settled_pile(60)
    return jax_state(arrays), bridge.world_from_numpy(arrays, device="cpu")


SAP_CASES = {
    "sphere-pile-w12": (_sphere_pile, dict(sap_window=12)),
    "mixed-pile-w20": (_mixed_pile, dict(sap_window=20)),
    "column-w2-b1": (_column, dict(sap_window=2, sap_broad=1)),
    "settled-pile-w8-b2": (None, dict(sap_window=8, sap_broad=2)),
}


def _sap_case(name):
    scene, kw = SAP_CASES[name]
    base = dict(BASE, **kw)
    jcfg, tcfg = JaxConfig(**base), TorchConfig(**base)
    if scene is None:
        jcfg = jcfg.replace(max_bodies=PILE["max_bodies"])
        tcfg = tcfg.replace(max_bodies=PILE["max_bodies"])
        jstate, tstate = _settled_pile_states()
    else:
        jstate, tstate = scene(jcfg)
    return jcfg, tcfg, jstate, tstate


@functools.lru_cache(maxsize=None)
def _jax_sap(name):
    """The JAX side of a case in one compiled call: (SAP masks,
    (contacts, pairs tested))."""
    jcfg, _, jstate, _ = _sap_case(name)
    return jax.jit(lambda s: (jax_cm._sap_pair_masks(s, jcfg, None),
                              jax_np.narrowphase_typed(s, jcfg)))(jstate)


@pytest.mark.parametrize("name", list(SAP_CASES))
def test_sap_pair_masks_exact(name):
    _, tcfg, _, tstate = _sap_case(name)
    ref = _jax_sap(name)[0]
    got = t_cm._sap_pair_masks(tstate, tcfg)
    for label, r, g in zip(("feat_perm", "hit", "tmin", "tmax", "overflow"),
                           ref, got):
        assert np.array_equal(g[0].numpy(), np.asarray(r)), label
    assert np.asarray(ref[1]).sum() >= 5


def test_sap_pair_masks_exclude_exact():
    jcfg, tcfg, jstate, tstate = _sap_case("settled-pile-w8-b2")
    n = PILE["max_bodies"]
    exclude = np.random.default_rng(2).uniform(size=(n, n)) < 0.4
    ref = jax.jit(lambda s: jax_cm._sap_pair_masks(
        s, jcfg, jnp.asarray(exclude)))(jstate)
    got = t_cm._sap_pair_masks(tstate, tcfg, torch.from_numpy(exclude))
    for r, g in zip(ref, got):
        assert np.array_equal(g[0].numpy(), np.asarray(r))


@pytest.mark.parametrize("name", list(SAP_CASES))
def test_sap_contacts_match(name):
    _, tcfg, _, tstate = _sap_case(name)
    ref, ref_pairs = _jax_sap(name)[1]
    got, got_pairs = t_np.narrowphase_typed(tstate, tcfg)
    out = compare_contacts(ref, got)
    assert int(got_pairs[0]) == int(ref_pairs)
    if name.startswith("column"):
        assert out["overflow"] > 0          # window misses, counted loudly
    else:
        assert out["overflow"] == 0


def test_mixed_pile_builders_agree():
    """The shared pile helper builds the same world on both sides."""
    cfg_j, cfg_t = JaxConfig(**PILE), TorchConfig(**PILE)
    ref = to_numpy(mixed_pile(JaxBuilder, cfg_j).finish())
    got = bridge.world_to_numpy(mixed_pile(WorldBuilder, cfg_t).finish("cpu"),
                                0)
    for name, r in ref.items():
        assert np.array_equal(got[name], r), name
