"""The port's pair eligibility, pair kernels and typed component-major
narrowphase against the JAX package's.

Selections (eligibility, contact indices, keys, counts, overflow) must be
exact; contact geometry may differ by f32 roundoff (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu.ops.broadphase import compute_aabbs as jax_aabbs
from rl_ode_physics_tpu_torch.ops import narrowphase as t_np
from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm
from rl_ode_physics_tpu_torch.ops.broadphase import compute_aabbs
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import configs, settled_state, to_numpy

ATOL = 1e-5
SELECTORS = ["float32", "bfloat16"]


def _states(substeps=30):
    arrays = settled_state(substeps)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jstate, bridge.world_from_numpy(arrays, device="cpu")


def test_compute_aabbs_match():
    jstate, tstate = _states()
    np.testing.assert_allclose(compute_aabbs(tstate)[0].numpy(),
                               np.asarray(jax_aabbs(jstate)), atol=1e-6,
                               rtol=0)


def test_pair_eligibility_exact():
    jstate, tstate = _states()
    ref = jax.jit(jax_np._pair_eligibility)(jstate)
    got = t_np._pair_eligibility(tstate)
    assert np.asarray(ref[0]).sum() >= 3       # first impacts
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g[0].numpy())


def _random_pairs(kind, p=128, seed=0):
    """Random overlapping-ish pairs: (pa, qa, sa, pb, qb, sb) numpy planes."""
    rng = np.random.default_rng(seed)
    pa = rng.uniform(-1.0, 1.0, size=(3, p))
    pb = pa + rng.uniform(-0.8, 0.8, size=(3, p))
    qa = rng.normal(size=(4, p))
    qa /= np.linalg.norm(qa, axis=0)
    qb = rng.normal(size=(4, p))
    qb /= np.linalg.norm(qb, axis=0)

    def sizes(t):
        if t == "sphere":
            return np.stack([rng.uniform(0.2, 0.5, p), np.zeros(p),
                             np.zeros(p)])
        return rng.uniform(0.3, 1.0, size=(3, p))

    ta, tb = kind.split("_")
    return [a.astype(np.float32)
            for a in (pa, qa, sizes(ta), pb, qb, sizes(tb))]


KERNELS = {"sphere_sphere": "cm_sphere_sphere", "sphere_box": "cm_sphere_box",
           "box_box": "cm_box_box"}


@pytest.mark.parametrize("kind", list(KERNELS))
def test_pair_kernel_matches(kind):
    arrays = _random_pairs(kind, seed=len(kind))
    jax_args = [tuple(jnp.asarray(r) for r in a) for a in arrays]
    t_args = [tuple(torch.from_numpy(r.copy()) for r in a) for a in arrays]
    ref = getattr(jax_cm, KERNELS[kind])(*jax_args)
    got = getattr(t_cm, KERNELS[kind])(*t_args)
    if kind == "box_box":
        ref = jax_cm._fold_slots(ref, jax_cm._FOLD_PAIRING[(2, 2)])
        got = t_cm._fold_slots(got, t_cm._FOLD_PAIRING[(2, 2)])
    assert len(ref) == len(got)
    n_valid = 0
    for (rp, rn, rd, rv), (gp, gn, gd, gv) in zip(ref, got):
        rv = np.asarray(rv)
        assert np.array_equal(rv, gv.numpy())
        n_valid += int(rv.sum())
        for r, g in list(zip(rp, gp)) + list(zip(rn, gn)) + [(rd, gd)]:
            np.testing.assert_allclose(g.numpy()[rv], np.asarray(r)[rv],
                                       atol=ATOL, rtol=0)
    assert n_valid > 10


def _compare_contacts(ref, got):
    ref = to_numpy(ref)
    got = bridge.contacts_to_numpy(got, 0)
    for name in ("a", "b", "valid", "key", "count", "overflow"):
        assert got[name].dtype == ref[name].dtype, name
        assert np.array_equal(got[name], ref[name]), name
    valid = ref["valid"]
    for name in ("point", "normal", "depth"):
        np.testing.assert_allclose(got[name][valid], ref[name][valid],
                                   atol=ATOL, rtol=0, err_msg=name)
    return ref


@pytest.mark.parametrize("substeps", [30, 90])
@pytest.mark.parametrize("sel", SELECTORS)
def test_narrowphase_typed_cm_matches(sel, substeps):
    jcfg, tcfg = configs(selector_dtype=sel)
    jstate, tstate = _states(substeps)
    ref, ref_pairs = jax.jit(
        lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    got, got_pairs = t_cm.narrowphase_typed_cm(tstate, tcfg)
    out = _compare_contacts(ref, got)
    assert int(got_pairs[0]) == int(ref_pairs)
    assert out["count"] >= 6 and out["overflow"] == 0


def test_narrowphase_typed_cm_overflow_matches():
    """Bucket and contact capacities far below the scene's counts: the
    dropped pairs and rows are counted the same way."""
    caps = ((1, 1, 2), (1, 2, 3), (2, 2, 2))
    jcfg, tcfg = configs(bucket_caps=caps, max_contacts=8)
    jstate, tstate = _states()
    ref, _ = jax.jit(lambda s: jax_cm.narrowphase_typed_cm(s, jcfg))(jstate)
    got, _ = t_cm.narrowphase_typed_cm(tstate, tcfg)
    out = _compare_contacts(ref, got)
    assert out["overflow"] > 0


@pytest.mark.parametrize("override", [dict(sap_window=8),
                                      dict(exact_box_clip=True),
                                      dict(enable_capsules=True)])
def test_unported_options_raise(override):
    _, tcfg = configs(**override)
    _, tstate = _states()
    with pytest.raises(NotImplementedError):
        t_cm.narrowphase_typed_cm(tstate, tcfg)


def test_supports_cm_matches_jax():
    for kw in (dict(), dict(max_contacts_per_pair=8),
               dict(max_contacts_per_pair=2)):
        jcfg, tcfg = configs(**kw)
        assert t_cm.supports_cm(tcfg) == jax_cm.supports_cm(jcfg), kw
