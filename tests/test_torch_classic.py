"""The port's compaction primitives, classic broadphase, classic
narrowphase and row-major typed narrowphase against the JAX package's.

Selections are held bitwise (indices, masks, counts, overflow, keys, body
ids); contact geometry within 1e-5. The scene is a 25-body pile of boxes,
spheres and capsules in random poses settled by the JAX classic step, so
that every pair kernel of the pile has contacts, box-box edge and face
cases among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.ops import broadphase as jax_bp
from rl_ode_physics_tpu.ops import compaction as jax_compaction
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.ops import broadphase as t_bp
from rl_ode_physics_tpu_torch.ops import compaction
from rl_ode_physics_tpu_torch.ops import narrowphase as t_np
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (PILE, compare_contacts, jax_state, settled_pile,
                         to_numpy)



def _masks(seed, b=3, m=300):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.0, 0.6, size=(b, 1))
    mask = rng.uniform(size=(b, m)) < density
    mask[0] = False                          # an empty world
    return mask


@pytest.mark.parametrize("k", [1, 40, 64, 300])
def test_compact_mask_exact(k):
    mask = _masks(k)
    got = compaction.compact_mask(torch.from_numpy(mask), k)
    for w in range(mask.shape[0]):
        ref = jax.jit(jax_compaction.compact_mask, static_argnums=1)(
            jnp.asarray(mask[w]), k)
        for r, g in zip(ref, got):
            r = np.asarray(r)
            assert g.dtype == getattr(torch, str(r.dtype))
            assert np.array_equal(g[w].numpy(), r)


@pytest.mark.parametrize("k", [16, 128])
def test_compact_rows_exact(k):
    mask = _masks(7)
    payload = np.random.default_rng(1).normal(
        size=mask.shape + (10,)).astype(np.float32)
    got = compaction.compact_rows(torch.from_numpy(mask),
                                  torch.from_numpy(payload), k)
    for w in range(mask.shape[0]):
        ref = jax.jit(jax_compaction.compact_rows, static_argnums=2)(
            jnp.asarray(mask[w]), jnp.asarray(payload[w]), k)
        for r, g in zip(ref, got):
            assert np.array_equal(g[w].numpy(), np.asarray(r))


def _states(substeps=60):
    arrays = settled_pile(substeps)
    return jax_state(arrays), bridge.world_from_numpy(arrays, device="cpu")


def _configs(**kw):
    kw = dict(PILE, **kw)
    return JaxConfig(**kw), TorchConfig(**kw)


@pytest.mark.parametrize("cp", [160, 12])
def test_broadphase_exact(cp):
    jcfg, tcfg = _configs(max_pair_candidates=cp)
    jstate, tstate = _states()
    ref = to_numpy(jax.jit(lambda s: jax_bp.broadphase(s, jcfg))(jstate))
    got = t_bp.broadphase(tstate, tcfg)
    for name, r in ref.items():
        g = getattr(got, name)[0].numpy()
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    assert ref["count"] >= 12
    assert (ref["overflow"] > 0) == (cp == 12)


def test_broadphase_margin_and_exclude_exact():
    jcfg, tcfg = _configs()
    jstate, tstate = _states()
    n = PILE["max_bodies"]
    exclude = np.random.default_rng(3).uniform(size=(n, n)) < 0.3
    ref = to_numpy(jax.jit(lambda s: jax_bp.broadphase(
        s, jcfg, margin=0.05, exclude=jnp.asarray(exclude)))(jstate))
    got = t_bp.broadphase(tstate, tcfg, margin=0.05,
                          exclude=torch.from_numpy(exclude))
    for name, r in ref.items():
        assert np.array_equal(getattr(got, name)[0].numpy(), r), name


def test_pair_eligibility_exclude_exact():
    jstate, tstate = _states()
    n = PILE["max_bodies"]
    exclude = np.random.default_rng(4).uniform(size=(n, n)) < 0.5
    ref = jax.jit(jax_np._pair_eligibility)(jstate, jnp.asarray(exclude))
    got = t_np._pair_eligibility(tstate, torch.from_numpy(exclude))
    for r, g in zip(ref, got):
        assert np.array_equal(g[0].numpy(), np.asarray(r))


@pytest.mark.parametrize("kw", [dict(), dict(exact_box_clip=True),
                                dict(max_contacts_per_pair=4),
                                dict(max_contacts_per_pair=2,
                                     enable_capsules=False),
                                dict(max_contacts=8)],
                         ids=["K8", "K8-exact", "K4", "K2", "overflow"])
def test_classic_narrowphase_matches(kw):
    jcfg, tcfg = _configs(**kw)
    jstate, tstate = _states()

    def jax_fn(s):
        return jax_np.narrowphase(s, jax_bp.broadphase(s, jcfg), jcfg)

    ref = jax.jit(jax_fn)(jstate)
    got = t_np.narrowphase(tstate, t_bp.broadphase(tstate, tcfg), tcfg)
    out = compare_contacts(ref, got)
    if "max_contacts" in kw:
        assert out["overflow"] > 0
    else:
        assert out["overflow"] == 0 and out["count"] >= 10


def test_classic_narrowphase_covers_every_kernel():
    """The compared pile holds contacts of every pair type it has."""
    jcfg, _ = _configs()
    jstate, _ = _states()
    ref = to_numpy(jax.jit(lambda s: jax_np.narrowphase(
        s, jax_bp.broadphase(s, jcfg), jcfg))(jstate))
    types = settled_pile(60)["body_type"]
    v = ref["valid"]
    pairs = {tuple(sorted((int(types[a]), int(types[b]))))
             for a, b in zip(ref["a"][v], ref["b"][v])}
    assert {(1, 2), (2, 2), (2, 3), (1, 3), (3, 3)} <= pairs, pairs


TYPED = [dict(cm_narrowphase=False, max_contacts_per_pair=4),
         dict(cm_narrowphase=False, max_contacts_per_pair=8),
         dict(exact_box_clip=True, max_contacts_per_pair=8),
         dict(max_contacts_per_pair=2, enable_capsules=False),
         dict(cm_narrowphase=False, max_contacts_per_pair=4,
              selector_dtype="bfloat16"),
         dict(cm_narrowphase=False, max_contacts_per_pair=4,
              bucket_caps=((1, 2, 3), (2, 2, 4), (2, 3, 2)))]


@pytest.mark.parametrize("kw", TYPED, ids=["K4", "K8", "K8-exact", "K2",
                                           "bf16", "bucket-overflow"])
def test_row_major_typed_matches(kw):
    jcfg, tcfg = _configs(typed_buckets=True, **kw)
    jstate, tstate = _states()
    from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
    from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm
    assert t_cm.supports_cm(tcfg) == jax_cm.supports_cm(jcfg)
    ref, ref_pairs = jax.jit(
        lambda s: jax_np.narrowphase_typed(s, jcfg))(jstate)
    got, got_pairs = t_np.narrowphase_typed(tstate, tcfg)
    out = compare_contacts(ref, got)
    assert int(got_pairs[0]) == int(ref_pairs)
    if "bucket_caps" in kw:
        assert out["overflow"] > 0
    else:
        assert out["overflow"] == 0 and out["count"] >= 10


def test_row_major_typed_refuses_sap():
    _, tcfg = _configs(typed_buckets=True, exact_box_clip=True, sap_window=8)
    with pytest.raises(ValueError, match="sap_window"):
        t_np.narrowphase_typed(_states()[1], tcfg)
