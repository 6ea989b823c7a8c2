"""The port's warm starting (``ops/warmstart.py``) against the JAX
package's.

``match_lam`` is an exact selection and must match bit for bit; the warm
step (classic broadphase and narrowphase, the solver started from the
matched impulses, the cache refreshed) follows the JAX warm step under
``vmap`` for 8 substeps, JACOBI and PGS, at atol 1e-5 with the cache keys
exact; and at a starved budget of 2 iterations the port's warm solve lands
closer to the 400-iteration impulses than its cold solve, as
``tests/test_warmstart.py`` shows for the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.ops import warmstart as jax_warmstart
from rl_ode_physics_tpu.ops.narrowphase import Contacts as JaxContacts
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.ops import broadphase, integrator, narrowphase
from rl_ode_physics_tpu_torch.ops import solver, warmstart
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import STACK, jax_state, settled_mini_stack, to_numpy

ATOL = 1e-5
SUBSTEPS = 8


def _keys(rng, b, c, hits_from=None):
    """(B, C) int32 keys: −1 for empty rows, distinct ids otherwise, some
    of them taken from ``hits_from``."""
    keys = np.full((b, c), -1, np.int32)
    for w in range(b):
        live = rng.integers(c // 3, c)
        ids = rng.choice(5000, size=live, replace=False).astype(np.int32)
        if hits_from is not None:
            old = hits_from[w][hits_from[w] >= 0]
            take = min(len(old), live // 2)
            ids[:take] = rng.choice(old, size=take, replace=False)
        keys[w, :live] = ids
    return keys


def test_match_lam_is_exact():
    rng = np.random.default_rng(4)
    b, c = 3, 48
    old_key = _keys(rng, b, c)
    new_key = _keys(rng, b, c, hits_from=old_key)
    lam = rng.normal(size=(b, c, 3)).astype(np.float32)
    cache = warmstart.WarmCache(key=torch.from_numpy(old_key),
                                lam=torch.from_numpy(lam))
    contacts = type("C", (), {"key": torch.from_numpy(new_key)})
    got = warmstart.match_lam(cache, contacts).numpy()

    def jax_match(k_old, l_old, k_new):
        jc = jax_warmstart.WarmCache(key=k_old, lam=l_old)
        zero = jnp.zeros(k_new.shape)
        contacts_j = JaxContacts(
            point=jnp.zeros(k_new.shape + (3,)),
            normal=jnp.zeros(k_new.shape + (3,)), depth=zero,
            a=jnp.zeros(k_new.shape, jnp.int32),
            b=jnp.zeros(k_new.shape, jnp.int32),
            valid=k_new >= 0, count=jnp.int32(0), overflow=jnp.int32(0),
            key=k_new)
        return jax_warmstart.match_lam(jc, contacts_j)

    ref = np.asarray(jax.vmap(jax_match)(jnp.asarray(old_key),
                                         jnp.asarray(lam),
                                         jnp.asarray(new_key)))
    assert np.array_equal(got, ref)
    for w in range(b):                    # and against a plain loop
        where = {int(k): i for i, k in enumerate(old_key[w]) if k >= 0}
        for j, k in enumerate(new_key[w]):
            want = lam[w, where[k]] if k >= 0 and k in where else 0.0
            assert np.array_equal(got[w, j], np.broadcast_to(want, (3,)))
    assert (got != 0).any()


def test_init_cache_and_bridge():
    cfg = EngineConfig(**STACK)
    cache = warmstart.init_cache(cfg, 2, dtype=torch.float64, device="cpu")
    assert cache.key.shape == (2, cfg.max_contacts)
    assert cache.key.dtype == torch.int32 and bool((cache.key == -1).all())
    assert cache.lam.shape == (2, cfg.max_contacts, 3)
    assert cache.lam.dtype == torch.float64
    jcache = jax_warmstart.init_cache(JaxConfig(**STACK))
    back = bridge.warmcache_from_numpy(to_numpy(jcache), device="cpu")
    assert back.key.shape == (1, cfg.max_contacts)
    assert np.array_equal(bridge.warmcache_to_numpy(back, 0)["key"],
                          np.asarray(jcache.key))


@pytest.mark.parametrize("kind", ["JACOBI", "PGS"])
def test_warm_step_matches_jax(kind):
    jcfg = JaxConfig(**STACK, solver=JaxSolverKind[kind])
    tcfg = EngineConfig(**STACK, solver=SolverKind[kind])
    arrays = settled_mini_stack()
    jbatch = jax_state(arrays)
    b = arrays["pos"].shape[0]
    jcache = jax.vmap(lambda _: jax_warmstart.init_cache(jcfg))(
        jnp.arange(b))
    tbatch = bridge.world_from_numpy(arrays, device="cpu")
    tcache = warmstart.init_cache(tcfg, b, device="cpu")
    jstep = jax.jit(jax.vmap(jax_warmstart.make_warm_step_fn(jcfg)))
    tstep = warmstart.make_warm_step_fn(tcfg)
    for _ in range(SUBSTEPS):
        jbatch, jcache = jstep(jbatch, jcache)
        tbatch, tcache = tstep(tbatch, tcache)
    ref, got = to_numpy(jbatch), bridge.world_to_numpy(tbatch)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[name], ref[name]), name
    jc = to_numpy(jcache)
    tc = bridge.warmcache_to_numpy(tcache)
    assert np.array_equal(tc["key"], jc["key"])
    assert (jc["key"] >= 0).sum() >= 8               # contacts persisted
    np.testing.assert_allclose(tc["lam"], jc["lam"], atol=ATOL, rtol=0)


def test_warm_start_impulse_error_at_two_iterations():
    """``tests/test_warmstart.py``'s starved-budget check in the port: the
    JAX package settles the scene, then the port warm-steps 8 substeps at 2
    iterations and solves one substep's contacts cold, warm and at 400
    iterations."""
    cfg_kw = dict(max_bodies=16, max_pair_candidates=64, max_contacts=64)
    jcfg = JaxConfig(**cfg_kw, solver=JaxSolverKind.JACOBI)
    w = jax_make_step_fn(jcfg, substeps=244, donate=False)(
        jax_scenes.bench_world(jcfg, num_bodies=10, seed=42))
    lo = EngineConfig(**cfg_kw, solver=SolverKind.JACOBI,
                      solver_iterations=2)
    state = bridge.world_from_numpy(to_numpy(w), device="cpu")
    cache = warmstart.init_cache(lo, 1, device="cpu")
    warm_fn = warmstart.make_warm_step_fn(lo)
    for _ in range(8):
        state, cache = warm_fn(state, cache)

    contacts = narrowphase.narrowphase(
        state, broadphase.broadphase(state, lo), lo)
    assert int(contacts.count[0]) >= 6
    forced = integrator.apply_external_forces(state, lo)
    _, lam_star = solver.solve_jacobi(
        forced, contacts, lo.replace(solver_iterations=400), return_lam=True)
    _, lam_cold = solver.solve_jacobi(forced, contacts, lo, return_lam=True)
    lam0 = warmstart.match_lam(cache, contacts)
    _, lam_warm = solver.solve_jacobi(forced, contacts, lo, lam0=lam0,
                                      return_lam=True)
    e_cold = float((lam_cold - lam_star).abs().max())
    e_warm = float((lam_warm - lam_star).abs().max())
    assert e_warm < e_cold, (e_cold, e_warm)


@pytest.mark.parametrize("kind", ["JACOBI", "PGS"])
def test_warm_step_in_float64(kind):
    """A float64 world warm-steps from a cache made with the default
    float32 impulses: the cached impulses join the solve in float64, and
    the refreshed cache holds float64 impulses."""
    tcfg = EngineConfig(**STACK, solver=SolverKind[kind], dtype="float64")
    arrays = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
              for k, v in settled_mini_stack().items()}
    state = bridge.world_from_numpy(arrays, device="cpu")
    cache = warmstart.init_cache(tcfg, 2, device="cpu")
    step = warmstart.make_warm_step_fn(tcfg)
    for _ in range(3):
        state, cache = step(state, cache)
    assert state.pos.dtype == cache.lam.dtype == torch.float64
    assert bool(torch.isfinite(state.pos).all())
    assert bool((cache.key >= 0).any()) and bool((cache.lam != 0).any())
