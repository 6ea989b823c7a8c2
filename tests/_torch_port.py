"""Shared helpers for the tests that hold the PyTorch port to the JAX
package: the small bench-shaped configuration on both sides, and JAX
pytrees read out as numpy arrays for ``rl_ode_physics_tpu_torch.utils.bridge``.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.core.config import SolverKind as TorchSolverKind

from _threads import single_cpu_thread  # noqa: F401  (re-exported)

# 16 slots (12 bodies + the 4 arena geoms) with the bench's capacities as
# bench._bucket_caps(16) and max_contacts=32 give them: throughput policy,
# spheres and boxes, bf16 selectors (<= 256 slots)
SMALL = dict(
    max_bodies=16,
    max_pair_candidates=64,
    max_contacts=32,
    max_contacts_per_pair=4,
    enable_capsules=False,
    enable_planes=False,
    solver_matmul_dtype="float32",
    bucket_caps=((1, 1, 32), (1, 2, 32), (2, 2, 16)),
    pallas_compaction=True,
)
SMALL_BODIES = 12


# the JAX side's subprocesses: XLA and LAPACK on one thread, for the same
# reason (a float64 DANTZIG trajectory took 90 s instead of 10)
SUBPROCESS_ENV = dict(
    os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
    MKL_NUM_THREADS="1",
    XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_multi_thread_eigen=false"
               " intra_op_parallelism_threads=1").strip())


def configs(**overrides):
    """(JAX config, port config) of the small throughput configuration; a
    ``solver`` of either package's ``SolverKind`` is given to each side as
    its own."""
    kw = dict(SMALL, **overrides)
    jkw = dict(kw)
    if "solver" in kw:
        jkw["solver"] = JaxSolverKind(kw["solver"].value)
        kw["solver"] = TorchSolverKind(kw["solver"].value)
    return JaxConfig.throughput(**jkw), TorchConfig.throughput(**kw)


def to_numpy(obj) -> dict:
    """A JAX struct dataclass as {field: numpy array}."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@functools.lru_cache(maxsize=1)
def _jax_step():
    jcfg, _ = configs()
    return jax_make_step_fn(jcfg, substeps=1, donate=False)


@functools.lru_cache(maxsize=None)
def settled_state(substeps: int = 30):
    """The small JAX bench world after ``substeps`` JAX substeps of the
    small throughput configuration, as numpy arrays (not to be modified):
    the first impacts at 30, resting stacks with sphere-sphere, sphere-box
    and box-box contacts later."""
    if substeps <= 30:
        jcfg, _ = configs()
        state = jax_scenes.bench_world(jcfg, num_bodies=SMALL_BODIES)
        done = 0
    else:
        state = JaxWorldState(**{k: jnp.asarray(v) for k, v in
                                 settled_state(30).items()})
        done = 30
    step = _jax_step()
    for _ in range(substeps - done):
        state = step(state)
    jax.block_until_ready(state.pos)
    return to_numpy(state)


# 32 slots with capsules and planes enabled: the classic pipeline's
# defaults (K=8, JACOBI 20 iterations) at the capacities of a 25-body pile
PILE = dict(max_bodies=32, max_pair_candidates=160, max_contacts=320)


def mixed_pile(builder_cls, cfg, seed=0):
    """A contact-rich random pile on a builder class of either package: a
    40x1x40 floor box and 24 boxes, spheres and capsules in random poses
    (the pile of ``tests/test_narrowphase_cm.py``)."""
    rng = np.random.default_rng(seed)
    b = builder_cls(cfg, 0)
    b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (40.0, 1.0, 40.0))
    for i in range(24):
        kind = (2, 1, 3)[i % 3]
        pos = (float(rng.uniform(-2, 2)), float(rng.uniform(0.8, 3.0)),
               float(rng.uniform(-2, 2)))
        q = rng.normal(size=4)
        q = tuple(q / np.linalg.norm(q))
        if kind == 1:
            size = (float(rng.uniform(0.2, 0.5)), 0.0, 0.0)
        elif kind == 2:
            size = tuple(float(rng.uniform(0.3, 0.9)) for _ in range(3))
        else:
            size = (float(rng.uniform(0.15, 0.3)),
                    float(rng.uniform(0.4, 1.0)), 0.0)
        b.add_body(kind, pos, size, quat=q)
    return b


@functools.lru_cache(maxsize=None)
def settled_pile(substeps: int = 60, seed: int = 0):
    """``mixed_pile`` after ``substeps`` substeps of the JAX classic step
    (``EngineConfig(**PILE)``), as numpy arrays (not to be modified)."""
    from rl_ode_physics_tpu.models.builder import WorldBuilder
    cfg = JaxConfig(**PILE)
    state = mixed_pile(WorldBuilder, cfg, seed).finish()
    state = jax_make_step_fn(cfg, substeps=substeps, donate=False)(state)
    jax.block_until_ready(state.pos)
    return to_numpy(state)


def jax_state(arrays) -> JaxWorldState:
    """numpy arrays → a JAX WorldState."""
    return JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def compare_contacts(ref, got, graze=1e-5):
    """JAX Contacts against the port's world 0: keys, body ids, counts and
    overflow exact, geometry within 1e-5. Where a grazing row (|depth| <
    ``graze``) is valid on one side only, the rows are compared as sets
    keyed by ``key`` instead (the other rows' positions shift)."""
    ref = to_numpy(ref)
    from rl_ode_physics_tpu_torch.utils import bridge
    got = bridge.contacts_to_numpy(got, 0)
    assert int(got["overflow"]) == int(ref["overflow"])
    same_rows = all(np.array_equal(got[n], ref[n])
                    for n in ("a", "b", "valid", "key", "count"))
    if same_rows:
        v = ref["valid"]
        for name in ("point", "normal", "depth"):
            np.testing.assert_allclose(got[name][v], ref[name][v], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        return ref
    sets = []
    for side in (ref, got):
        rows = np.nonzero(side["valid"])[0]
        sets.append({int(side["key"][i]): (side["point"][i],
                                           side["normal"][i],
                                           float(side["depth"][i]),
                                           int(side["a"][i]),
                                           int(side["b"][i]))
                     for i in rows})
    for key in set(sets[0]) ^ set(sets[1]):
        dep = (sets[0].get(key) or sets[1].get(key))[2]
        assert abs(dep) < graze, (key, dep)
    for key in set(sets[0]) & set(sets[1]):
        r, g = sets[0][key], sets[1][key]
        assert r[3:] == g[3:], key
        for x, y in zip(r[:3], g[:3]):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)
    return ref


# mini_stack_world's slots with room to spare, the capacities of the
# pipeline steps compared in test_torch_pipelines.py
STACK = dict(max_bodies=12, max_pair_candidates=64, max_contacts=128)
MINI_SETTLE = 48


@functools.lru_cache(maxsize=1)
def settled_mini_stack():
    """mini_stack_world after 48 substeps of the JAX classic step
    (``EngineConfig(**STACK)``), in 2 worlds whose velocities are kicked
    differently, as numpy arrays (not to be modified)."""
    from rl_ode_physics_tpu.parallel.batch import replicate
    cfg = JaxConfig(**STACK)
    state = jax_make_step_fn(cfg, substeps=MINI_SETTLE, donate=False)(
        jax_scenes.mini_stack_world(cfg))
    batch = to_numpy(replicate(state, 2))
    rng = np.random.default_rng(9)
    dyn = batch["inv_mass"] > 0
    kick = rng.normal(scale=0.05, size=batch["linvel"].shape)
    batch["linvel"] = (batch["linvel"]
                       + np.where(dyn[..., None], kick, 0)).astype(np.float32)
    return batch
