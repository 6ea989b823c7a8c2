"""Shared helpers for the tests that hold the PyTorch port to the JAX
package: the small bench-shaped configuration on both sides, and JAX
pytrees read out as numpy arrays for ``rl_ode_physics_tpu_torch.utils.bridge``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig

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


def configs(**overrides):
    """(JAX config, port config) of the small throughput configuration."""
    kw = dict(SMALL, **overrides)
    return JaxConfig.throughput(**kw), TorchConfig.throughput(**kw)


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
