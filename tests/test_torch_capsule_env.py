"""The port's RL env on a capsule scene, and the ported scenes, against
the JAX package.

Env: ``mini_stack_world`` settled 48 JAX substeps (``_torch_port``), 2
control steps of ``PhysicsEnv`` under the throughput policy with a lidar
that hits the player capsule: observations, lidar and state within 1e-4,
tick, overflow and rng_state exact. Scenes: every ported builder field for
field, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.models.env import PhysicsEnv as JaxEnv
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.models.env import PhysicsEnv
from rl_ode_physics_tpu_torch.ops.raycast import raycast
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import STACK, jax_state, settled_mini_stack, to_numpy

ATOL = 1e-4


# ---------------------------------------------------------------------------
# The RL env on a capsule scene
# ---------------------------------------------------------------------------

ACTORS = [4, 5]                     # the two spheres
RAYS = 8


def _lidar_dirs():
    ang = np.linspace(0, 2 * np.pi, RAYS, endpoint=False)
    # tilted up: the +x ray of sphere 4 meets the player capsule
    return np.stack([np.cos(ang), np.full(RAYS, 0.3), np.sin(ang)],
                    -1).astype(np.float32)


def test_env_rollout_with_capsule_lidar_matches_jax():
    jcfg, tcfg = JaxConfig.throughput(**STACK), TorchConfig.throughput(**STACK)
    kw = dict(actor_slots=ACTORS, num_worlds=2, substeps=2,
              lidar_dirs=_lidar_dirs(), lidar_range=10.0)
    jenv = JaxEnv(jcfg, lambda c, s: jax_scenes.mini_stack_world(c), **kw)
    tenv = PhysicsEnv(tcfg, lambda c, s: scenes.mini_stack_world(
        c, device="cpu"), device="cpu", **kw)
    arrays = settled_mini_stack()
    acts = (0.5 * np.random.default_rng(3).normal(size=(2, 2, 2, 6))
            ).astype(np.float32)
    jfinal, (jtraj, jlid) = jenv.rollout(jax_state(arrays), jnp.asarray(acts))
    tfinal, (ttraj, tlid) = tenv.rollout(
        bridge.world_from_numpy(arrays, device="cpu"), torch.from_numpy(acts))
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tlid.numpy(), np.asarray(jlid), atol=ATOL,
                               rtol=0)
    ref, got = to_numpy(jfinal), bridge.world_to_numpy(tfinal)
    for field in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[field], ref[field], atol=ATOL, rtol=0)
    for field in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[field], ref[field]), field

    # the lidar's rays hit the player capsule (slot 7)
    dirs = torch.from_numpy(_lidar_dirs())
    origins = tfinal.pos[:, ACTORS][:, :, None, :].expand(2, 2, RAYS, 3)
    hits = raycast(tfinal, origins.reshape(2, -1, 3),
                   dirs.expand(2, 2, RAYS, 3).reshape(2, -1, 3), tcfg,
                   max_dist=10.0)
    assert (hits.body == 7).any()


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

SCENES = {
    "sphere_drop_world": dict(),
    "stack_world": dict(num_bodies=20, seed=5),
    "capsule_stack_world": dict(num_bodies=64, seed=7),
    "capsule_pile_world": dict(),
    "mini_stack_world": dict(),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_matches_jax(name):
    kw = dict(max_bodies=68, max_pair_candidates=64, max_contacts=64)
    ref = to_numpy(getattr(jax_scenes, name)(JaxConfig(**kw), **SCENES[name]))
    got = bridge.world_to_numpy(getattr(scenes, name)(
        TorchConfig(**kw), device="cpu", **SCENES[name]), 0)
    for field, r in ref.items():
        assert got[field].dtype == r.dtype, field
        assert np.array_equal(got[field], r), field
