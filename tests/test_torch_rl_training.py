"""The port's ES trainer (``examples/rl_training.py``) against the JAX
trainer, sharded against unsharded, and its learning curve.

The port is fed the noise that the JAX trainer draws from its key (the
trainer's own split and normal, times sigma) and must give the JAX
trainer's parameters and mean reward at rtol 1e-4, atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from examples.rl_training import make_trainer as jax_make_trainer
from rl_ode_physics_tpu_torch.examples import rl_training
from rl_ode_physics_tpu_torch.parallel.mesh import make_mesh

from _torch_port import single_cpu_thread  # noqa: F401

POP, HORIZON, SIGMA = 12, 8, 0.1


def _jax_noise(key):
    """The noise ``examples/rl_training.py:train_step`` draws from
    ``key``, as numpy arrays."""
    kw, kb = jax.random.split(key)
    ew = jax.random.normal(kw, (POP, rl_training.OBS_DIM,
                                rl_training.ACT_DIM)) * SIGMA
    eb = jax.random.normal(kb, (POP, rl_training.ACT_DIM)) * SIGMA
    return np.array(ew), np.array(eb)


def test_train_step_matches_jax_trainer():
    jparams, jstep = jax_make_trainer(pop=POP, horizon=HORIZON, sigma=SIGMA)
    params, step = rl_training.make_trainer(pop=POP, horizon=HORIZON,
                                            sigma=SIGMA, device="cpu")
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        key, sub = jax.random.split(key)
        jparams, jr = jstep(jparams, sub)
        ew, eb = _jax_noise(sub)
        params, r = step.step_with_noise(params, torch.from_numpy(ew),
                                         torch.from_numpy(eb))
        np.testing.assert_allclose(float(r), float(jr), rtol=1e-4, atol=1e-5)
        for got, want in zip(params, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
    assert np.isfinite(float(r))


def test_sharded_train_step_matches_single_device():
    params_s, step_s = rl_training.make_trainer(pop=POP, horizon=HORIZON,
                                                device="cpu")
    mesh = make_mesh(["cpu"] * 4)
    params_m, step_m = rl_training.make_trainer(pop=POP, horizon=HORIZON,
                                                mesh=mesh)
    assert len(step_m.envs) == 4 and step_m.per_device == 2 * POP // 4
    gen_s, gen_m = (torch.Generator().manual_seed(0) for _ in range(2))
    for _ in range(2):
        params_s, r_s = step_s(params_s, gen_s)
        params_m, r_m = step_m(params_m, gen_m)
    # tests/test_sharded_training.py's tolerances
    np.testing.assert_allclose(float(r_s), float(r_m), rtol=1e-5, atol=1e-5)
    for a, b in zip(params_s, params_m):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    assert np.isfinite(float(r_m))


def test_uneven_population_split_raises():
    with pytest.raises(ValueError, match="evenly"):
        rl_training.make_trainer(pop=3, horizon=1,
                                 mesh=make_mesh(["cpu"] * 4))


@pytest.mark.slow
def test_es_training_improves_reward():
    """``tests/test_rl_training.py``'s check on the port."""
    params, train_step = rl_training.make_trainer(pop=12, horizon=25,
                                                  device="cpu")
    generator = torch.Generator().manual_seed(0)
    rewards = []
    for _ in range(6):
        params, mean_r = train_step(params, generator)
        rewards.append(float(mean_r))
    assert rewards[-1] > rewards[0] + 0.15, rewards
    assert rewards[-1] > -3.3, rewards
