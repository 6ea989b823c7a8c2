"""The port's contact compaction against the JAX package's.

``rl_ode_physics_tpu_torch.ops.compaction.compact_rows_t`` (the plain
version of the Hopper kernel) must equal the JAX selection matmul
``compact_rows_t`` and the Pallas kernel ``compact_rows_t_pallas`` (run in
interpret mode) exactly, at the bench's shapes (D=10, M=384, k=64), at both
selector dtypes, from an empty mask to a full one (the overflow case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.ops.compaction import compact_rows_t as jax_compact
from rl_ode_physics_tpu.ops.compaction_pallas import compact_rows_t_pallas
from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel

B, D, M, K = 3, 10, 384, 64
DENSITIES = (0.0, 0.15, 0.5, 1.0)
SEL = {None: None, "bfloat16": torch.bfloat16}


def _inputs(density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(B, M)) < density
    payload = rng.normal(size=(B, D, M)).astype(np.float32)
    # integer columns like the contact payload's body ids and slots
    payload[:, 7:10] = rng.integers(0, 64, size=(B, 3, M))
    return mask, payload


def _port(mask, payload, sel):
    out = compaction.compact_rows_t(torch.from_numpy(mask),
                                    torch.from_numpy(payload), K,
                                    sel_dtype=SEL[sel])
    return [t.numpy() for t in out]


@pytest.mark.parametrize("sel", list(SEL))
@pytest.mark.parametrize("density", DENSITIES)
def test_compact_rows_t_equals_jax_matmul(density, sel):
    mask, payload = _inputs(density, seed=int(density * 100) + 1)
    fn = jax.jit(jax.vmap(lambda m, p: jax_compact(m, p, K, sel_dtype=sel)))
    ref = [np.asarray(r) for r in fn(jnp.asarray(mask), jnp.asarray(payload))]
    got = _port(mask, payload, sel)
    for name, r, g in zip(("rows_t", "valid", "count", "overflow"), ref, got):
        assert r.shape == g.shape, name
        assert np.array_equal(r, g), name
    if density == 1.0:
        assert (got[3] == M - K).all()          # the overflow case


@pytest.mark.parametrize("sel", list(SEL))
@pytest.mark.parametrize("density", (0.0, 0.15, 1.0))
def test_compact_rows_t_equals_pallas_interpret(density, sel):
    mask, payload = _inputs(density, seed=7)
    got = _port(mask, payload, sel)
    for w in range(B):
        ref = compact_rows_t_pallas(jnp.asarray(mask[w]),
                                    jnp.asarray(payload[w]), K,
                                    sel_dtype=sel, interpret=True)
        for r, g in zip(ref, got):
            assert np.array_equal(np.asarray(r), g[w])


def test_wrapper_runs_plain_version_on_cpu_without_launch():
    mask, payload = _inputs(0.15, seed=3)
    before = compaction_kernel.compact_rows_t.launches
    out = compaction_kernel.compact_rows_t(
        torch.from_numpy(mask), torch.from_numpy(payload), K,
        sel_dtype=torch.bfloat16)
    ref = _port(mask, payload, "bfloat16")
    for r, g in zip(ref, out):
        assert np.array_equal(r, g.numpy())
    assert compaction_kernel.compact_rows_t.launches == before


def test_wrapper_rejects_non_cuda_devices():
    mask = torch.zeros((B, M), dtype=torch.bool, device="meta")
    payload = torch.zeros((B, D, M), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        compaction_kernel.compact_rows_t(mask, payload, K)
