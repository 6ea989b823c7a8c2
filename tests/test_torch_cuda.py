"""The port's kernels and step on the card, held to their plain versions.

This file imports neither JAX's engine package nor anything that needs it,
so it runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The tests marked ``cuda`` skip where no card is present. The others hold
the kernel's plain version to a numpy loop and run everywhere.
"""

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch.core.config import bench_config
from rl_ode_physics_tpu_torch.models.scenes import bench_world
from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel
from rl_ode_physics_tpu_torch.parallel.batch import (
    make_batched_step_fn, replicate)

B, D, M, K = 4, 10, 384, 64
DENSITIES = (0.0, 0.15, 0.5, 1.0)
SEL = {"float32": None, "bfloat16": torch.bfloat16}


def _inputs(density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(B, M)) < density
    payload = rng.normal(size=(B, D, M)).astype(np.float32)
    return mask, payload


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")


@pytest.mark.parametrize("sel", list(SEL))
@pytest.mark.parametrize("density", DENSITIES)
def test_plain_compaction_matches_numpy_loop(density, sel):
    mask, payload = _inputs(density, seed=21)
    rows, valid, count, overflow = compaction.compact_rows_t(
        torch.from_numpy(mask), torch.from_numpy(payload), K, SEL[sel])
    for w in range(B):
        src = payload[w]
        if sel == "bfloat16":
            src = torch.from_numpy(src).to(torch.bfloat16).float().numpy()
        kept = np.flatnonzero(mask[w])
        ref = np.zeros((D, K), np.float32)
        ref[:, :min(len(kept), K)] = src[:, kept[:K]]
        assert np.array_equal(rows[w].numpy(), ref)
        assert int(count[w]) == min(len(kept), K)
        assert int(overflow[w]) == max(len(kept) - K, 0)
        assert np.array_equal(valid[w].numpy(), np.arange(K) < len(kept))


@pytest.mark.cuda
@pytest.mark.parametrize("sel", list(SEL))
def test_kernel_equals_plain_version_on_card(sel):
    _require_card()
    for density in DENSITIES:
        mask, payload = _inputs(density, seed=11)
        mask_c = torch.from_numpy(mask).cuda()
        payload_c = torch.from_numpy(payload).cuda()
        before = compaction_kernel.compact_rows_t.launches
        got = compaction_kernel.compact_rows_t(mask_c, payload_c, K,
                                               SEL[sel])
        assert compaction_kernel.compact_rows_t.launches == before + 1
        ref = compaction.compact_rows_t(torch.from_numpy(mask),
                                        torch.from_numpy(payload), K,
                                        SEL[sel])
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            assert torch.equal(r, g.cpu())


@pytest.mark.cuda
def test_card_step_matches_cpu_step():
    """The bench configuration in 2 worlds, settled 40 substeps on the CPU,
    then 8 substeps on each device: atol 1e-4, tick and overflow exact."""
    _require_card()
    config = bench_config(64)
    start = make_batched_step_fn(config, substeps=40, device="cpu")(
        replicate(bench_world(config, device="cpu"), 2, device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu")(start)
    card_start = type(start)(**{k: v.cuda() for k, v in vars(start).items()})
    card = make_batched_step_fn(config, substeps=8, device="cuda")(card_start)
    for name in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
        assert float(diff) <= 1e-4, name
    for name in ("tick", "overflow"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
