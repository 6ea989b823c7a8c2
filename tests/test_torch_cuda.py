"""The port's kernels and steps on the card, held to their plain versions.

This file imports neither JAX's engine package nor anything that needs it,
so it runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The tests marked ``cuda`` skip where no card is present. The others run
everywhere: the compaction's plain version against a numpy loop, and the
mesh kernels' wrappers taking their plain versions on CPU tensors.
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


def _bumpy_mesh(device, n=12, size=6.0):
    """A heightfield of 2·n² triangles, padded to a multiple of 128."""
    from rl_ode_physics_tpu_torch.ops.trimesh import build_trimesh
    xs = np.linspace(-size / 2, size / 2, n + 1)
    verts = np.array([[x, 0.3 * np.sin(x) * np.cos(z), z]
                      for z in xs for x in xs])
    tris = [[r * (n + 1) + c + d for d in ds] for r in range(n)
            for c in range(n) for ds in ((0, 1, n + 1), (1, n + 2, n + 1))]
    return verts, build_trimesh(verts, tris, pad_to_multiple=128,
                                device=device)


@pytest.mark.cuda
def test_mesh_kernels_equal_plain_versions_on_card():
    """Both distance kernels equal their plain versions bit for bit (the
    library is built with -fmad=false), one launch each per call."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    _, mesh = _bumpy_mesh("cuda")
    tris = mesh.transposed()
    rng = np.random.default_rng(3)
    probes = torch.from_numpy(rng.uniform(
        [-3.5, -0.5, -3.5], [3.5, 1.5, 3.5], size=(1000, 3)).astype(
            np.float32)).cuda()
    before = mesh_kernels.sphere_mesh_d2_tiles.launches
    got = mesh_kernels.sphere_mesh_d2_tiles(probes, *tris)
    assert mesh_kernels.sphere_mesh_d2_tiles.launches == before + 1
    assert torch.equal(got, trimesh.sphere_mesh_d2_tiles_plain(probes, *tris))
    for c in probes[:16]:
        before = mesh_kernels.sphere_mesh_d2.launches
        got = mesh_kernels.sphere_mesh_d2(c.contiguous(), *tris)
        assert mesh_kernels.sphere_mesh_d2.launches == before + 1
        assert torch.equal(got, trimesh.sphere_mesh_d2_plain(c, *tris))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_mesh_step_matches_cpu_step():
    """Spheres and boxes on a bumpy mesh in 2 worlds, settled 60 substeps
    on the CPU, then 8 substeps on each device: atol 1e-4, tick and
    overflow exact."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    config = EngineConfig.throughput(
        max_bodies=16, max_pair_candidates=64, max_contacts=128,
        enable_planes=False, enable_capsules=False, pallas_compaction=True)
    b = WorldBuilder(config, 0)
    slot = b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    b.body_type[slot] = int(BodyType.TRIMESH)
    rng = np.random.default_rng(4)
    for j in range(8):
        pos = (rng.uniform(-2.0, 2.0), rng.uniform(0.6, 1.2),
               rng.uniform(-2.0, 2.0))
        if j % 2:
            b.add_body(BodyType.SPHERE, pos, (0.25, 0.0, 0.0))
        else:
            b.add_body(BodyType.BOX, pos, (0.5, 0.3, 0.4))
    _, mesh = _bumpy_mesh("cpu")
    mesh.slot = slot
    start = make_batched_step_fn(config, substeps=60, device="cpu",
                                 trimesh=mesh)(
        replicate(b.finish("cpu"), 2, device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu",
                               trimesh=mesh)(start)
    card_start = type(start)(**{k: v.cuda() for k, v in vars(start).items()})
    card = make_batched_step_fn(config, substeps=8, device="cuda",
                                trimesh=mesh.to("cuda"))(card_start)
    for name in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
        assert float(diff) <= 1e-4, name
    for name in ("tick", "overflow"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))


def test_mesh_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    _, mesh = _bumpy_mesh("cpu", n=4)
    tris = mesh.transposed()
    probes = torch.tensor([[0.1, 0.5, 0.2], [1.0, 2.0, -1.0]])
    before = (mesh_kernels.sphere_mesh_d2_tiles.launches,
              mesh_kernels.sphere_mesh_d2.launches)
    assert torch.equal(mesh_kernels.sphere_mesh_d2_tiles(probes, *tris),
                       trimesh.sphere_mesh_d2_tiles_plain(probes, *tris))
    assert torch.equal(mesh_kernels.sphere_mesh_d2(probes[0], *tris),
                       trimesh.sphere_mesh_d2_plain(probes[0], *tris))
    assert before == (mesh_kernels.sphere_mesh_d2_tiles.launches,
                      mesh_kernels.sphere_mesh_d2.launches)
