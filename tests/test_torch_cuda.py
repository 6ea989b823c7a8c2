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


# shapes off the kernel's fast path: (B, D, M, k)
OFF_PATH_SHAPES = {
    "M_not_multiple_of_16": (3, 10, 100, 64),
    "M_over_512": (3, 10, 1000, 64),
    "M_over_512_unaligned": (2, 4, 1037, 96),
    "k_not_multiple_of_32": (3, 10, 384, 50),
    "k_over_M": (2, 10, 48, 64),
    "D_not_10": (3, 7, 384, 64),
    "one_row": (5, 1, 384, 32),
    "one_world": (1, 10, 384, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("sel", list(SEL))
@pytest.mark.parametrize("shape", list(OFF_PATH_SHAPES))
def test_kernel_equals_plain_version_off_the_fast_path(shape, sel):
    """Mask rows that are not whole 16-byte words, rows longer than one
    512-byte chunk, k off the warp's width, D off the unrolled 10, a single
    world: still exactly the plain version, overflow included."""
    _require_card()
    b, d, m, k = OFF_PATH_SHAPES[shape]
    rng = np.random.default_rng(17)
    for density in DENSITIES:
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < density)
        payload = torch.from_numpy(
            rng.normal(size=(b, d, m)).astype(np.float32))
        got = compaction_kernel.compact_rows_t(mask.cuda(), payload.cuda(),
                                               k, SEL[sel])
        ref = compaction.compact_rows_t(mask, payload, k, SEL[sel])
        torch.cuda.synchronize()
        for name, r, g in zip(("rows_t", "valid", "count", "overflow"), ref,
                              got):
            assert torch.equal(r, g.cpu()), (name, density)


@pytest.mark.cuda
def test_kernel_takes_a_mask_that_is_not_16_byte_aligned():
    """A mask that starts off a 16-byte boundary (a row view of a larger
    tensor made contiguous keeps its alignment; a byte offset does not)."""
    _require_card()
    rng = np.random.default_rng(19)
    mask = torch.from_numpy(rng.uniform(size=(B, M)) < 0.3)
    payload = torch.from_numpy(rng.normal(size=(B, D, M)).astype(np.float32))
    shifted = torch.zeros(B * M + 1, dtype=torch.bool, device="cuda")[1:]
    shifted = shifted.view(B, M)
    shifted.copy_(mask)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    got = compaction_kernel.compact_rows_t(shifted, payload.cuda(), K, None)
    ref = compaction.compact_rows_t(mask, payload, K, None)
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
def test_mesh_kernels_match_plain_versions_on_card():
    """Both distance kernels match their plain versions within the stated
    tolerance (they fuse multiply-adds and take their reciprocals once per
    triangle, so they round otherwise), one launch each per call; the 8
    nearest tiles of every probe are the plain version's as a set; a NaN
    probe gives a NaN row."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    rtol, atol = mesh_kernels.D2_RTOL, mesh_kernels.D2_ATOL
    assert (rtol, atol) == (1e-5, 1e-6)
    _, mesh = _bumpy_mesh("cuda", n=24)     # 1,152 triangles, 9 tiles
    tris = mesh.transposed()
    rng = np.random.default_rng(3)
    probes = torch.from_numpy(rng.uniform(
        [-3.5, -0.5, -3.5], [3.5, 1.5, 3.5], size=(1000, 3)).astype(
            np.float32)).cuda()
    before = mesh_kernels.sphere_mesh_d2_tiles.launches
    got = mesh_kernels.sphere_mesh_d2_tiles(probes, *tris)
    assert mesh_kernels.sphere_mesh_d2_tiles.launches == before + 1
    ref = trimesh.sphere_mesh_d2_tiles_plain(probes, *tris)
    assert torch.allclose(got, ref, rtol=rtol, atol=atol)
    near = [trimesh._top_k_smallest(x, trimesh.CAND_TILES).sort(-1).values
            for x in (got, ref)]
    assert torch.equal(*near)
    for c in probes[:16]:
        before = mesh_kernels.sphere_mesh_d2.launches
        got = mesh_kernels.sphere_mesh_d2(c.contiguous(), *tris)
        assert mesh_kernels.sphere_mesh_d2.launches == before + 1
        assert torch.allclose(got, trimesh.sphere_mesh_d2_plain(c, *tris),
                              rtol=rtol, atol=atol)
    bad = probes[:3].clone()
    bad[1, 2] = float("nan")
    got = mesh_kernels.sphere_mesh_d2_tiles(bad, *tris)
    ref = trimesh.sphere_mesh_d2_tiles_plain(bad, *tris)
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(ref[1]).all())
    assert torch.allclose(got, ref, rtol=rtol, atol=atol, equal_nan=True)
    assert bool(torch.isnan(
        mesh_kernels.sphere_mesh_d2(bad[1].contiguous(), *tris)).all())
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
