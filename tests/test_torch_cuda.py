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
    for c in probes[:16]:                   # C = 1 through the (3,) form
        before = mesh_kernels.sphere_mesh_d2.launches
        got = mesh_kernels.sphere_mesh_d2(c.contiguous(), *tris)
        assert mesh_kernels.sphere_mesh_d2.launches == before + 1
        assert got.shape == (9, 128)
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
@pytest.mark.parametrize("count", [1, 15, 64, 77, 1000, 15360])
def test_batched_d2_kernel_matches_plain_version_on_card(count):
    """(C, 3) centres in one launch whatever C is: a group of centres per
    block at wide queries, a C that is no multiple of the group, one centre
    per block at narrow ones; a NaN centre gives a NaN row and leaves the
    others alone."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    rtol, atol = mesh_kernels.D2_RTOL, mesh_kernels.D2_ATOL
    _, mesh = _bumpy_mesh("cuda", n=24)     # 1,152 triangles, 9 tiles
    tris = mesh.transposed()
    rng = np.random.default_rng(count)
    centers = torch.from_numpy(rng.uniform(
        [-3.5, -0.5, -3.5], [3.5, 1.5, 3.5], size=(count, 3)).astype(
            np.float32)).cuda()
    centers[count // 2, 1] = float("nan")
    before = mesh_kernels.sphere_mesh_d2.launches
    got = mesh_kernels.sphere_mesh_d2(centers, *tris)
    assert mesh_kernels.sphere_mesh_d2.launches == before + 1
    ref = trimesh.sphere_mesh_d2_plain(centers, *tris)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (count, 9, 128)
    assert bool(torch.isnan(got[count // 2]).all())
    assert int(torch.isnan(got).any(-1).any(-1).sum()) == 1
    assert torch.allclose(got, ref, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.cuda
def test_sphere_mesh_contacts_is_one_launch_on_card():
    """A query of 15 centres launches the kernel once and gives the CPU's
    contacts: the same tiles and validity, geometry at atol 1e-5."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    _, mesh = _bumpy_mesh("cpu", n=24)
    rng = np.random.default_rng(5)
    centers = torch.from_numpy(rng.uniform(
        [-3.0, -0.1, -3.0], [3.0, 0.5, 3.0], size=(15, 3)).astype(np.float32))
    ref = trimesh.sphere_mesh_contacts(centers, 0.4, mesh, k=4)
    before = mesh_kernels.sphere_mesh_d2.launches
    got = trimesh.sphere_mesh_contacts(centers.cuda(), 0.4, mesh.to("cuda"),
                                       k=4)
    assert mesh_kernels.sphere_mesh_d2.launches == before + 1
    valid = ref[3]
    assert torch.equal(got[3].cpu(), valid) and int(valid.sum()) >= 15
    for r, g in zip(ref[:3], got[:3]):
        assert torch.allclose(g.cpu()[valid], r[valid], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_card_rollout_matches_cpu_rollout():
    """``PhysicsEnv`` in 2 worlds of the rollout configuration, settled 40
    substeps on the CPU, then a 3-step rollout with seeded actions and a
    lidar on each device: atol 1e-4, tick and overflow exact."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import rollout_config
    from rl_ode_physics_tpu_torch.models.env import PhysicsEnv
    config = rollout_config(64)
    start = make_batched_step_fn(config, substeps=40, device="cpu")(
        replicate(bench_world(config, device="cpu"), 2, device="cpu"))
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    dirs = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    acts = torch.from_numpy(np.random.default_rng(2).normal(
        scale=0.5, size=(3, 2, 2, 6)).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        env = PhysicsEnv(config, lambda cfg, seed: bench_world(
            cfg, seed=seed, device=device), actor_slots=[4, 5], num_worlds=2,
            lidar_dirs=dirs, obs_slots=[4, 5], device=device)
        state = type(start)(**{k: v.to(device)
                               for k, v in vars(start).items()})
        out[device] = env.rollout(state, acts.to(device))
    (cpu, (cpu_obs, cpu_lidar)), (card, (obs, lidar)) = out["cpu"], out["cuda"]
    for name in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
        assert float(diff) <= 1e-4, name
    for name in ("tick", "overflow"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    assert float((obs.cpu() - cpu_obs).abs().max()) <= 1e-4
    assert float((lidar.cpu() - cpu_lidar).abs().max()) <= 1e-4


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
    batch = mesh_kernels.sphere_mesh_d2(probes, *tris)
    assert batch.shape == (2, 1, 128)
    assert torch.equal(batch[1], trimesh.sphere_mesh_d2_plain(probes[1],
                                                              *tris))
    assert before == (mesh_kernels.sphere_mesh_d2_tiles.launches,
                      mesh_kernels.sphere_mesh_d2.launches)


STACK = dict(max_bodies=12, max_pair_candidates=64, max_contacts=128)
PIPELINES = {"classic": dict(), "classic-exact-clip": dict(exact_box_clip=True),
             "typed-row-major": dict(typed_buckets=True, cm_narrowphase=False),
             "typed-sap": dict(typed_buckets=True, sap_window=6, sap_broad=2),
             "dense": dict(dense_pipeline=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PIPELINES))
def test_card_pipeline_step_matches_cpu_step(name):
    """``mini_stack_world`` (boxes, spheres, capsules) in 2 worlds through
    each pipeline, settled 48 substeps on the CPU, then 8 substeps on each
    device: atol 1e-4, tick and overflow exact."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import mini_stack_world
    config = EngineConfig(**STACK, **PIPELINES[name])
    start = make_batched_step_fn(config, substeps=48, device="cpu")(
        replicate(mini_stack_world(config, device="cpu"), 2, device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu")(start)
    card_start = type(start)(**{k: v.cuda() for k, v in vars(start).items()})
    card = make_batched_step_fn(config, substeps=8, device="cuda")(card_start)
    for field in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, field).cpu() - getattr(cpu, field)).abs().max()
        assert float(diff) <= 1e-4, field
    for field in ("tick", "overflow"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field))


@pytest.mark.cuda
def test_dense_batch_too_large_for_the_card_raises():
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import mini_stack_world
    config = EngineConfig(max_bodies=256, max_pair_candidates=64,
                          max_contacts=128, dense_pipeline=True)
    # 30 x 1024 x 256² x 8 x 12 bytes: 193 GB of intermediates
    batch = replicate(mini_stack_world(config, device="cuda"), 1024,
                      device="cuda")
    with pytest.raises(ValueError, match="chunk"):
        make_batched_step_fn(config, device="cuda")(batch)


# ---------------------------------------------------------------------------
# Any k and float64 through the kernels; the probe kernels; the conformance
# step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sel", ["none", "float32", "bfloat16"])
def test_plain_compaction_of_float64_matches_numpy_loop(sel):
    """The plain version keeps a float64 payload in float64; ``sel_dtype``
    rounds it first, to float32 or to bf16 through float32, as PyTorch's
    conversions do."""
    mask, payload = _inputs(0.3, seed=23)
    payload = payload.astype(np.float64) + 1e-10
    sel_dtype = {"none": None, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}[sel]
    rows, valid, count, overflow = compaction.compact_rows_t(
        torch.from_numpy(mask), torch.from_numpy(payload), K, sel_dtype)
    assert rows.dtype == torch.float64
    src = payload
    if sel == "float32":
        src = payload.astype(np.float32).astype(np.float64)
    elif sel == "bfloat16":
        src = torch.from_numpy(payload.astype(np.float32)).to(
            torch.bfloat16).double().numpy()
    for w in range(B):
        kept = np.flatnonzero(mask[w])
        ref = np.zeros((D, K))
        ref[:, :min(len(kept), K)] = src[w][:, kept[:K]]
        assert np.array_equal(rows[w].numpy(), ref)
        assert int(count[w]) == min(len(kept), K)


@pytest.mark.cuda
@pytest.mark.parametrize("sel", list(SEL))
@pytest.mark.parametrize("k", [1536, 1537, 2048, 4096, 5000])
def test_kernel_takes_any_k(k, sel):
    """Past the 1,536 columns that the index lists hold, each lane stores
    its kept columns at their rank: still exactly the plain version, at
    k = M = 4,096 and past it."""
    _require_card()
    rng = np.random.default_rng(k)
    b, d, m = 6, 10, 4096
    for density in (0.2, 0.5, 1.0):
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < density)
        payload = torch.from_numpy(
            rng.normal(size=(b, d, m)).astype(np.float32))
        before = compaction_kernel.compact_rows_t.launches
        got = compaction_kernel.compact_rows_t(mask.cuda(), payload.cuda(),
                                               k, SEL[sel])
        assert compaction_kernel.compact_rows_t.launches == before + 1
        ref = compaction.compact_rows_t(mask, payload, k, SEL[sel])
        torch.cuda.synchronize()
        for name, r, g in zip(("rows_t", "valid", "count", "overflow"), ref,
                              got):
            assert torch.equal(r, g.cpu()), (name, density)


@pytest.mark.cuda
@pytest.mark.parametrize("sel", ["none", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(B, D, M, K), (3, 7, 1000, 50),
                                   (2, 10, 4096, 2048)],
                         ids=["bench", "off-path", "wide-k"])
def test_kernel_takes_float64_bitwise(shape, sel):
    _require_card()
    sel_dtype = {"none": None, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}[sel]
    b, d, m, k = shape
    rng = np.random.default_rng(29)
    for density in DENSITIES:
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < density)
        payload = torch.from_numpy(rng.normal(size=(b, d, m)))
        got = compaction_kernel.compact_rows_t(mask.cuda(), payload.cuda(),
                                               k, sel_dtype)
        ref = compaction.compact_rows_t(mask, payload, k, sel_dtype)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.float64
        for name, r, g in zip(("rows_t", "valid", "count", "overflow"), ref,
                              got):
            assert torch.equal(r, g.cpu()), (name, density)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_other_dtypes_on_card():
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    mask = torch.ones((2, 16), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        compaction_kernel.compact_rows_t(
            mask, torch.zeros((2, 3, 16), dtype=torch.float16,
                              device="cuda"), 4)
    _, mesh = _bumpy_mesh("cuda", n=4)
    tris = [x.half() for x in mesh.transposed()]
    with pytest.raises(TypeError):
        mesh_kernels.sphere_mesh_d2_tiles(
            torch.zeros((4, 3), dtype=torch.float16, device="cuda"), *tris)
    with pytest.raises(TypeError):                 # mixed float32/float64
        mesh_kernels.sphere_mesh_d2(
            torch.zeros((4, 3), dtype=torch.float64, device="cuda"),
            *mesh.transposed())


@pytest.mark.cuda
def test_mesh_kernels_take_float64_on_card():
    """Both distance kernels in float64 against their plain versions at
    the stated float64 tolerance."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import mesh_kernels, trimesh
    rtol, atol = mesh_kernels.tolerance(torch.float64)
    assert (rtol, atol) == (1e-12, 1e-13)
    _, mesh = _bumpy_mesh("cuda", n=24)
    tris = [x.double().contiguous() for x in mesh.transposed()]
    rng = np.random.default_rng(31)
    probes = torch.from_numpy(rng.uniform(
        [-3.5, -0.5, -3.5], [3.5, 1.5, 3.5], size=(2000, 3))).cuda()
    before = (mesh_kernels.sphere_mesh_d2_tiles.launches,
              mesh_kernels.sphere_mesh_d2.launches)
    got = mesh_kernels.sphere_mesh_d2_tiles(probes, *tris)
    rows = mesh_kernels.sphere_mesh_d2(probes[:300].contiguous(), *tris)
    assert (mesh_kernels.sphere_mesh_d2_tiles.launches,
            mesh_kernels.sphere_mesh_d2.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert got.dtype == rows.dtype == torch.float64
    assert torch.allclose(got, trimesh.sphere_mesh_d2_tiles_plain(
        probes, *tris), rtol=rtol, atol=atol)
    assert torch.allclose(rows, trimesh.sphere_mesh_d2_plain(
        probes[:300], *tris), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_probe_kernels_match_plain_versions_on_card():
    """The multiply-then-add chain bit for bit; the (256, 256) chain, one
    cluster of 16 blocks, at A = 1, B = 1/16 bit for bit after 1, 2, 3, 7
    and 64 products (both buffers, many cluster barriers) and on random
    inputs at MATMUL_RTOL; the world products at 1, 2 and 3 trips on random
    and on the TPU probe's inputs by ``matmuls_agree``, which refuses a
    product 1% off in its first 64 columns."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import probe_kernels as pk
    from rl_ode_physics_tpu_torch.utils import device_probe as dp
    gen = torch.Generator(device="cuda").manual_seed(37)
    vel = torch.randn((8, pk.ROWS, pk.INNER), generator=gen, device="cuda")
    s = torch.randn((8, pk.INNER, pk.COLS), generator=gen, device="cuda")
    for v, w in ((vel, s), dp.matmuls_inputs()):
        off = w.clone()
        off[..., :pk.INNER] *= 1.01
        for trips in (1, 2, 3):
            before = pk.probe_matmuls.launches
            got = pk.probe_matmuls(v, w, trips)
            assert pk.probe_matmuls.launches == before + 1
            want = pk.probe_matmuls_plain(v, w, trips)
            assert pk.matmuls_agree(pk.matmuls_errors(v, got, want))
            assert not pk.matmuls_agree(pk.matmuls_errors(
                v, pk.probe_matmuls(v, off, trips), want))
    for n in (3 * pk.VPU_THREADS, 12 * pk.VPU_THREADS):
        x = 0.5 + torch.rand((n,), generator=gen, device="cuda")
        assert torch.equal(pk.probe_vpu(x, 5), pk.probe_vpu_plain(x, 5))
        fused = pk.probe_vpu(x, 5, fused=True)
        assert torch.allclose(fused, pk.probe_vpu_plain(x, 5), rtol=1e-5)
    cluster = pk.mxu_cluster_info()
    assert cluster["cluster"] == pk.MXU_CLUSTER
    assert cluster["max_active_clusters"] >= 1
    a, b = dp.mxu_inputs()
    for steps in (1, 2, 3, 7, 64):
        assert torch.equal(pk.probe_mxu(a, b, steps),
                           pk.probe_mxu_plain(a, b, steps))
    a = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda")
    b = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda") / 16
    got, ref = pk.probe_mxu(a, b, 3), pk.probe_mxu_plain(a, b, 3)
    assert torch.allclose(got, ref, rtol=pk.MATMUL_RTOL,
                          atol=pk.MATMUL_RTOL * float(ref.abs().max()))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["mini_stack", "ridge_mesh"])
def test_conformance_step_card_matches_cpu_in_float64(scene):
    """``EngineConfig.conformance`` in float64 (PGS, exact box clip, K=8),
    2 worlds settled on the CPU, then 8 substeps on each device: within
    1e-9, tick and overflow exact; the ridge mesh's probes go through the
    float64 tile kernel."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    config = EngineConfig.conformance(max_bodies=16, max_pair_candidates=128,
                                      max_contacts=256, dtype="float64")
    mesh = None
    if scene == "ridge_mesh":
        world, mesh = scenes.ridge_mesh_scene(config, device="cpu")
        settle = 60
    else:
        world, settle = scenes.mini_stack_world(config, device="cpu"), 40
    start = make_batched_step_fn(config, substeps=settle, device="cpu",
                                 trimesh=mesh)(replicate(world, 2,
                                                         device="cpu"))
    cpu = make_batched_step_fn(config, substeps=8, device="cpu",
                               trimesh=mesh)(start)
    card_start = type(start)(**{k: v.cuda() for k, v in vars(start).items()})
    before = mesh_kernels.sphere_mesh_d2_tiles.launches
    card = make_batched_step_fn(
        config, substeps=8, device="cuda",
        trimesh=None if mesh is None else mesh.to("cuda"))(card_start)
    torch.cuda.synchronize()
    assert mesh_kernels.sphere_mesh_d2_tiles.launches - before == (
        8 if mesh is not None else 0)
    assert card.pos.dtype == torch.float64
    for field in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(card, field).cpu() - getattr(cpu, field)).abs().max()
        assert float(diff) <= 1e-9, field
    for field in ("tick", "overflow"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field))


def _card_against_cpu(config, start, substeps=8, atol=1e-4, joints=None,
                      mesh=None):
    """``substeps`` substeps from a CPU batch on each device; raise unless
    pos/quat/linvel/angvel agree within ``atol`` and tick and overflow
    exactly. Returns the card's batch."""
    cpu = make_batched_step_fn(config, substeps=substeps, device="cpu",
                               joints=joints, trimesh=mesh)(start)
    card_start = type(start)(**{k: v.cuda() for k, v in vars(start).items()})
    card = make_batched_step_fn(
        config, substeps=substeps, device="cuda",
        joints=None if joints is None else joints.to("cuda"),
        trimesh=None if mesh is None else mesh.to("cuda"))(card_start)
    torch.cuda.synchronize()
    for field in ("pos", "quat", "linvel", "angvel"):
        want = getattr(cpu, field)
        diff = (getattr(card, field).cpu() - want).abs().max()
        tol = atol
        if (config.solver_matmul_dtype == "bfloat16"
                and field in ("linvel", "angvel")):
            # one bf16 spacing of the field: a float32 difference of one
            # spacing can carry a value across a bf16 rounding boundary
            tol = max(atol, 2.0 ** -8 * float(want.abs().max()))
        assert float(diff) <= tol, (field, float(diff), tol)
    for field in ("tick", "overflow"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field))
    return card


# tests/_traj_engine.py:make_cfg("dantzig"), by value
REFEREE_DANTZIG = dict(max_bodies=16, max_pair_candidates=128,
                       max_contacts=96, dtype="float64",
                       exact_box_clip=True, max_contacts_per_pair=8,
                       matmul_precision="highest")


@pytest.mark.cuda
def test_dantzig_card_matches_cpu_in_float64():
    """The referee's DANTZIG configuration on ``mini_stack_world``, 2
    worlds kicked apart and settled 40 substeps on the CPU, then 8 on each
    device: within 1e-9, tick and overflow exact."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.models import scenes
    config = EngineConfig(**REFEREE_DANTZIG, solver=SolverKind.DANTZIG)
    world = replicate(scenes.mini_stack_world(config, device="cpu"), 2,
                      device="cpu")
    kick = torch.from_numpy(np.random.default_rng(6).normal(
        scale=0.05, size=tuple(world.linvel.shape)))
    world = world.replace(linvel=world.linvel + torch.where(
        (world.dynamic & ~world.is_kinematic)[..., None], kick, 0.0))
    start = make_batched_step_fn(config, substeps=40, device="cpu")(world)
    card = _card_against_cpu(config, start, atol=1e-9)
    assert card.pos.dtype == torch.float64


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["JACOBI", "PGS", "DANTZIG"])
def test_hinge_chain_card_matches_cpu(solver):
    """``hinge_chain_scene`` under each solver (JACOBI in float32 at atol
    1e-4; PGS and DANTZIG in float64, the referee's configurations, at
    1e-9): 2 worlds settled 40 substeps on the CPU, then 8 on each
    device."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.models import scenes
    if solver == "JACOBI":
        config = EngineConfig(max_bodies=16, max_pair_candidates=128,
                              max_contacts=96)
        atol = 1e-4
    else:
        config = EngineConfig(**dict(REFEREE_DANTZIG,
                                     max_contacts=96 if solver == "DANTZIG"
                                     else 256),
                              solver=SolverKind[solver])
        atol = 1e-9
    world, joints = scenes.hinge_chain_scene(config, device="cpu")
    start = make_batched_step_fn(config, substeps=40, device="cpu",
                                 joints=joints)(replicate(world, 2,
                                                          device="cpu"))
    _card_against_cpu(config, start, atol=atol, joints=joints)


@pytest.mark.cuda
@pytest.mark.parametrize("lever", [dict(solver_cm=True),
                                   dict(solver_matmul_dtype="bfloat16"),
                                   dict(solver_cm=True,
                                        solver_matmul_dtype="bfloat16")],
                         ids=["solver_cm", "bf16", "solver_cm_bf16"])
def test_bench_levers_card_match_cpu(lever):
    """The bench's A/B levers on ``bench_config(64)``: 4 worlds of the
    bench world settled 40 substeps on the CPU, then 8 on each device at
    atol 1e-4; under bf16 products (``out_dtype`` on the card, an upcast
    on the CPU) the velocities within one bf16 spacing."""
    _require_card()
    config = bench_config(64).replace(**lever)
    start = make_batched_step_fn(config, substeps=40, device="cpu")(
        replicate(bench_world(config, device="cpu"), 4, device="cpu"))
    _card_against_cpu(config, start)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 64), (64, 128)],
                         ids=["gather", "scatter"])
def test_bf16_products_keep_float32_results_on_card(shape):
    """The solver's bf16 products on the card's own route (``out_dtype``)
    at ``bench_config(64)``'s shapes, the gather (B, 2C, N)·(B, N, 8) and
    the scatter (B, N, 2C)·(B, 2C, 8): a float32 result equal to the
    float32 product of the same operands at float32 roundoff (the inner
    length times float32's epsilon, of Σ|a·b| an entry), while a bf16
    ``bmm``, rounded to bf16, falls outside that bound."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import solver
    assert solver.bf16_product_route("cuda") == "out_dtype"
    gen = torch.Generator("cuda").manual_seed(18)
    m, k = shape
    a = torch.randn((64, m, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((64, k, 8), generator=gen, device="cuda").to(
        torch.bfloat16)
    got = solver._mm(a, b, torch.float32)
    assert got.dtype == torch.float32
    ref = torch.bmm(a.float(), b.float())
    bound = k * torch.finfo(torch.float32).eps * torch.bmm(a.float().abs(),
                                                           b.float().abs())
    assert bool(((got - ref).abs() <= bound).all())
    assert bool(((torch.bmm(a, b).float() - ref).abs() > bound).any())


@pytest.mark.cuda
def test_joint_step_is_bitwise_repeatable_on_card():
    """Two runs of the hinge chain's JACOBI step on the card, from the same
    batch, give the same bits: the joint pass gathers and scatters with
    one-hot products, no atomic adds."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models import scenes
    config = EngineConfig(max_bodies=16, max_pair_candidates=128,
                          max_contacts=96)
    world, joints = scenes.hinge_chain_scene(config, device="cuda")
    batch = replicate(world, 64, device="cuda")
    batch = batch.replace(linvel=batch.linvel + 0.1 * torch.randn(
        batch.linvel.shape, generator=torch.Generator("cuda").manual_seed(5),
        device="cuda") * batch.dynamic[..., None])
    step = make_batched_step_fn(config, substeps=16, device="cuda",
                                joints=joints)
    a, b = step(batch), step(batch)
    for field in ("pos", "quat", "linvel", "angvel"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def _body_api_sequence(device):
    """Every body-API function on 4 arena worlds of 8 slots (4 free), with
    and without ``auto_mass``, a slot per world as a (B,) tensor, and one
    more spawn than there are free slots."""
    from rl_ode_physics_tpu_torch.core import world as w
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import grass_plane_world
    cfg = EngineConfig(max_bodies=8, max_pair_candidates=32, max_contacts=64)
    b = replicate(grass_plane_world(cfg, device=device), 4, device=device)
    per_world = torch.tensor([4, 5, 6, 7], device=device)
    slots = []
    for kind, auto in ((1, False), (2, True), (3, True), (1, True),
                       (2, False)):
        b, s = w.add_body(b, kind, (0.1 * kind, 2.0, -0.5), (0.3, 0.6, 0.9),
                          quat=(0.5, 0.5, -0.5, 0.5), linvel=(1.0, 0.0, 2.0),
                          auto_mass=auto, density=1.3, kinematic=kind == 3)
        slots.append(s)
    b = w.release_body(b, per_world)
    b, s = w.add_body_map(b, (1.0, 0.5, 1.0), (0.1, -0.2, 0.3),
                          (2.0, 0.5, 1.0))
    slots.append(s)
    b = w.set_body_pose(b, per_world, pos=(1.0, 2.0, 3.0),
                        angvel=(-1.0, 0.0, 1.0))
    b = w.set_body_surface(b, 5, friction=0.4, restitution=0.6)
    b = w.add_force(b, per_world, (1.0, -2.0, 3.0))
    b = w.add_torque(b, -1, (0.0, 0.0, 9.0))
    return b, torch.stack(slots)


@pytest.mark.cuda
def test_body_api_card_matches_cpu_bitwise():
    _require_card()
    import dataclasses
    card, card_slots = _body_api_sequence("cuda")
    cpu, cpu_slots = _body_api_sequence("cpu")
    assert torch.equal(card_slots.cpu(), cpu_slots)
    assert cpu_slots[4].tolist() == [-1, -1, -1, -1]
    for f in dataclasses.fields(cpu):
        assert torch.equal(getattr(card, f.name).cpu(),
                           getattr(cpu, f.name)), f.name


def _server_session(sim, ticks=120):
    """Two capsule players (one walking) and 24 M-key spawns, 2 a tick."""
    from rl_ode_physics_tpu_torch.net.client import GameClient
    from rl_ode_physics_tpu_torch.utils.prng import RandStream
    rng = RandStream(0)
    for pid in (0, 1):
        sim.player_join(pid)
    while sim.tick < ticks:
        t = sim.tick
        for _ in range(2 if t < 12 else 0):
            pos = (rng.double(-4.0, 4.0), rng.double(2.0, 6.0),
                   rng.double(-4.0, 4.0))
            kind = 2 if rng.randint(0, 2) == 0 else 1
            assert sim.spawn_body(kind, GameClient._identity_t16(pos),
                                  (rng.double(0.2, 0.6),) * 3,
                                  rng.color()) >= 0
        if t < 40:
            sim.player_move(0, (0.05 * t, 2.0, -3.0))
        sim.advance(1)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cli", "throughput"])
def test_replay_is_bitwise_on_card(policy):
    """A session on the card and its replay from the intent log end in the
    same bits; the card's state stays within 1e-4 of the CPU's."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.net import replay
    from rl_ode_physics_tpu_torch.net.server import SimCore
    caps = dict(max_bodies=64, max_pair_candidates=256, max_contacts=512)
    config = (EngineConfig(**caps) if policy == "cli"
              else EngineConfig.throughput(**caps))
    live = _server_session(SimCore(config, seed=0, player_capsules=True,
                                   device="cuda"))
    assert live.world.pos.is_cuda and live.check_overflow() == 0
    again = replay.replay(live.intent_log, live.tick, config, seed=0,
                          player_capsules=True, device="cuda")
    assert again.state_digest() == live.state_digest()
    cpu = replay.replay(live.intent_log, live.tick, config, seed=0,
                        player_capsules=True, device="cpu")
    np.testing.assert_allclose(live.body_states()["transform"],
                               cpu.body_states()["transform"], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_loopback_session_on_card():
    """A ``GameServer`` on the card and the native transport: a client's
    spawn is mirrored back from the card's snapshots."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.net import native_transport
    from rl_ode_physics_tpu_torch.net.client import GameClient
    from rl_ode_physics_tpu_torch.net.server import GameServer
    server = GameServer(EngineConfig(max_bodies=32, max_pair_candidates=128,
                                     max_contacts=256), port=0,
                        max_players=4, device="cuda")
    client = GameClient(("127.0.0.1", server.host.port), max_bodies=32,
                        max_players=4)
    try:
        assert isinstance(server.host, native_transport.NativeHost)
        for _ in range(200):
            server.pump(0.005)
            client.pump(0.005)
            if client.connected:
                break
        assert client.connected
        for _ in range(3):
            client.spawn_random()
        for _ in range(60):
            server.tick(1.0 / 60.0)
            server.pump(0.002)
            client.pump(0.01)
        assert int(server.sim.world.active.sum()) == 7
        assert int((client.bodies["type"] != 0).sum()) == 7
    finally:
        client.close()
        server.close()


def _mesh_test_batch(device, worlds=16):
    """``tests/test_mesh.py``'s batch: ``stack_world`` of 10 bodies (seed 3)
    in ``worlds`` worlds, each world's dynamic bodies raised 0.013 m a
    world index."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import stack_world
    config = EngineConfig(max_bodies=16, max_pair_candidates=64,
                          max_contacts=128)
    b = replicate(stack_world(config, num_bodies=10, seed=3, device=device),
                  worlds, device=device)
    bump = torch.arange(worlds, dtype=b.pos.dtype, device=b.device) * 0.013
    lift = (bump[:, None] * (b.inv_mass > 0))[..., None]
    return config, b.replace(pos=b.pos + torch.nn.functional.pad(
        lift, (1, 1)))


@pytest.mark.cuda
def test_mesh_of_two_shards_on_the_card_is_bitwise_unsharded():
    """Two shards of the one card, under both step functions' names: every
    field bitwise the unsharded step's."""
    _require_card()
    import dataclasses
    from rl_ode_physics_tpu_torch.parallel import mesh as pmesh
    config, batch = _mesh_test_batch("cuda")
    ref = make_batched_step_fn(config, substeps=3, device="cuda")(batch)
    mesh = pmesh.make_mesh(["cuda:0", "cuda:0"])
    for make in (pmesh.make_sharded_step_fn, pmesh.make_shard_map_step_fn):
        got = pmesh.gather_batch(make(config, mesh, substeps=3)(
            pmesh.shard_batch(batch, mesh)))
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), (
                f.name)


@pytest.mark.cuda
def test_mesh_of_the_cpu_and_the_card_keeps_each_shard_on_its_device():
    """A mesh of the CPU and the card: each shard is stepped on its own
    device (an operation mixing them would raise), within 1e-4 of the
    card's unsharded step."""
    _require_card()
    from rl_ode_physics_tpu_torch.parallel import mesh as pmesh
    config, batch = _mesh_test_batch("cuda")
    ref = make_batched_step_fn(config, substeps=3, device="cuda")(batch)
    mesh = pmesh.make_mesh(["cpu", "cuda:0"])
    out = pmesh.make_sharded_step_fn(config, mesh, substeps=3)(
        pmesh.shard_batch(batch, mesh))
    assert [s.device for s in out] == list(mesh.devices)
    got = pmesh.gather_batch(out, "cuda")
    for field in ("pos", "quat", "linvel", "angvel"):
        diff = (getattr(got, field) - getattr(ref, field)).abs().max()
        assert float(diff) <= 1e-4, field
    for field in ("tick", "overflow", "body_type"):
        assert torch.equal(getattr(got, field), getattr(ref, field))


@pytest.mark.cuda
def test_es_train_step_card_matches_cpu():
    """One ES train step (pop 12, horizon 8) on the card and on the CPU from
    the same noise: parameters and mean reward at rtol 1e-4, atol 1e-5."""
    _require_card()
    from rl_ode_physics_tpu_torch.examples.rl_training import make_trainer
    gen = torch.Generator().manual_seed(1)
    ew = torch.randn((12, 6, 2), generator=gen) * 0.1
    eb = torch.randn((12, 2), generator=gen) * 0.1
    results = []
    for device in ("cpu", "cuda"):
        params, step = make_trainer(pop=12, horizon=8, device=device)
        new, r = step.step_with_noise(params, ew.to(device), eb.to(device))
        results.append([t.cpu() for t in new + (r,)])
    for want, got in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_capacity_audit_on_card_matches_cpu():
    """``utils/capacity_audit.audit_config`` at 16 slots, seeds 42 and 7,
    one chunk of 50 substeps: the card's peaks and overflow equal the
    port's CPU ones (counts), and the compaction kernel launched once a
    substep."""
    _require_card()
    from rl_ode_physics_tpu_torch.utils import capacity_audit
    config = bench_config(16)
    ref = capacity_audit.audit_config(config, 16, 48, (42, 7), device="cpu")
    compaction_kernel.compact_rows_t.launches = 0
    got = capacity_audit.audit_config(config, 16, 48, (42, 7),
                                      device="cuda")
    assert compaction_kernel.compact_rows_t.launches == 50
    for (seed, pc, pb, ovf, _), (rseed, rpc, rpb, rovf, _) in zip(got, ref):
        assert (seed, pc, ovf) == (rseed, rpc, rovf)
        assert np.array_equal(pb, rpb)


@pytest.mark.cuda
def test_teapot_bench_standin_on_card():
    """``utils/teapot_bench`` on the stand-in mesh at 8 worlds: the tile
    kernel once a timed substep, no overflow, positive rates."""
    _require_card()
    from rl_ode_physics_tpu_torch.utils import teapot_bench
    verts, tris = teapot_bench.mesh_geometry(standin=True)
    r = teapot_bench.run(8, verts, tris, "cuda", launches=1)
    assert r["tile_kernel_launches"] == teapot_bench.SUBSTEPS
    assert r["overflow"] == 0 and r["value"] > 0
    assert r["triangle_tests_per_sec"] > 0


@pytest.mark.cuda
def test_profile_step_attributes_card_kernels():
    """``utils/profile_step`` on the card, 64 worlds x 2 substeps of the
    bench: at least 90% of the device time under a function of the port,
    the compaction kernel among the rows with its source, the per-file
    totals summing to the total."""
    _require_card()
    from rl_ode_physics_tpu_torch.utils import profile_step
    r = profile_step.profile(64, 2, "bench", "cuda")
    assert r["on_device"] and r["mapped_share"] >= 0.9
    assert r["hand_kernel_launches"]["compact_rows_t"] == 2
    assert any("compact_rows" in row["op"]
               and row["source"].startswith("ops/compaction_kernel.py:")
               for row in r["rows"])
    assert abs(sum(r["by_file"].values()) - r["total_ms"]) <= 1e-6
