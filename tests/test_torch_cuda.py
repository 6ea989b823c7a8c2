"""The port's kernels and steps on the card, held to their plain versions.

This file imports neither JAX's engine package nor anything that needs it,
so it runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The tests marked ``cuda`` skip where no card is present. The others run
everywhere: the compaction's plain version against a numpy loop, and the
mesh kernels' wrappers taking their plain versions on CPU tensors.

On the card every step entry point replays CUDA graphs
(``utils/graphs.py``); the tests at the end of this file hold each one
bitwise to its eager loop (``disable_graphs``), and check the launch
counts per replay, outputs that a later call does not write over, a new
capture for a new shape, PGS and DANTZIG graphed, and a forced capture of
a body's host read raising. The PGS kernel is held to its plain version
on every friction case, with joint rows and alone, on scattered live
rows, with more live rows than it stages, at the most slots whose
velocities a block keeps and past them. DANTZIG's pivot kernel is held to
its plain version on the settled stack's systems, under a finite μ, on
worlds of more valid rows than it stages, and its solve reads nothing back
to the host.
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


# lcp_pivot against its plain version: float64 λ within 1e-10 of max |λ|
# and the same rounds a world (each sums in its own order); float32 held
# as ROADMAP's float32 trap holds DANTZIG, on the solve's velocity change
# in constraint space, A·λ, within 1e-5 of its largest (λ itself
# amplifies roundoff through near-redundant rows)
LCP_F64_RTOL = 1e-10
LCP_F32_RTOL = 1e-5


def _dantzig_systems(config, worlds=4, scene="mini_stack_world",
                     substeps=40, kick=True):
    """The LCPs of the next DANTZIG solve of ``scene`` (kicked worlds
    with ``kick``) settled ``substeps`` substeps on the card: (A, b,
    valid, is_normal, μ a contact)."""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, lcp, narrowphase)
    world = getattr(scenes, scene)(config, device="cuda")
    batch = replicate(world, worlds, device="cuda")
    if kick:
        batch = _kicked(batch, 3)
    batch = make_batched_step_fn(config, substeps, device="cuda")(batch)
    contacts = narrowphase.narrowphase(
        batch, broadphase.broadphase(batch, config), config)
    state = integrator.apply_external_forces(batch, config)
    return lcp._build_lcp(state, contacts, config)[1:]


def _synthetic_systems():
    """Random contact LCPs of 96 contacts (R = 288) between 128 bodies
    (``testing/lcp_systems``), μ = ∞: worlds 0 and 3 with every row valid
    (the kernel's large tier, its blocked elimination), world 1 with 10
    contacts (staged), world 2 with 20 (the medium tier)."""
    from rl_ode_physics_tpu_torch.testing.lcp_systems import (
        random_contact_lcp)
    a_mat, b, valid, is_normal, _ = random_contact_lcp(
        11, worlds=4, contacts=96, bodies=128, live=1.0)
    for w, k in ((1, 10), (2, 20)):
        valid[w] = np.tile(np.arange(96) < k, 3)
    return tuple(torch.from_numpy(x).to("cuda")
                 for x in (a_mat, b, valid, is_normal)) + (None,)


def _lcp_kernel_against_plain(system, friction, dtype, what=""):
    """lcp_pivot_solve (one launch) and ``lcp._pivot_solve`` on the same
    card tensors; returns the kernel's rounds and the largest
    difference."""
    from rl_ode_physics_tpu_torch.ops import lcp, lcp_kernel
    a_mat, b, valid, is_normal, mu = system
    f = getattr(torch, dtype)
    a_mat, b = a_mat.to(f), b.to(f)
    mu = None if mu is None else mu.to(f)
    before = lcp_kernel.lcp_pivot_solve.launches
    lam, rounds = lcp_kernel.lcp_pivot_solve(a_mat, b, valid, is_normal,
                                             friction, mu)
    assert lcp_kernel.lcp_pivot_solve.launches == before + 1
    lam_again, _, counters = lcp_kernel.launch(a_mat, b, valid, is_normal,
                                               friction, mu)
    assert torch.equal(lam_again, lam)
    tiers = lcp_kernel.tier_counts(valid.shape[0], counters)
    want, want_rounds = lcp._pivot_solve(a_mat, b, valid, is_normal,
                                         friction, mu)
    torch.cuda.synchronize()
    # each world in the tier of its valid count
    counts = valid.sum(1).tolist()
    for tier in lcp_kernel.TIERS:
        expected = sum(lcp_kernel.tier_of(valid.shape[1], v) == tier
                       for v in counts)
        assert tiers[tier] == expected, (what, tiers, counts)
    assert lam.dtype == f and rounds.dtype == torch.int32
    assert bool((lam[~valid] == 0).all())
    assert float(want.abs().max()) > 0
    if f == torch.float64:
        err = float((lam - want).abs().max())
        assert err <= LCP_F64_RTOL * float(want.abs().max()), (what, err)
        assert torch.equal(rounds, want_rounds), (what, rounds, want_rounds)
    else:
        moved = torch.bmm(a_mat, want[..., None])
        err = float(torch.bmm(a_mat, (lam - want)[..., None]).abs().max())
        assert err <= LCP_F32_RTOL * float(moved.abs().max()), (what, err)
    return rounds, err


def _far_rows(dtype):
    """The least R = 3C whose large tier keeps its panel and vectors in
    device memory (``launch_shape(...).far``): 600 in float64, 1,149 in
    float32."""
    from rl_ode_physics_tpu_torch.ops import lcp_kernel
    return next(r for r in range(291, 3000, 3)
                if lcp_kernel.launch_shape(dtype, 1, r).far)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["stack", "stack_mu_finite",
                                  "more_rows_than_staged", "tier_boundaries",
                                  "tier_boundaries_mu_finite",
                                  "capsule_pile", "past_the_shared_panel"])
def test_lcp_pivot_kernel_matches_plain_on_card(case, dtype):
    """The referee's DANTZIG configuration's systems on the settled mini
    stack (μ = ∞; μ = 0.4, boxed rows) and on the capsule pile settled 60
    substeps (past the float64 stage), worlds of more valid rows than the
    kernel stages, up to all 288, one world at each tier boundary of the
    dtype (``lcp_kernel.boundary_counts``; μ = ∞ and 0.4; at μ = ∞ every
    row active in the first round, so that the world of the large tier's
    shared rows + 1 takes the blocked elimination and the one of its shared
    rows − 1 does not), and one world of every row valid past the R whose
    panel fits shared memory (600 rows in float64, 1,149 in float32)."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.ops import lcp_kernel
    from rl_ode_physics_tpu_torch.testing.lcp_systems import (
        tier_boundary_lcp)
    config = EngineConfig(**REFEREE_DANTZIG, solver=SolverKind.DANTZIG)
    staged = lcp_kernel.STAGED_ROWS
    f = getattr(torch, dtype)

    def on_card(system):
        return tuple(None if x is None else torch.from_numpy(x).to("cuda")
                     for x in system)

    if case == "more_rows_than_staged":
        system = _synthetic_systems()
        count = system[2].sum(1)
        assert int(count.max()) == 288
        assert int((count > staged).sum()) == 3
    elif case.startswith("tier_boundaries"):
        counts = lcp_kernel.boundary_counts(f, 288)
        mu = 0.4 if case.endswith("mu_finite") else None
        system = on_card(tier_boundary_lcp(counts, mu=mu))
        assert system[2].sum(1).tolist() == counts
        if mu is None:
            nm = lcp_kernel.launch_shape(f, 1, 288).shared_rows
            for count, blocked in ((nm - 1, False), (nm + 1, True)):
                w = counts.index(count)
                one = [x[w:w + 1].contiguous() for x in system[:4]]
                _, _, counters = lcp_kernel.launch(
                    one[0].to(f), one[1].to(f), *one[2:], True)
                tiers = lcp_kernel.tier_counts(1, counters)
                assert tiers["large"] == 1, (count, tiers)
                assert (tiers["blocked_solves"] > 0) == blocked, (count,
                                                                  tiers)
    elif case == "capsule_pile":
        system = _dantzig_systems(config, worlds=2, scene="capsule_pile_world",
                                  substeps=60, kick=False)
        assert int(system[2].sum(1).max()) > staged
    elif case == "past_the_shared_panel":
        rows = _far_rows(f)
        assert rows == (600 if f == torch.float64 else 1149)
        assert not lcp_kernel.launch_shape(f, 1, rows - 3).far
        system = on_card(tier_boundary_lcp([rows], contacts=rows // 3))
        _, _, counters = lcp_kernel.launch(system[0].to(f), system[1].to(f),
                                           *system[2:4], True)
        assert lcp_kernel.tier_counts(1, counters)["blocked_solves"] > 0
    else:
        system = _dantzig_systems(config)
        assert int(system[2].sum(1).min()) >= 12
        if case == "stack_mu_finite":
            system = system[:4] + (torch.full_like(system[4], 0.4),)
    _lcp_kernel_against_plain(system, True, dtype, case)


@pytest.mark.cuda
def test_lcp_pivot_kernel_ends_block_cycles_on_card():
    """A world in each tier on which flipping every violating row at once
    cycles to the cap (``lcp_systems.block_cycle_lcp``): the kernel's
    safeguard ends each in the plain version's rounds, at its λ, in
    float64 (in float32 these near-degenerate systems' pivot paths follow
    the roundoff of each side's sums)."""
    _require_card()
    from rl_ode_physics_tpu_torch.testing.lcp_systems import (
        block_cycle_lcp)
    system = tuple(torch.from_numpy(x).to("cuda")
                   for x in block_cycle_lcp()) + (None,)
    rounds, _ = _lcp_kernel_against_plain(system, True, "float64",
                                          "block_cycles")
    assert int(rounds.max()) < 32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lcp_pivot_register_tiers_fit_the_sm_on_card(dtype):
    """What the card reports of the register tiers' built kernels: the
    staged tier's static shared memory lets 8 of its blocks share an SM (a
    1,024-world batch in one wave), the medium tier's is under the 48 KB
    that needs no opt-in, the large tier's is all dynamic."""
    _require_card()
    from rl_ode_physics_tpu_torch.ops import lcp_kernel
    res = lcp_kernel.resources(getattr(torch, dtype))
    assert 8 * (res["staged"]["static_shared"] + 1024) \
        <= lcp_kernel.SM_SHARED, res
    assert res["medium"]["static_shared"] <= 48 * 1024, res
    assert res["large"]["static_shared"] == 0, res


@pytest.mark.cuda
def test_dantzig_solve_reads_nothing_back_on_card():
    """``solve_dantzig`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the
    solve waits on the card (the plain pivot loop's round read would
    raise)."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, lcp, narrowphase)
    config = EngineConfig(**REFEREE_DANTZIG, solver=SolverKind.DANTZIG)
    batch = replicate(scenes.mini_stack_world(config, device="cuda"), 2,
                      device="cuda")
    batch = make_batched_step_fn(config, 40, device="cuda")(batch)
    contacts = narrowphase.narrowphase(
        batch, broadphase.broadphase(batch, config), config)
    state = integrator.apply_external_forces(batch, config)
    lcp.solve_dantzig(state, contacts, config)        # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lcp.solve_dantzig(state, contacts, config)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out.linvel).all())
    with pytest.raises(RuntimeError):
        torch.cuda.set_sync_debug_mode("error")
        try:
            lcp._pivot_solve(*lcp._build_lcp(state, contacts, config)[1:5],
                             True)
        finally:
            torch.cuda.set_sync_debug_mode("default")


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


# ---------------------------------------------------------------------------
# The PGS kernel (ops/pgs_kernel.py, csrc/pgs_solve.cu) against its plain
# version (ops/solver.pgs_sweeps_plain) on the card. Tolerances after one
# 20-sweep solve: float64 1e-12 and float32 1e-5, velocities and impulses.
# The kernel rounds as the plain version does on the CPU; on the card the
# plain version's own kernels may fuse a multiply-add otherwise, and PGS
# carries each row's roundoff into the next.
# ---------------------------------------------------------------------------

PGS_CASES = {"mu_inf": dict(), "mu_finite": dict(mu=0.4),
             "per_body_surface": dict(per_body_surface=True),
             "no_friction": dict(friction=False, sor_omega=1.0)}
PGS_TOL = {"float32": 1e-5, "float64": 1e-12}
CONF_CAPS = dict(max_bodies=16, max_pair_candidates=128, max_contacts=256)


def _kicked(batch, seed, scale=0.05):
    kick = torch.randn(batch.linvel.shape, generator=torch.Generator(
        "cuda").manual_seed(seed), device="cuda", dtype=batch.linvel.dtype)
    moving = (batch.dynamic & ~batch.is_kinematic)[..., None]
    return batch.replace(linvel=batch.linvel + scale * kick * moving)


def _pgs_inputs(config, batch, warm, joints=None):
    """The inputs of the PGS solve of ``batch``'s next substep: (vel, lam,
    the row table, the joint rows), as ``core/world._step_impl`` builds
    them; ``warm``: random starting impulses on the live rows."""
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, narrowphase, solver)
    from rl_ode_physics_tpu_torch.ops import joints as joint_ops
    exclude = (None if joints is None
               else joint_ops.connected_mask(joints, batch.num_slots))
    contacts = narrowphase.narrowphase(
        batch, broadphase.broadphase(batch, config, exclude=exclude), config)
    jrows = (None if joints is None
             else joint_ops.joint_rows(batch, joints, config))
    state = integrator.apply_external_forces(batch, config)
    lam0 = None
    if warm:
        gen = torch.Generator("cuda").manual_seed(4)
        lam0 = 0.02 * torch.rand(contacts.a.shape + (3,), generator=gen,
                                 device="cuda", dtype=batch.linvel.dtype)
    return solver.pgs_inputs(state, contacts, config, lam0) + (jrows,)


def _settled_stack(config, worlds=4, settle=40):
    """``mini_stack_world`` in kicked worlds settled on the card; with
    per-body surfaces, each slot's own friction (a third of them ∞) and
    restitution."""
    from rl_ode_physics_tpu_torch.models import scenes
    world = scenes.mini_stack_world(config, device="cuda")
    if config.per_body_surface:
        gen = torch.Generator("cuda").manual_seed(5)
        n, f = world.num_slots, world.linvel.dtype
        fr = 0.2 + 0.8 * torch.rand((1, n), generator=gen, device="cuda",
                                    dtype=f)
        fr[:, ::3] = torch.inf
        world = world.replace(friction=fr, restitution=0.6 * torch.rand(
            (1, n), generator=gen, device="cuda", dtype=f))
    batch = _kicked(replicate(world, worlds, device="cuda"), 3)
    return make_batched_step_fn(config, settle, device="cuda")(batch)


def _kernel_against_plain(inputs, config, dtype, omega=None, what=""):
    """The kernel and the plain version on the same card tensors; the
    kernel launched once. Returns the largest differences."""
    from rl_ode_physics_tpu_torch.ops import pgs_kernel, solver
    vel, lam, rows, jrows = inputs
    params = solver.pgs_params(config)
    if omega is not None:
        params["omega"] = omega
    before = pgs_kernel.pgs_solve.launches
    got = pgs_kernel.pgs_solve(vel, lam, rows, jrows, **params)
    assert pgs_kernel.pgs_solve.launches == before + 1
    want = solver.pgs_sweeps_plain(vel, lam, rows, jrows, **params)
    torch.cuda.synchronize()
    tol = PGS_TOL[dtype]
    err = [float((got[0] - want[0]).abs().max())]
    assert err[0] <= tol, (what, "velocities", err[0], tol)
    if lam is not None:
        err.append(float((got[1] - want[1]).abs().max()))
        assert err[1] <= tol, (what, "impulses", err[1], tol)
        assert bool((got[1][~rows["valid"]] == 0).all())
    assert float((got[0] - vel).abs().max()) > 1e-5    # the rows did work
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", list(PGS_CASES))
def test_pgs_kernel_matches_plain_on_card(case, warm, dtype):
    """The conformance configuration (exact clip, K=8, 256 rows) on the
    settled mini stack in 4 kicked worlds, under each friction case."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    config = EngineConfig.conformance(**CONF_CAPS, dtype=dtype,
                                      **PGS_CASES[case])
    batch = _settled_stack(config)
    inputs = _pgs_inputs(config, batch, warm)
    assert int(inputs[2]["valid"].sum(1).min()) >= 4
    _kernel_against_plain(inputs, config, dtype, what=case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pgs_kernel_with_joints_matches_plain_on_card(dtype):
    """The hinge chain under PGS, joint rows in the sweeps, and its joint
    passes alone (DANTZIG's entry: no contact rows, ω = 1)."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models import scenes
    config = EngineConfig.conformance(**CONF_CAPS, dtype=dtype)
    world, joints = scenes.hinge_chain_scene(config, device="cuda")
    batch = make_batched_step_fn(config, 40, device="cuda", joints=joints)(
        _kicked(replicate(world, 4, device="cuda"), 5))
    vel, lam, rows, jrows = _pgs_inputs(config, batch, False, joints)
    assert bool(jrows["live"].any()) and bool(rows["valid"].any())
    _kernel_against_plain((vel, lam, rows, jrows), config, dtype,
                          what="joints in the sweeps")
    _kernel_against_plain((vel, None, None, jrows), config, dtype, 1.0,
                          what="joint passes alone")


def _scattered_rows(lam, rows, seed):
    """Each world's rows in a seeded random order of its own: the live
    rows scattered over the buffer."""
    bsz, c = rows["valid"].shape
    gen = torch.Generator("cuda").manual_seed(seed)
    perm = torch.argsort(torch.rand((bsz, c), generator=gen, device="cuda"),
                         1)
    ar = torch.arange(bsz, device="cuda")[:, None]
    return lam[ar, perm], {k: None if v is None else v[ar, perm]
                           for k, v in rows.items()}


def _all_rows_live(lam, rows):
    """Every one of a world's C rows live: row c a copy of its live row
    c mod (its live count), in buffer order."""
    valid = rows["valid"]
    bsz, c = valid.shape
    count = valid.sum(1, keepdim=True)
    assert bool((count > 0).all())
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    src = order.gather(1, torch.arange(c, device="cuda")[None] % count)
    ar = torch.arange(bsz, device="cuda")[:, None]
    out = {k: None if v is None else v[ar, src] for k, v in rows.items()}
    out["valid"] = torch.ones_like(valid)
    return lam[ar, src], out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", ["scattered", "all_live"])
def test_pgs_kernel_on_scattered_and_overfull_rows_on_card(layout, dtype):
    """The conformance configuration's rows on the settled mini stack,
    scattered over each world's buffer; and every one of its 256 rows live
    (each world's live rows repeated), more than the kernel stages
    (``staged_rows``) in either dtype, so the rows past S are solved from
    device memory."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.ops import pgs_kernel
    config = EngineConfig.conformance(**CONF_CAPS, dtype=dtype)
    vel, lam, rows, _ = _pgs_inputs(config, _settled_stack(config), True)
    if layout == "scattered":
        lam, rows = _scattered_rows(lam, rows, 7)
        first = rows["valid"].float().argmax(1)
        assert int(first.max()) > 0            # not a prefix any more
    else:
        lam, rows = _all_rows_live(lam, rows)
        c = rows["valid"].shape[1]
        assert bool(rows["valid"].all())
        assert c > pgs_kernel.staged_rows(vel.dtype, vel.shape[1])
    _kernel_against_plain((vel, lam, rows, None), config, dtype,
                          what=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pgs_kernel_at_the_most_slots_on_card(dtype):
    """Worlds of ``max_slots`` slots (1,024 in float64, 2,048 in float32):
    fewer worlds a block and fewer staged rows (``launch_shape``), the
    kernel still the plain loop's, the rows of the settled mini stack in
    its first 12 slots."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.ops import pgs_kernel
    config = EngineConfig.conformance(**CONF_CAPS, dtype=dtype)
    vel, lam, rows, _ = _pgs_inputs(config, _settled_stack(config, 2), False)
    n = pgs_kernel.max_slots(vel.dtype)
    shape = pgs_kernel.launch_shape(vel.dtype, n, rows["valid"].shape[1])
    assert shape.worlds < pgs_kernel.MAX_WORLDS and shape.staged > 0
    assert shape.shared_bytes <= pgs_kernel.SHARED_BYTES
    wide = torch.zeros((vel.shape[0], n, 6), dtype=vel.dtype, device="cuda")
    wide[:, :vel.shape[1]] = vel
    _kernel_against_plain((wide, lam, rows, None), config, dtype,
                          what="most slots")


@pytest.mark.cuda
def test_pgs_kernel_refuses_on_card():
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.ops import pgs_kernel, solver
    config = EngineConfig.conformance(**CONF_CAPS)
    vel, lam, rows, _ = _pgs_inputs(config, _settled_stack(config, 2),
                                    True)
    params = solver.pgs_params(config)
    with pytest.raises(ValueError):            # two devices
        pgs_kernel.pgs_solve(vel, lam.cpu(), rows, **params)
    with pytest.raises(TypeError):
        pgs_kernel.pgs_solve(vel.half(), lam, rows, **params)
    # a world past max_slots is no longer refused: its velocities stay in
    # device memory, and the kernel is the plain loop's there too
    wide, wrows = _past_the_most_slots(
        vel, rows, pgs_kernel.max_slots(torch.float32) + 1)
    _kernel_against_plain((wide, lam, wrows, None), config, "float32",
                          what="max_slots + 1")


def _past_the_most_slots(vel, rows, n):
    """Worlds of ``n`` slots holding ``vel``'s bodies in their last
    slots, the rows' bodies moved with them."""
    m = vel.shape[1]
    wide = torch.zeros((vel.shape[0], n, 6), dtype=vel.dtype, device="cuda")
    wide[:, n - m:] = vel
    return wide, dict(rows, a=rows["a"] + (n - m), b=rows["b"] + (n - m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,slots", [("float32", "max_slots + 1"),
                                         ("float64", "max_slots + 1"),
                                         ("float64", 1448)])
def test_pgs_kernel_past_the_most_slots_on_card(dtype, slots):
    """Worlds past ``max_slots`` (their velocities worked on in place in
    device memory), up to 1,448 slots in float64 at K = 8, the largest
    world that ``validate()`` admits: the kernel is the plain loop's, the
    rows of the settled mini stack in the worlds' last 12 slots."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.ops import pgs_kernel
    config = EngineConfig.conformance(**CONF_CAPS, dtype=dtype)
    vel, lam, rows, _ = _pgs_inputs(config, _settled_stack(config, 2), True)
    n = (pgs_kernel.max_slots(vel.dtype) + 1 if slots == "max_slots + 1"
         else slots)
    assert n > pgs_kernel.max_slots(vel.dtype)
    if slots == 1448:          # the largest world validate() admits, K = 8
        EngineConfig.conformance(**dict(CONF_CAPS, max_bodies=n),
                                 dtype=dtype)
        with pytest.raises(ValueError):
            EngineConfig.conformance(**dict(CONF_CAPS, max_bodies=n + 1),
                                     dtype=dtype)
    wide, wrows = _past_the_most_slots(vel, rows, n)
    _kernel_against_plain((wide, lam, wrows, None), config, dtype,
                          what=f"{n} slots")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["mini_stack", "hinge_chain"])
def test_graphed_pgs_step_is_bitwise_eager_on_card(scene):
    """The conformance configuration in float64 under PGS, graphed: the
    mini stack, and the hinge chain with its joints; ``make_step_fn`` and
    ``make_batched_step_fn`` replay graphs, each bitwise its eager loop,
    the kernel counted once a substep per replay."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.core.world import make_step_fn
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import pgs_kernel
    config = EngineConfig.conformance(**CONF_CAPS, dtype="float64")
    joints = None
    if scene == "mini_stack":
        world = scenes.mini_stack_world(config, device="cuda")
    else:
        world, joints = scenes.hinge_chain_scene(config, device="cuda")
    start = _kicked(replicate(world, 8, device="cuda"), 6)
    for fn in (make_batched_step_fn(config, 6, False, unroll=3,
                                    device="cuda", joints=joints),
               make_step_fn(config, 6, False, joints=joints)):
        assert fn.graphed and fn.eager_reason == ""
        want = _eager(fn, start)
        before = pgs_kernel.pgs_solve.launches
        got = fn(start)
        torch.cuda.synchronize()
        assert pgs_kernel.pgs_solve.launches - before == 6
        _trees_equal(got, want, f"{scene} graphed")
        assert fn.graphs.captures


# ---------------------------------------------------------------------------
# CUDA graphs (utils/graphs.py): every graphed entry point bitwise its eager
# loop from the same state, at a small size
# ---------------------------------------------------------------------------

def _trees_equal(a, b, what):
    from rl_ode_physics_tpu_torch.utils import graphs
    la, da = graphs.flatten(a)
    lb, db = graphs.flatten(b)
    assert da == db, what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i}"


def _eager(fn, *args):
    from rl_ode_physics_tpu_torch.utils import graphs
    with graphs.disable_graphs():
        return fn(*args)


def _settled_bench_batch(worlds=64, settle=40):
    config = bench_config(64)
    batch = replicate(bench_world(config, device="cuda"), worlds,
                      device="cuda")
    batch = batch.replace(linvel=batch.linvel + 0.05 * torch.randn(
        batch.linvel.shape, generator=torch.Generator("cuda").manual_seed(3),
        device="cuda") * batch.dynamic[..., None])
    return config, _eager(make_batched_step_fn(config, settle,
                                               device="cuda"), batch)


@pytest.mark.cuda
@pytest.mark.parametrize("unroll,chunk,donate", [
    (1, 0, True), (4, 0, True), (10, 0, False), (3, 16, True),
    (10, 32, False)])
def test_graphed_batched_step_is_bitwise_eager_on_card(unroll, chunk,
                                                       donate):
    """10 substeps of the settled bench batch (64 worlds), graphed at each
    unroll (a remainder graph where 10 % unroll > 0), chunked or not,
    against the eager loop: every field bitwise; the compaction kernel
    counted once a substep a chunk, per replay."""
    _require_card()
    config, start = _settled_bench_batch()
    fn = make_batched_step_fn(config, 10, donate, chunk, unroll,
                              device="cuda")
    assert fn.graphed and fn.eager_reason == ""
    want = _eager(fn, start)
    before = compaction_kernel.compact_rows_t.launches
    got = fn(start)
    torch.cuda.synchronize()
    chunks = 64 // chunk if chunk else 1
    assert compaction_kernel.compact_rows_t.launches - before == 10 * chunks
    _trees_equal(got, want, "batched step")
    again = fn(got if donate else start)
    torch.cuda.synchronize()
    assert compaction_kernel.compact_rows_t.launches - before == 20 * chunks
    assert int(again.tick[0]) == int(start.tick[0]) + (20 if donate else 10)


@pytest.mark.cuda
def test_graphed_outputs_are_not_overwritten_with_donate_false():
    _require_card()
    config, start = _settled_bench_batch(16)
    fn = make_batched_step_fn(config, 4, False, unroll=4, device="cuda")
    first = fn(start)
    kept = first.pos.clone()
    second = fn(first)
    torch.cuda.synchronize()
    assert torch.equal(first.pos, kept)
    assert not torch.equal(second.pos, kept)
    assert int(second.tick[0]) == int(start.tick[0]) + 8


@pytest.mark.cuda
def test_donated_result_is_kept_by_a_call_on_other_tensors_on_card():
    """``a = f(x); b = f(y)``: the second call moves ``a`` off the graph's
    buffers first, so ``a`` keeps its values; ``f(b)`` steps in place."""
    _require_card()
    config, start = _settled_bench_batch(16)
    fn = make_batched_step_fn(config, 4, True, unroll=4, device="cuda")
    a = fn(start)
    kept = a.pos.clone()
    b = fn(start)
    torch.cuda.synchronize()
    assert torch.equal(a.pos, kept) and torch.equal(b.pos, kept)
    (capture,) = fn.graphs.captures.values()
    assert a.pos.data_ptr() != capture.carry[0].data_ptr()
    c = fn(b)
    torch.cuda.synchronize()
    assert c.pos.data_ptr() == b.pos.data_ptr() == capture.carry[0].data_ptr()
    assert torch.equal(a.pos, kept)
    assert int(c.tick[0]) == int(start.tick[0]) + 8


@pytest.mark.cuda
def test_new_shape_captures_anew_on_card():
    _require_card()
    config, start = _settled_bench_batch(16)
    fn = make_batched_step_fn(config, 2, True, unroll=2, device="cuda")
    fn(start)
    fn(start)
    assert len(fn.graphs.captures) == 1
    small = type(start)(**{k: v[:8].clone() for k, v in vars(start).items()})
    got = fn(small)
    _trees_equal(got, _eager(fn, small), "the 8-world capture")
    assert len(fn.graphs.captures) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["PGS", "DANTZIG"])
def test_pgs_and_dantzig_step_functions_run_eager_on_card(solver):
    """PGS's and DANTZIG's step functions replay graphs (the sweeps and the
    pivot loop are each one kernel that reads nothing on the host),
    bitwise their eager loop, with one kernel launch a substep. (The name
    is the test's history: DANTZIG ran eagerly before its pivot loop was a
    kernel.)"""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.core.world import make_step_fn
    from rl_ode_physics_tpu_torch.ops import lcp_kernel, pgs_kernel
    config = EngineConfig(max_bodies=16, max_pair_candidates=64,
                          max_contacts=96, solver=SolverKind[solver])
    for fn in (make_batched_step_fn(config, 2, device="cuda"),
               make_step_fn(config, 2)):
        assert fn.graphed and fn.eager_reason == ""
    batch = replicate(bench_world(config, num_bodies=10, device="cuda"), 4,
                      device="cuda")
    kernel = (pgs_kernel.pgs_solve if solver == "PGS"
              else lcp_kernel.lcp_pivot_solve)
    fn = make_batched_step_fn(config, 2, device="cuda")
    want = _eager(fn, batch)
    before = kernel.launches
    got = fn(batch)
    torch.cuda.synchronize()
    assert kernel.launches - before == 2
    _trees_equal(got, want, solver)
    assert fn.graphs.captures


@pytest.mark.cuda
def test_graphed_step_and_diagnostics_are_bitwise_eager_on_card():
    _require_card()
    from rl_ode_physics_tpu_torch.core.world import (
        make_diagnostics_step_fn, make_step_fn)
    config, start = _settled_bench_batch(16)
    fn = make_step_fn(config, 5, donate=False)
    assert fn.graphed
    _trees_equal(fn(start), _eager(fn, start), "make_step_fn")
    diag = make_diagnostics_step_fn(config)
    first = diag(start)
    _trees_equal(first, _eager(diag, start), "diagnostics step")
    assert int(first[1]["num_contacts"].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 8])
def test_graphed_env_is_bitwise_eager_on_card(chunk):
    """``advance``, ``step`` and ``rollout`` (lidar in the graph) of the
    rollout workload at 16 worlds, graphed and eager."""
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import rollout_config
    from rl_ode_physics_tpu_torch.models.workloads import (
        rollout_env, seeded_actions)
    env = rollout_env(rollout_config(64), 16, "cuda", chunk=chunk)
    assert env.graphed
    state, _ = env.reset(seed=1)
    state = _eager(env.rollout, state,
                   seeded_actions((20, 16, 2, 6), 1, "cuda"))[0]
    acts = seeded_actions((4, 16, 2, 6), 0, "cuda")
    _trees_equal(env.advance(state, acts[0]),
                 _eager(env.advance, state, acts[0]), "advance")
    first = env.step(state, acts[0])
    kept = [t.clone() for t in _flat(first)]
    _trees_equal(first, _eager(env.step, state, acts[0]), "step")
    env.step(state, acts[1])
    assert all(torch.equal(a, b) for a, b in zip(_flat(first), kept))
    _trees_equal(env.rollout(state, acts), _eager(env.rollout, state, acts),
                 "rollout")


def _flat(tree):
    from rl_ode_physics_tpu_torch.utils import graphs
    return graphs.flatten(tree)[0]


@pytest.mark.cuda
def test_graphed_es_step_is_bitwise_eager_on_card():
    _require_card()
    from rl_ode_physics_tpu_torch.examples.rl_training import make_trainer
    gen = torch.Generator().manual_seed(1)
    ew = (torch.randn((12, 6, 2), generator=gen) * 0.1).cuda()
    eb = (torch.randn((12, 2), generator=gen) * 0.1).cuda()
    params, step = make_trainer(pop=12, horizon=8, device="cuda")
    got = step.step_with_noise(params, ew, eb)
    _trees_equal(got, _eager(step.step_with_noise, params, ew, eb), "ES")
    _trees_equal(got, step.step_with_noise(params, ew, eb), "ES again")


@pytest.mark.cuda
@pytest.mark.parametrize("diagnostics", [False, True])
def test_graphed_simcore_replays_the_eager_digest_on_card(diagnostics):
    _require_card()
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.net.server import SimCore
    caps = dict(max_bodies=64, max_pair_candidates=256, max_contacts=512)
    config = EngineConfig.throughput(**caps)
    live = _server_session(SimCore(config, seed=0, player_capsules=True,
                                   diagnostics=diagnostics, device="cuda"))
    eager = _eager(_server_session, SimCore(
        config, seed=0, player_capsules=True, diagnostics=diagnostics,
        device="cuda"))
    assert live.state_digest() == eager.state_digest()
    if diagnostics:
        assert live.metrics.rows == eager.metrics.rows


@pytest.mark.cuda
def test_graphed_shards_of_the_card_are_bitwise_eager():
    _require_card()
    from rl_ode_physics_tpu_torch.parallel import mesh as pmesh
    config, batch = _mesh_test_batch("cuda")
    mesh = pmesh.make_mesh(["cuda:0", "cuda:0"])
    fn = pmesh.make_sharded_step_fn(config, mesh, substeps=3)
    assert fn.graphed
    got = pmesh.gather_batch(fn(pmesh.shard_batch(batch, mesh)))
    want = pmesh.gather_batch(_eager(fn, pmesh.shard_batch(batch, mesh)))
    _trees_equal(got, want, "two shards")


# last in the file: a capture that fails ends with its stream
@pytest.mark.cuda
def test_forced_capture_of_a_host_read_raises_on_card():
    """A ``graphs.Graphed`` body that reads the card from the host (an
    ``.item()`` a call, as DANTZIG's plain pivot loop reads "every world
    done" a round): the capture raises on the read, and nothing falls
    back to the eager loop."""
    _require_card()
    from rl_ode_physics_tpu_torch.utils import graphs
    calls = []

    def body(carry, _):
        calls.append(1)
        step = carry + 1.0
        if step.sum().item() > 0:          # the host read
            step = step * 2.0
        return step, None

    fn = graphs.Graphed(body, device="cuda")
    assert fn.graphed
    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError):
        fn(x, None, 2)
    torch.cuda.synchronize()
    graphs.release_all()
    # the warm-up ran the body eagerly once and the capture reached its
    # read: no eager loop ran after the failure
    assert len(calls) == 2
