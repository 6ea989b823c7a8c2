"""The port's trimesh path against the JAX package's, on the CPU.

Inputs come from numpy with a seed. Tolerances:

* the mesh bake, the OBJ loader and the ridge scene: bitwise;
* ``closest_point_triangle`` and the plain versions of the distance kernels
  against the jnp path: atol 1e-6 (the kernels' formula differs from the
  jnp path's in the order of its subtractions), plus rtol 1e-6 for the
  per-triangle squared distances, which reach 40 (a few f32 ulp);
* the plain kernel versions against the Pallas bodies run in interpret
  mode (``pl.pallas_call(..., interpret=True)`` with the BlockSpecs of
  ``pallas_kernels.py:120-133`` and ``:144-156``): rtol 1e-5, atol 1e-7
  (the same formula; XLA may contract a multiply and an add);
* contact candidates, ``mesh_narrowphase`` and the typed narrowphase with
  mesh rows: indices, validity and counts exact, geometry atol 1e-5. The
  one exception: a box's edge-clip candidates lie on the box surface, so
  their depth is 0 up to roundoff and XLA's contracted multiply-adds decide
  their validity otherwise than the port's separately rounded operations;
  ``box_tri_candidates`` is held exact outside |depth| <= 1e-6;
* the batched mesh step: pos/quat/linvel/angvel atol 1e-4 after 8
  substeps, tick, overflow and rng_state exact.

Where the JAX side reaches a Pallas kernel, ``use_pallas=True`` runs it
through a monkeypatch of ``pallas_kernels.sphere_mesh_d2_tiles`` /
``sphere_mesh_d2`` to the interpret-mode call.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.core.world import step as jax_step
from rl_ode_physics_tpu.models import builder as jax_builder
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu.ops import pallas_kernels as jax_pk
from rl_ode_physics_tpu.ops import trimesh as jax_tm
from rl_ode_physics_tpu.parallel.batch import replicate as jax_replicate
from rl_ode_physics_tpu.utils import objloader as jax_obj
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.core.config import SolverKind
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.models import builder as t_builder
from rl_ode_physics_tpu_torch.models import scenes as t_scenes
from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm
from rl_ode_physics_tpu_torch.ops import trimesh as tm
from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
from rl_ode_physics_tpu_torch.utils import bridge, objloader

from _torch_port import to_numpy

GEOM_ATOL = 1e-5
STEP_ATOL = 1e-4
EDGE_BAND = 1e-6    # |depth| of the edge-clip rows that roundoff decides


# ---------------------------------------------------------------------------
# The Pallas bodies in interpret mode, with pallas_kernels.py's BlockSpecs
# ---------------------------------------------------------------------------

def _interpret_d2_tiles(probes, v0t, e1t, e2t):
    p = probes.shape[0]
    t = v0t.shape[1]
    nt = t // 128
    assert p % jax_pk.PROBE_TILE == 0
    tri_spec = pl.BlockSpec((3, t), lambda i: (0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        jax_pk._d2_tiles_kernel,
        grid=(p // jax_pk.PROBE_TILE,),
        in_specs=[pl.BlockSpec((jax_pk.PROBE_TILE, 3), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  tri_spec, tri_spec, tri_spec],
        out_specs=pl.BlockSpec((jax_pk.PROBE_TILE, nt), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((p, nt), probes.dtype),
        interpret=True,
    )(probes, v0t, e1t, e2t)


def _interpret_d2(center, v0t, e1t, e2t):
    t = v0t.shape[1]
    assert t % jax_pk.BLOCK_TRIS == 0
    tri_spec = pl.BlockSpec((3, jax_pk.BLOCK_TRIS), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
    return pl.pallas_call(
        jax_pk._d2_kernel,
        grid=(t // jax_pk.BLOCK_TRIS,),
        in_specs=[pl.BlockSpec((1, 3), lambda i: (0, 0),
                               memory_space=pltpu.SMEM),
                  tri_spec, tri_spec, tri_spec],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((t // 128, 128), center.dtype),
        interpret=True,
    )(center[None, :], v0t, e1t, e2t)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX package's ``use_pallas=True`` paths reach the Pallas bodies
    in interpret mode."""
    monkeypatch.setattr(jax_pk, "sphere_mesh_d2_tiles", _interpret_d2_tiles)
    monkeypatch.setattr(jax_pk, "sphere_mesh_d2", _interpret_d2)


# ---------------------------------------------------------------------------
# Meshes and inputs
# ---------------------------------------------------------------------------

def bumpy_grid(n=8, size=6.0, amp=0.3):
    """A heightfield in the grid layout of ``tests/test_trimesh.py``:
    (n+1)² vertices, 2n² triangles, heights ``amp·sin(x)·cos(z)``."""
    xs = np.linspace(-size / 2, size / 2, n + 1)
    verts = np.array([[x, amp * np.sin(x) * np.cos(z), z]
                      for z in xs for x in xs], np.float64)
    tris = []
    for r in range(n):
        for c in range(n):
            i = r * (n + 1) + c
            tris.append([i, i + 1, i + n + 1])
            tris.append([i + 1, i + n + 2, i + n + 1])
    return verts, np.array(tris, np.int64)


def _random_tris(t, seed):
    """(3, T) f32 planes of random triangles around the origin."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2.0, 2.0, size=(t, 3))
    e1 = rng.normal(scale=0.7, size=(t, 3))
    e2 = rng.normal(scale=0.7, size=(t, 3))
    return [np.ascontiguousarray(a.T.astype(np.float32)) for a in (v0, e1, e2)]


def _both_meshes(verts, tris, slot=0, pad=1024):
    return (jax_tm.build_trimesh(verts, tris, slot=slot, pad_to_multiple=pad),
            tm.build_trimesh(verts, tris, slot=slot, pad_to_multiple=pad,
                             device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [1, 128, 1024])
def test_build_trimesh_bitwise(pad):
    verts, tris = bumpy_grid(n=9)                      # 162 triangles
    ref, got = _both_meshes(verts, tris, slot=3, pad=pad)
    got = bridge.trimesh_to_numpy(got)
    for name, r in to_numpy(ref).items():
        assert got[name].dtype == r.dtype, name
        assert np.array_equal(got[name], r), name
    assert got["v0"].shape[0] % pad == 0


def test_trimesh_bridge_roundtrip():
    verts, tris = bumpy_grid(n=4)
    ref, got = _both_meshes(verts, tris, slot=2)
    back = bridge.trimesh_from_numpy(to_numpy(ref), device="cpu")
    for name in ("v0", "e1", "e2", "normal"):
        assert torch.equal(getattr(back, name), getattr(got, name)), name
    assert back.slot == got.slot == 2


REGION_CASES = [
    ([0.25, 0.25, 1.0], [0.25, 0.25, 0.0]),   # interior
    ([-1.0, -1.0, 0.0], [0.0, 0.0, 0.0]),     # vertex A
    ([2.0, -0.5, 0.0], [1.0, 0.0, 0.0]),      # vertex B
    ([-0.5, 2.0, 0.0], [0.0, 1.0, 0.0]),      # vertex C
    ([0.5, -1.0, 0.0], [0.5, 0.0, 0.0]),      # edge AB
    ([-1.0, 0.5, 0.0], [0.0, 0.5, 0.0]),      # edge AC
    ([1.0, 1.0, 0.0], [0.5, 0.5, 0.0]),       # edge BC
]


def test_closest_point_triangle_regions():
    v0 = torch.tensor([[0.0, 0.0, 0.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0]])
    e2 = torch.tensor([[0.0, 1.0, 0.0]])
    for p, expected in REGION_CASES:
        got = tm.closest_point_triangle(torch.tensor(p), v0, e1, e2)[0]
        ref = jax_tm.closest_point_triangle(
            jnp.asarray(p), jnp.asarray(v0.numpy()), jnp.asarray(e1.numpy()),
            jnp.asarray(e2.numpy()))[0]
        np.testing.assert_allclose(got.numpy(), expected, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_closest_point_triangle_random():
    rng = np.random.default_rng(5)
    p = rng.uniform(-3.0, 3.0, size=(512, 3)).astype(np.float32)
    v0t, e1t, e2t = _random_tris(512, seed=6)
    args = [p, v0t.T, e1t.T, e2t.T]
    ref = jax_tm.closest_point_triangle(*map(jnp.asarray, args))
    got = tm.closest_point_triangle(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# The plain versions of the two kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4096, 7])
def test_d2_tiles_plain_matches_pallas_body(chunk):
    rng = np.random.default_rng(11)
    probes = rng.uniform(-3.0, 3.0, size=(48, 3)).astype(np.float32)
    tris = _random_tris(384, seed=12)
    ref = np.asarray(_interpret_d2_tiles(*map(jnp.asarray, [probes, *tris])))
    got = tm.sphere_mesh_d2_tiles_plain(*map(_t, [probes, *tris]),
                                        chunk=chunk).numpy()
    assert got.shape == (48, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)

    # against the jnp path of mesh_narrowphase (trimesh.py:519-523)
    v0, e1, e2 = (jnp.asarray(x.T) for x in tris)
    closest = jax.vmap(
        lambda c: jax_tm.closest_point_triangle(c, v0, e1, e2))(
            jnp.asarray(probes))
    d2 = jnp.sum((closest - jnp.asarray(probes)[:, None, :]) ** 2, -1)
    jnp_ref = np.asarray(jnp.min(d2.reshape(48, 3, 128), axis=-1))
    np.testing.assert_allclose(got, jnp_ref, atol=1e-6, rtol=0)


def test_d2_plain_matches_pallas_body():
    rng = np.random.default_rng(13)
    tris = _random_tris(2048, seed=14)
    jtris = [jnp.asarray(x) for x in tris]
    v0, e1, e2 = (jnp.asarray(x.T) for x in tris)
    for center in rng.uniform(-3.0, 3.0, size=(6, 3)).astype(np.float32):
        ref = np.asarray(_interpret_d2(jnp.asarray(center), *jtris))
        got = tm.sphere_mesh_d2_plain(_t(center), *map(_t, tris)).numpy()
        assert got.shape == (16, 128)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
        closest = jax_tm.closest_point_triangle(jnp.asarray(center), v0, e1,
                                                e2)
        jnp_ref = np.asarray(jnp.sum((closest - center) ** 2, -1))
        np.testing.assert_allclose(got.reshape(-1), jnp_ref, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("chunk", [2048, 4])
def test_d2_plain_batch_equals_loop_over_centres(chunk):
    """(C, 3) centres in one call, the form one kernel launch takes: each
    centre's rows are exactly the (3,) call's, across chunk borders."""
    rng = np.random.default_rng(15)
    tris = list(map(_t, _random_tris(512, seed=16)))
    centers = _t(rng.uniform(-3.0, 3.0, size=(10, 3)).astype(np.float32))
    got = tm.sphere_mesh_d2_plain(centers, *tris, chunk=chunk)
    assert got.shape == (10, 4, 128)
    for c, rows in zip(centers, got):
        assert torch.equal(rows, tm.sphere_mesh_d2_plain(c, *tris))
    assert tm.sphere_mesh_d2_plain(centers[:1], *tris).shape == (1, 4, 128)


# ---------------------------------------------------------------------------
# The CUDA kernel's operation order against the plain version's
# ---------------------------------------------------------------------------

D2_RTOL, D2_ATOL = 1e-5, 1e-6    # what the card holds the kernels to


def _kernel_order_mesh():
    """A bumpy grid of 1,058 triangles padded to 2,048: tiles 0..7 real,
    tile 8 mixed, tiles 9..15 padding only."""
    verts, tris = bumpy_grid(n=23)
    mesh = tm.build_trimesh(verts, tris, pad_to_multiple=1024, device="cpu")
    return mesh, len(tris)


def _kernel_order_probes(case, mesh, real):
    """(P, 3) f32 probes of one case, from a seed."""
    rng = np.random.default_rng(31)
    pick = rng.integers(0, real, size=96)
    v0, e1, e2 = (x[pick].numpy().astype(np.float64)
                  for x in (mesh.v0, mesh.e1, mesh.e2))
    box = rng.uniform([-3.5, -0.5, -3.5], [3.5, 1.5, 3.5], size=(96, 3))
    u = rng.uniform(0.0, 1.0, size=(96, 1))
    if case == "random":
        p = box
    elif case == "vertices":
        p = np.concatenate([v0, v0 + e1, v0 + e2])
    elif case == "edges":
        p = np.concatenate([v0 + u * e1, v0 + u * e2,
                            v0 + e1 + u * (e2 - e1), v0 + 0.5 * e1])
    elif case == "surface":
        w = rng.uniform(0.0, 1.0, size=(96, 1)) * (1.0 - u)
        p = v0 + u * e1 + w * e2
    elif case == "plane_outside":
        vw = rng.uniform(-2.0, 3.0, size=(400, 2))
        vw = vw[(vw.min(1) < 0) | (vw.sum(1) > 1)][:96]
        p = v0 + vw[:, :1] * e1 + vw[:, 1:] * e2
    elif case == "far":
        p = box + [0.0, 100.0, 0.0]
    elif case == "padded":
        p = np.concatenate([box, [[1e9, 1e9, 1e9]]])
    elif case == "nan":
        p = box[:6].copy()
        p[[0, 1, 2], [0, 1, 2]] = np.nan
        p[3] = np.nan
    return torch.from_numpy(p.astype(np.float32))


def _pair_d2(fn, probes, mesh):
    """(P, T) squared distances of every probe to every triangle."""
    p = tuple(probes[:, c:c + 1] for c in range(3))
    tris = [tuple(x[:, c][None, :] for c in range(3))
            for x in (mesh.v0, mesh.e1, mesh.e2)]
    return fn(p, *tris)


KERNEL_ORDER_CASES = ["random", "vertices", "edges", "surface",
                      "plane_outside", "far", "padded", "nan"]


@pytest.mark.parametrize("case", KERNEL_ORDER_CASES)
def test_d2_kernel_order_matches_plain_order(case):
    """The CUDA kernel's arithmetic (per-triangle a, b, c and reciprocals,
    folded regions) against the plain version's, pair by pair, padded
    triangles included. They round differently, and a probe on a region
    border may take another region's formula: the squared distance is
    continuous there, so rtol 1e-5, atol 1e-6."""
    mesh, real = _kernel_order_mesh()
    probes = _kernel_order_probes(case, mesh, real)
    ref = _pair_d2(tm._d2_pallas_order, probes, mesh)
    got = _pair_d2(tm._d2_kernel_order, probes, mesh)
    assert got.shape == ref.shape == (probes.shape[0], mesh.num_tris)
    if case == "padded":
        ref, got = ref[:, real:], got[:, real:]
        assert float(got[-1].max()) == 0.0       # the probe at the far point
    if case == "nan":
        assert bool(torch.isnan(got[:4]).all())
        assert bool(torch.isnan(ref[:4]).all())
        assert bool(torch.isfinite(got[4:]).all())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=D2_RTOL,
                               atol=D2_ATOL, equal_nan=True)


@pytest.mark.parametrize("case", KERNEL_ORDER_CASES)
def test_d2_kernel_order_matches_plain_order_in_float64(case):
    """The same in float64, the kernels' float64 instances' arithmetic:
    within the float64 tolerance the card holds them to (rtol 1e-12, atol
    1e-13), padded triangles included."""
    mesh, real = _kernel_order_mesh()
    mesh = tm.TriMesh(**{**vars(mesh), **{
        name: getattr(mesh, name).double()
        for name in ("v0", "e1", "e2", "normal")}})
    probes = _kernel_order_probes(case, mesh, real).double()
    ref = _pair_d2(tm._d2_pallas_order, probes, mesh)
    got = _pair_d2(tm._d2_kernel_order, probes, mesh)
    assert got.dtype == ref.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-13, equal_nan=True)


@pytest.mark.parametrize("case", KERNEL_ORDER_CASES[:-1])
def test_d2_kernel_order_keeps_the_nearest_tiles(case):
    """``mesh_narrowphase`` keeps the 8 nearest tiles of each probe: both
    operation orders choose the same 8, as a set."""
    mesh, real = _kernel_order_mesh()
    probes = _kernel_order_probes(case, mesh, real)
    nt = mesh.num_tris // tm.MESH_TILE
    sets = []
    for fn in (tm._d2_pallas_order, tm._d2_kernel_order):
        tiles = _pair_d2(fn, probes, mesh).reshape(-1, nt, tm.MESH_TILE)
        near = tm._top_k_smallest(tiles.amin(-1), tm.CAND_TILES)
        sets.append(torch.sort(near, dim=-1).values)
    assert torch.equal(sets[0], sets[1])


# ---------------------------------------------------------------------------
# Contacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 12])
def test_sphere_mesh_contacts_matches_jax(k, interpret_pallas):
    """k=12 asks for more contacts than the mesh has tiles (8)."""
    verts, tris = bumpy_grid(n=20, size=8.0, amp=0.4)     # 800 → 1024 tris
    jmesh, tmesh = _both_meshes(verts, tris)
    rng = np.random.default_rng(k)
    centers = np.concatenate([
        rng.uniform([-3.5, -0.2, -3.5], [3.5, 0.6, 3.5], size=(5, 3)),
        [[0.3, 2.0, 0.2]]]).astype(np.float32)           # one far above
    n_valid = 0
    batch = tm.sphere_mesh_contacts(_t(centers), 0.5, tmesh, k=k)
    assert [tuple(x.shape) for x in batch] == [(6, k, 3), (6, k, 3), (6, k),
                                               (6, k)]
    for i, c in enumerate(centers):
        ref = jax_tm.sphere_mesh_contacts(jnp.asarray(c), 0.5, jmesh, k=k,
                                          use_pallas=True)
        got = tm.sphere_mesh_contacts(_t(c), 0.5, tmesh, k=k)
        rv = np.asarray(ref[3])
        assert np.array_equal(got[3].numpy(), rv)
        n_valid += int(rv.sum())
        for r, g in zip(ref[:3], got[:3]):
            np.testing.assert_allclose(g.numpy()[rv], np.asarray(r)[rv],
                                       atol=GEOM_ATOL, rtol=0)
        # the whole query in one call is the loop over its centres
        for g, b in zip(got, batch):
            assert torch.equal(g, b[i])
    assert n_valid >= 5


def test_sphere_mesh_contacts_batch_matches_jax_vmap(interpret_pallas):
    """(C, 3) centres with a radius each against ``jax.vmap`` over the JAX
    function, the Pallas body in interpret mode."""
    verts, tris = bumpy_grid(n=20, size=8.0, amp=0.4)
    jmesh, tmesh = _both_meshes(verts, tris)
    rng = np.random.default_rng(21)
    centers = rng.uniform([-3.5, -0.2, -3.5], [3.5, 0.6, 3.5],
                          size=(9, 3)).astype(np.float32)
    radii = rng.uniform(0.3, 0.7, size=9).astype(np.float32)
    ref = jax.vmap(lambda c, r: jax_tm.sphere_mesh_contacts(
        c, r, jmesh, k=4, use_pallas=True))(jnp.asarray(centers),
                                            jnp.asarray(radii))
    got = tm.sphere_mesh_contacts(_t(centers), _t(radii), tmesh, k=4)
    rv = np.asarray(ref[3])
    assert np.array_equal(got[3].numpy(), rv) and rv.sum() >= 9
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy()[rv], np.asarray(r)[rv],
                                   atol=GEOM_ATOL, rtol=0)
    for i in range(9):
        one = tm.sphere_mesh_contacts(_t(centers[i]), float(radii[i]), tmesh,
                                      k=4)
        for g, b in zip(one, got):
            assert torch.equal(g, b[i])


def _random_box_tri(count, seed):
    """Boxes around triangles, half of them axis-aligned with axis-aligned
    triangle edges, so that slab clips divide by zero (±inf rows)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, size=(count, 3))
    q = rng.normal(size=(count, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[::2] = [1.0, 0.0, 0.0, 0.0]
    half = rng.uniform(0.2, 0.6, size=(count, 3))
    v0 = rng.uniform(-0.8, 0.8, size=(count, 3))
    e1 = rng.normal(scale=0.8, size=(count, 3))
    e2 = rng.normal(scale=0.8, size=(count, 3))
    e1[::2] = [1.2, 0.0, 0.0]
    e2[::2] = [0.0, 0.0, 1.1]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return [a.astype(np.float32) for a in (pos, q, half, v0, e1, e2, n)]


def _quat_matrix(q):
    from rl_ode_physics_tpu.utils import quat as jax_quat
    return np.asarray(jax_quat.to_matrix(jnp.asarray(q)))


def test_box_tri_candidates_matches_jax():
    pos, q, half, v0, e1, e2, n = _random_box_tri(256, seed=21)
    r = _quat_matrix(q)
    args = [pos, r, half, v0, e1, e2, n]
    ref = jax.jit(jax.vmap(jax_tm.box_tri_candidates))(
        *map(jnp.asarray, args))
    got = tm.box_tri_candidates(*map(_t, args))
    rv, gv = np.asarray(ref[3]), got[3].numpy()
    # the rows that are not valid hold non-finite points and depths in the
    # same places (their normals are picked by index here, by a one-hot
    # sum that turns 0·inf into NaN there)
    for i in (0, 2):
        assert np.array_equal(np.isfinite(got[i].numpy()),
                              np.isfinite(np.asarray(ref[i])))
    assert not np.isfinite(np.asarray(ref[2])).all()    # inf rows present
    # an edge-clip endpoint lies on the box surface, so its depth is 0 up
    # to roundoff, and XLA's contracted multiply-adds round otherwise than
    # the port's separate operations: validity is exact outside that band
    clear = ~(np.abs(np.nan_to_num(np.asarray(ref[2]))) <= EDGE_BAND)
    assert np.array_equal(gv[clear], rv[clear])
    assert (np.abs(got[2].numpy()[gv != rv]) <= EDGE_BAND).all()
    assert rv[:, :8].sum() > 20 and rv[:, 8:11].sum() > 5
    both = rv & gv
    for r_, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy()[both], np.asarray(r_)[both],
                                   atol=GEOM_ATOL, rtol=0)


def test_capsule_tri_candidate_matches_jax():
    rng = np.random.default_rng(31)
    count = 256
    p0 = rng.uniform(-0.6, 0.6, size=(count, 3))
    p1 = p0 + rng.normal(scale=0.6, size=(count, 3))
    radius = rng.uniform(0.1, 0.5, size=(count,))
    _, _, _, v0, e1, e2, n = _random_box_tri(count, seed=32)
    args = [a.astype(np.float32) for a in (p0, p1, radius, v0, e1, e2, n)]
    ref = jax.jit(jax.vmap(jax_tm.capsule_tri_candidate))(
        *map(jnp.asarray, args))
    got = tm.capsule_tri_candidate(*map(_t, args))
    rv = np.asarray(ref[3])
    assert np.array_equal(got[3].numpy(), rv)
    assert 20 < rv.sum() < count
    for r_, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy()[rv], np.asarray(r_)[rv],
                                   atol=GEOM_ATOL, rtol=0)


def test_dedup_deepest_k_matches_jax():
    """Candidates with exact duplicates and equal depths: ties go to the
    first index on both sides."""
    rng = np.random.default_rng(41)
    bodies, m, k = 16, 40, 4
    pts = rng.uniform(-0.5, 0.5, size=(bodies, m, 3))
    pts[:, 20:30] = pts[:, 0:10]                         # duplicates
    nrm = rng.normal(size=(bodies, m, 3))
    dep = np.round(rng.uniform(-0.05, 0.1, size=(bodies, m)), 2)
    val = (dep > 0) & (rng.uniform(size=(bodies, m)) < 0.8)
    val[3] = False                                       # no candidate
    dep = np.where(val, dep, 0.0)
    pts = np.where(val[..., None], pts, 0.0)
    dedup_r = rng.uniform(0.05, 0.3, size=(bodies,))
    args = [a.astype(np.float32) for a in (pts, nrm, dep)] + [val]
    ref = jax.vmap(jax_tm._dedup_deepest_k, in_axes=(0, 0, 0, 0, None, 0))(
        *map(jnp.asarray, args), k, jnp.asarray(dedup_r, jnp.float32))
    got = tm._dedup_deepest_k(*map(_t, args), k,
                              _t(dedup_r.astype(np.float32)))
    for r_, g in zip(ref, got):
        assert np.array_equal(g.numpy(), np.asarray(r_))


# ---------------------------------------------------------------------------
# mesh_narrowphase and the typed narrowphase with mesh rows
# ---------------------------------------------------------------------------

def _ridge_in_contact(probes):
    """The ridge scene (sphere, box, capsule) with every body pressed into
    the mesh: (JAX config, port config, JAX state, JAX mesh)."""
    kw = dict(max_bodies=8, max_pair_candidates=16, max_contacts=64,
              enable_planes=False, enable_capsules=True, mesh_probes=probes)
    jcfg, tcfg = JaxConfig.throughput(**kw), TorchConfig.throughput(**kw)
    jstate, jmesh = jax_scenes.ridge_mesh_scene(jcfg)
    arrays = {k: v.copy() for k, v in to_numpy(jstate).items()}
    tilt = np.array([np.cos(0.2), 0.0, 0.0, np.sin(0.2)], np.float32)
    arrays["pos"][1] = [-0.6, 0.35, 0.4]       # ground height 0.1, r=0.3
    arrays["pos"][2] = [0.2, 0.3, -0.5]        # straddles the valley floor
    arrays["quat"][2] = tilt
    arrays["pos"][3] = [0.6, 0.3, 0.2]         # lies along x, into a ridge
    return jcfg, tcfg, arrays, jmesh


@pytest.mark.parametrize("probes", [1, 3])
def test_mesh_narrowphase_matches_jax(probes, interpret_pallas):
    jcfg, tcfg, arrays, jmesh = _ridge_in_contact(probes)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ref = jax.jit(lambda s: jax_tm.mesh_narrowphase(
        s, jmesh, jcfg, use_pallas=True))(jstate)
    got = tm.mesh_narrowphase(
        bridge.world_from_numpy(arrays, device="cpu"),
        bridge.trimesh_from_numpy(to_numpy(jmesh), device="cpu"), tcfg)
    ref = [np.asarray(x) for x in ref]
    got = [x[0].numpy() for x in got]
    rv = ref[5]
    for i in (3, 4, 5):                               # a, b, valid
        assert np.array_equal(got[i], ref[i]), i
    for i in (0, 1, 2):                               # points, normals, depths
        np.testing.assert_allclose(got[i][rv], ref[i][rv], atol=GEOM_ATOL,
                                   rtol=0)
    # the sphere, the box and the capsule all touch the mesh
    touching = set(ref[3][rv].tolist())
    assert touching == {1, 2, 3}, touching


# ---------------------------------------------------------------------------
# The step with a mesh
# ---------------------------------------------------------------------------

MESH_KW = dict(max_bodies=16, max_pair_candidates=32, max_contacts=128,
               enable_planes=False, enable_capsules=False,
               solver_matmul_dtype="float32", pallas_compaction=True)


def egg_crate(n=24, size=8.0, amp=0.15):
    """A heightfield ``amp·cos(2x)·cos(2z)`` in the grid layout of
    ``bumpy_grid``: dimples at (0, ±π/2), (±π/2, 0) and their repeats."""
    verts, tris = bumpy_grid(n=n, size=size, amp=0.0)
    verts[:, 1] = amp * np.cos(2 * verts[:, 0]) * np.cos(2 * verts[:, 2])
    return verts, tris


# (type, x, z): each body drops into its own dimple of the egg crate. Every
# box comes to rest on its four bottom corners; a box resting on fewer
# real contacts would fill its manifold with edge-clip candidates, whose
# validity roundoff decides (see the module docstring)
DIMPLES = [(BodyType.BOX, 0.0, np.pi / 2), (BodyType.SPHERE, 0.0, -np.pi / 2),
           (BodyType.BOX, np.pi / 2, 0.0), (BodyType.SPHERE, -np.pi / 2, 0.0),
           (BodyType.BOX, -np.pi / 2, np.pi), (BodyType.SPHERE, np.pi / 2,
                                                 -np.pi)]


def _mesh_world(builder_cls, config, mesh_slot_out):
    """Spheres and boxes dropped into the dimples of the egg crate."""
    b = builder_cls(config, 0)
    slot = b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    b.body_type[slot] = int(BodyType.TRIMESH)
    for kind, x, z in DIMPLES:
        if kind == BodyType.SPHERE:
            b.add_body(BodyType.SPHERE, (x, 0.3, z), (0.25, 0.0, 0.0))
        else:
            b.add_body(BodyType.BOX, (x, 0.2, z), (0.5, 0.3, 0.5))
    mesh_slot_out.append(slot)
    return b


@functools.lru_cache(maxsize=1)
def _settled_mesh_batch(substeps=120):
    """2 worlds of the egg-crate scene after ``substeps`` JAX substeps (the
    jnp sweep), the second world's spheres pushed down a little: numpy
    arrays, and the mesh's."""
    jcfg = JaxConfig.throughput(**MESH_KW, selector_dtype="float32")
    slot = []
    world = _mesh_world(jax_builder.WorldBuilder, jcfg, slot).finish()
    verts, tris = egg_crate()                         # 1,152 tris, 9 tiles
    jmesh = jax_tm.build_trimesh(verts, tris, slot=slot[0],
                                 pad_to_multiple=128)
    fn = jax.jit(jax.vmap(lambda s: jax_step(s, jcfg, jmesh,
                                             use_pallas=False)))
    batch = jax_replicate(world, 2)
    for _ in range(substeps):
        batch = fn(batch)
    arrays = {k: v.copy() for k, v in to_numpy(batch).items()}
    spheres = arrays["body_type"][1] == int(BodyType.SPHERE)
    arrays["linvel"][1, spheres, 1] -= np.float32(0.05)
    return arrays, to_numpy(jmesh)


def test_mesh_scene_builders_match_jax():
    jcfg = JaxConfig.throughput(**MESH_KW)
    tcfg = TorchConfig.throughput(**MESH_KW)
    jw = _mesh_world(jax_builder.WorldBuilder, jcfg, []).finish()
    tw = _mesh_world(t_builder.WorldBuilder, tcfg, []).finish("cpu")
    got = bridge.world_to_numpy(tw, 0)
    for name, r in to_numpy(jw).items():
        assert np.array_equal(got[name], r), name
    kw = dict(MESH_KW, enable_capsules=True)
    js, jm = jax_scenes.ridge_mesh_scene(JaxConfig.throughput(**kw))
    ts, tmesh = t_scenes.ridge_mesh_scene(TorchConfig.throughput(**kw),
                                          device="cpu")
    got = bridge.world_to_numpy(ts, 0)
    for name, r in to_numpy(js).items():
        assert np.array_equal(got[name], r), name
    got = bridge.trimesh_to_numpy(tmesh)
    for name, r in to_numpy(jm).items():
        assert np.array_equal(got[name], r), name


@pytest.mark.parametrize("sel", ["float32", "bfloat16"])
def test_narrowphase_with_mesh_rows_matches_jax(sel, interpret_pallas):
    jcfg = JaxConfig.throughput(**MESH_KW, selector_dtype=sel)
    tcfg = TorchConfig.throughput(**MESH_KW, selector_dtype=sel)
    arrays, mesh_arrays = _settled_mesh_batch()
    one = {k: v[0] for k, v in arrays.items()}
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in one.items()})
    jmesh = jax_tm.TriMesh(**{k: jnp.asarray(v)
                              for k, v in mesh_arrays.items()})

    def jax_contacts(s):
        extra = jax_tm.mesh_narrowphase(s, jmesh, jcfg, use_pallas=True)
        return jax_cm.narrowphase_typed_cm(s, jcfg, extra)

    ref, ref_pairs = jax.jit(jax_contacts)(jstate)
    tstate = bridge.world_from_numpy(one, device="cpu")
    tmesh = bridge.trimesh_from_numpy(mesh_arrays, device="cpu")
    got, got_pairs = t_cm.narrowphase_typed_cm(
        tstate, tcfg, tm.mesh_narrowphase(tstate, tmesh, tcfg))
    ref, got = to_numpy(ref), bridge.contacts_to_numpy(got, 0)
    for name in ("a", "b", "valid", "key", "count", "overflow"):
        assert np.array_equal(got[name], ref[name]), name
    valid = ref["valid"]
    for name in ("point", "normal", "depth"):
        np.testing.assert_allclose(got[name][valid], ref[name][valid],
                                   atol=GEOM_ATOL, rtol=0, err_msg=name)
    assert int(got_pairs[0]) == int(ref_pairs)
    mesh_rows = valid & (ref["b"] == mesh_arrays["slot"])
    assert mesh_rows.sum() >= 6 and (ref["key"][mesh_rows] == -1).all()
    assert ref["overflow"] == 0


@pytest.mark.parametrize("sel", ["bfloat16", "float32"])
def test_batched_mesh_step_matches_jax(sel, interpret_pallas):
    jcfg = JaxConfig.throughput(**MESH_KW, selector_dtype=sel)
    tcfg = TorchConfig.throughput(**MESH_KW, selector_dtype=sel)
    arrays, mesh_arrays = _settled_mesh_batch()
    jmesh = jax_tm.TriMesh(**{k: jnp.asarray(v)
                              for k, v in mesh_arrays.items()})
    jfn = jax.jit(jax.vmap(lambda s: jax_step(s, jcfg, jmesh,
                                              use_pallas=True)))
    tfn = make_batched_step_fn(
        tcfg, substeps=1, device="cpu",
        trimesh=bridge.trimesh_from_numpy(mesh_arrays, device="cpu"))
    jbatch = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tbatch = bridge.world_from_numpy(arrays, device="cpu")
    for _ in range(8):
        jbatch = jfn(jbatch)
        tbatch = tfn(tbatch)
    ref, got = to_numpy(jbatch), bridge.world_to_numpy(tbatch)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=STEP_ATOL,
                                   rtol=0, err_msg=name)
    for name in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[name], ref[name]), name
    assert (got["tick"] == 128).all() and (got["overflow"] == 0).all()
    # the bodies rest on the mesh: none has fallen through it
    dyn = arrays["inv_mass"][0] > 0
    assert (got["pos"][:, dyn, 1] > -0.5).all()


def test_mesh_step_with_capsules_raises(tmp_path):
    """A capsule on the mesh steps now that its pair kernels are ported,
    and, now that the port has DANTZIG, the ridge mesh scene steps under it
    like the JAX step (the name is the test's history). DANTZIG is held in
    float64 (``tests/_traj_engine.py ridge_mesh … dantzig`` in a
    subprocess, JAX's x64 mode being process-global): 16 steps within
    1e-9. In float32 the direct solve's friction rows on a mesh amplify
    roundoff to about 1e-5 of the velocities."""
    _, tcfg, arrays, jmesh = _ridge_in_contact(3)
    mesh = bridge.trimesh_from_numpy(to_numpy(jmesh), device="cpu")
    state = make_batched_step_fn(tcfg, device="cpu", trimesh=mesh)(
        bridge.world_from_numpy(arrays, device="cpu"))
    assert bool(torch.isfinite(state.pos).all())

    from test_torch_x64 import (REPO, SUBPROCESS_ENV, TOL, _config,
                                _initial_state)
    steps = 16
    out = tmp_path / "ridge_dantzig.npz"
    r = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_traj_engine.py"),
         "ridge_mesh", str(out), str(steps), "dantzig"],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=SUBPROCESS_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    data = np.load(out)
    config = _config("dantzig")
    assert config.solver is SolverKind.DANTZIG
    tstate = _initial_state(data, config)
    mesh = bridge.trimesh_from_numpy(
        {k: data[f"mesh_{k}"] for k in ("v0", "e1", "e2", "normal", "slot")},
        device="cpu")
    step = make_batched_step_fn(config, device="cpu", trimesh=mesh)
    for i in range(steps):
        tstate = step(tstate)
        for name in ("pos", "quat"):
            err = float(np.abs(getattr(tstate, name)[0].numpy()
                               - data[name][i]).max())
            assert err <= TOL, (i, name, err)
    assert int(tstate.overflow[0]) == 0
    assert np.abs(data["pos"][-1] - data["init_pos"]).max() > 0.01


def test_mesh_step_with_capsule_matches_jax(interpret_pallas):
    """The ridge scene's sphere and capsule pressed into the mesh (its box
    taken out: a box on the ridge rests on edge-clip rows, whose validity
    roundoff decides), 8 substeps on each side within 1e-4."""
    jcfg, tcfg, arrays, jmesh = _ridge_in_contact(3)
    arrays = {k: v.copy() for k, v in arrays.items()}
    arrays["body_type"][2] = int(BodyType.NULL)
    fn = jax.jit(lambda s: jax_step(s, jcfg, jmesh, use_pallas=True))
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tfn = make_batched_step_fn(
        tcfg, device="cpu",
        trimesh=bridge.trimesh_from_numpy(to_numpy(jmesh), device="cpu"))
    tstate = bridge.world_from_numpy(arrays, device="cpu")
    for _ in range(8):
        jstate = fn(jstate)
        tstate = tfn(tstate)
    ref, got = to_numpy(jstate), bridge.world_to_numpy(tstate, 0)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=STEP_ATOL,
                                   rtol=0, err_msg=name)
    for name in ("tick", "overflow"):
        assert np.array_equal(got[name], ref[name]), name
    # the capsule was pushed out of the ridge it was pressed into
    assert ref["linvel"][3, 1] > 0.1


def test_mesh_on_other_device_than_state_raises():
    _, tcfg, arrays, jmesh = _ridge_in_contact(3)
    mesh = bridge.trimesh_from_numpy(to_numpy(jmesh), device="meta")
    with pytest.raises(ValueError):
        tm.mesh_narrowphase(bridge.world_from_numpy(arrays, device="cpu"),
                            mesh, tcfg)


def test_objloader_matches_jax(tmp_path):
    """Quads, negative indices and v/vt/vn forms, read by both loaders."""
    path = tmp_path / "quad.obj"
    path.write_text("\n".join([
        "# two faces", "v 0 0 0", "v 1 0 0", "v 1 0 1", "v 0 0 1",
        "v 0.5 1 0.5", "vt 0 0", "vn 0 1 0",
        "f 1/1/1 2/1/1 3/1/1 4/1/1", "f -1 -4 -3", ""]))
    ref = jax_obj.load_obj(str(path))
    got = objloader.load_obj(str(path))
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert got[1].shape == (3, 3)
