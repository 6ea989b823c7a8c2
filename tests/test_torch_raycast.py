"""The port's ray queries against the JAX package's, on the CPU.

Scenes and rays come from numpy with a seed; the state is built by the JAX
package's ``WorldBuilder`` and carried over through ``utils/bridge``, so
both sides cast at the same numbers. Tolerances: ``hit`` and ``body``
exact; ``t``, ``point`` and ``normal`` at atol 1e-5 (the arithmetic is the
same, plane for plane; XLA may contract a multiply and an add on the CPU,
and t reaches 20 m, a few f32 ulp). The analytic cases of
``tests/test_raycast.py`` are repeated here against both their closed-form
answers and the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.state import BodyType, WorldState as JaxState
from rl_ode_physics_tpu.models.builder import WorldBuilder as JaxBuilder
from rl_ode_physics_tpu.ops import raycast as jax_rc
from rl_ode_physics_tpu.ops import trimesh as jax_tm
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.models.scenes import ridge_mesh_geometry
from rl_ode_physics_tpu_torch.ops import raycast as rc
from rl_ode_physics_tpu_torch.ops import trimesh as tm
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import to_numpy

ATOL = 1e-5
KW = dict(max_bodies=8, max_pair_candidates=32, max_contacts=32,
          enable_capsules=True)
JCFG, TCFG = JaxConfig(**KW), TorchConfig(**KW)


def _world(*bodies, kw=KW):
    """(JAX one-world state, the same state as the port's B=1 batch);
    bodies are (type, pos, size) or (type, pos, size, quat)."""
    b = JaxBuilder(JaxConfig(**kw), 0)
    for body in bodies:
        b.add_body(*body)
    jstate = b.finish()
    return jstate, bridge.world_from_numpy(to_numpy(jstate), device="cpu")


def _both(jstate, tstate, origins, dirs, jcfg=JCFG, tcfg=TCFG, **kw):
    """(JAX hits as numpy, port hits of world 0 as numpy), held to each
    other at the file's tolerances."""
    origins = np.asarray(origins, np.float32)
    dirs = np.asarray(dirs, np.float32)
    ref = to_numpy(jax_rc.raycast(jstate, origins, dirs, jcfg, **kw))
    hits = rc.raycast(tstate, torch.from_numpy(origins),
                      torch.from_numpy(dirs), tcfg, **kw)
    got = {f: getattr(hits, f)[0].numpy() for f in ref}
    _hold(got, ref)
    return ref, got


def _hold(got, ref):
    assert np.array_equal(got["hit"], ref["hit"])
    assert np.array_equal(got["body"], ref["body"])
    assert got["body"].dtype == ref["body"].dtype == np.int32
    for name in ("t", "point", "normal"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_ray_sphere_analytic():
    ref, got = _both(*_world((BodyType.SPHERE, (0.0, 0.0, 5.0),
                              (1.0, 0.0, 0.0))),
                     [[0.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]])
    assert bool(got["hit"][0]) and int(got["body"][0]) == 0
    assert abs(float(got["t"][0]) - 4.0) < 1e-5
    np.testing.assert_allclose(got["normal"][0], [0, 0, -1], atol=1e-5)


def test_ray_box_face_and_normal():
    ref, got = _both(*_world((BodyType.BOX, (3.0, 0.0, 0.0),
                              (2.0, 2.0, 2.0))),
                     [[0.0, 0.2, 0.3]], [[1.0, 0.0, 0.0]])
    assert bool(got["hit"][0])
    assert abs(float(got["t"][0]) - 2.0) < 1e-5       # the face at x = 2
    np.testing.assert_allclose(got["normal"][0], [-1, 0, 0], atol=1e-5)


def test_ray_capsule_side_and_cap():
    # axis = local z, r = 0.5, cylinder length 2: caps at z = ±1
    world = _world((BodyType.CAPSULE, (0.0, 0.0, 0.0), (0.5, 2.0, 0.0)))
    _, side = _both(*world, [[5.0, 0.0, 0.3]], [[-1.0, 0.0, 0.0]])
    assert bool(side["hit"][0]) and abs(float(side["t"][0]) - 4.5) < 1e-4
    _, cap = _both(*world, [[0.0, 0.0, 5.0]], [[0.0, 0.0, -1.0]])
    assert bool(cap["hit"][0]) and abs(float(cap["t"][0]) - 3.5) < 1e-4
    np.testing.assert_allclose(cap["normal"][0], [0, 0, 1], atol=1e-4)


def test_ray_plane_both_sides():
    kw = dict(KW, enable_planes=True)
    world = _world((BodyType.PLANE, (0.0, 1.0, 0.0), (0.0, 0.0, 0.0),
                    (np.sqrt(0.5), -np.sqrt(0.5), 0.0, 0.0)), kw=kw)
    # the plane's normal is its local z, turned onto +y
    _, got = _both(*world, [[0.0, 4.0, 0.0], [1.0, -2.0, 0.0]],
                   [[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
                   jcfg=JaxConfig(**kw), tcfg=TorchConfig(**kw))
    assert got["hit"].all()
    np.testing.assert_allclose(got["t"], [3.0, 3.0], atol=1e-5)
    np.testing.assert_allclose(got["normal"], [[0, 1, 0], [0, -1, 0]],
                               atol=1e-5)


def test_ray_nearest_of_many_and_miss():
    world = _world((BodyType.SPHERE, (0.0, 0.0, 10.0), (1.0, 0.0, 0.0)),
                   (BodyType.SPHERE, (0.0, 0.0, 4.0), (1.0, 0.0, 0.0)),
                   (BodyType.BOX, (0.0, 0.0, 20.0), (2.0, 2.0, 2.0)))
    _, got = _both(*world, [[0.0, 0.0, 0.0], [50.0, 50.0, 50.0]],
                   [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    assert bool(got["hit"][0]) and int(got["body"][0]) == 1
    assert abs(float(got["t"][0]) - 3.0) < 1e-5
    # every slot ties at "no hit": argmin takes slot 0, reported as -1
    assert not bool(got["hit"][1]) and int(got["body"][1]) == -1
    assert float(got["t"][1]) == 1e6
    assert not got["normal"][1].any()


@pytest.mark.parametrize("shape", ["sphere", "box", "capsule"])
def test_ray_inside_volume_is_miss(shape):
    body = {"sphere": (BodyType.SPHERE, (0.0, 0.0, 0.0), (2.0, 0.0, 0.0)),
            "box": (BodyType.BOX, (0.0, 0.0, 0.0), (3.0, 3.0, 3.0)),
            "capsule": (BodyType.CAPSULE, (0.0, 0.0, 0.0),
                        (1.0, 4.0, 0.0))}[shape]
    _, got = _both(*_world(body), [[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]])
    assert not bool(got["hit"][0]) and int(got["body"][0]) == -1


def test_ray_parallel_to_a_slab():
    """Axis-aligned rays have two zero direction components: inside the
    slabs of those axes they hit, outside they miss."""
    world = _world((BodyType.BOX, (0.0, 0.0, 5.0), (2.0, 2.0, 2.0)))
    _, got = _both(*world, [[0.5, 0.5, 0.0], [1.5, 0.0, 0.0],
                            [1.0, 1.0, 0.0]],
                   [[0.0, 0.0, 1.0]] * 3)
    assert got["hit"].tolist() == [True, False, True]
    np.testing.assert_allclose(got["t"][[0, 2]], 4.0, atol=1e-5)
    np.testing.assert_allclose(got["normal"][0], [0, 0, -1], atol=1e-5)


def test_ray_max_dist_cutoff():
    world = _world((BodyType.SPHERE, (0.0, 0.0, 100.0), (1.0, 0.0, 0.0)))
    _, got = _both(*world, [[0.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]],
                   max_dist=50.0)
    assert not bool(got["hit"][0])
    assert abs(float(got["t"][0]) - 50.0) < 1e-5
    np.testing.assert_allclose(got["point"][0], [0, 0, 50.0], atol=1e-5)


def _random_scene(seed, slots, kinds):
    """``slots - 1`` random bodies of ``kinds`` with random orientations
    (one slot stays free), and 64 rays: half aimed at the bodies from
    outside, within 0.4 m of their centres, half from inside the scene in
    random directions."""
    rng = np.random.default_rng(seed)
    bodies = []
    for _ in range(slots - 1):
        kind = kinds[rng.integers(len(kinds))]
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        pos = rng.uniform(-4.0, 4.0, size=3)
        size = {BodyType.SPHERE: (rng.uniform(0.3, 1.0), 0.0, 0.0),
                BodyType.BOX: tuple(rng.uniform(0.4, 2.0, size=3)),
                BodyType.CAPSULE: (rng.uniform(0.2, 0.6),
                                   rng.uniform(0.5, 2.0), 0.0),
                BodyType.PLANE: (0.0, 0.0, 0.0)}[kind]
        if kind == BodyType.PLANE:
            pos = rng.uniform(-1.0, 1.0, size=3) + [0.0, -6.0, 0.0]
        bodies.append((kind, tuple(pos), size, q))
    far = rng.normal(size=(32, 3))
    far = 12.0 * far / np.linalg.norm(far, axis=1, keepdims=True)
    centres = np.array([b[1] for b in bodies])[rng.integers(
        len(bodies), size=32)]
    aim = centres + rng.uniform(-0.4, 0.4, size=(32, 3)) - far
    origins = np.concatenate([far, rng.uniform(-4.0, 4.0, size=(32, 3))])
    dirs = np.concatenate([aim, rng.normal(size=(32, 3))])
    return bodies, origins.astype(np.float32), dirs.astype(np.float32)


SCENES = {
    "spheres_boxes_8": (8, (BodyType.SPHERE, BodyType.BOX),
                        dict(enable_capsules=False, enable_planes=False)),
    "with_capsules_12": (12, (BodyType.SPHERE, BodyType.BOX,
                              BodyType.CAPSULE),
                         dict(enable_capsules=True, enable_planes=False)),
    "all_types_16": (16, (BodyType.SPHERE, BodyType.BOX, BodyType.CAPSULE,
                          BodyType.PLANE),
                     dict(enable_capsules=True, enable_planes=True)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scene", list(SCENES))
def test_raycast_random_scene_matches_jax(scene, seed):
    slots, kinds, flags = SCENES[scene]
    kw = dict(KW, max_bodies=slots, **flags)
    bodies, origins, dirs = _random_scene(seed, slots, kinds)
    jstate, tstate = _world(*bodies, kw=kw)
    ref, got = _both(jstate, tstate, origins, dirs, jcfg=JaxConfig(**kw),
                     tcfg=TorchConfig(**kw), max_dist=30.0)
    assert 8 <= int(got["hit"].sum()) < 64          # hits and misses
    assert len(set(got["body"].tolist())) >= 4

    # all a lidar reads
    t = rc.ray_distances(tstate, torch.from_numpy(origins),
                         torch.from_numpy(dirs), TorchConfig(**kw),
                         max_dist=30.0)
    assert np.array_equal(t[0].numpy(), got["t"])


def test_raycast_all_miss():
    bodies, origins, _ = _random_scene(3, 8, (BodyType.SPHERE, BodyType.BOX))
    jstate, tstate = _world(*bodies)
    away = origins[:32] * 1.0                        # outward from the shell
    _, got = _both(jstate, tstate, origins[:32], away, max_dist=25.0)
    assert not got["hit"].any()
    assert (got["body"] == -1).all() and (got["t"] == 25.0).all()


def test_raycast_batch_equals_loop_over_worlds():
    """The leading world axis is the JAX package's ``vmap``: a batch of
    different worlds with per-world rays equals one call per world, and
    the JAX function under ``jax.vmap``."""
    kw = dict(KW, max_bodies=8)
    worlds, rays = [], []
    for seed in (5, 6, 7):
        bodies, origins, dirs = _random_scene(
            seed, 8, (BodyType.SPHERE, BodyType.BOX, BodyType.CAPSULE))
        worlds.append(_world(*bodies, kw=kw))
        rays.append((origins, dirs))
    arrays = {name: np.stack([to_numpy(j)[name] for j, _ in worlds])
              for name in to_numpy(worlds[0][0])}
    batch = bridge.world_from_numpy(arrays, device="cpu")
    origins = torch.from_numpy(np.stack([o for o, _ in rays]))
    dirs = torch.from_numpy(np.stack([d for _, d in rays]))
    hits = rc.raycast(batch, origins, dirs, TCFG, max_dist=30.0)
    assert hits.t.shape == (3, 64) and hits.normal.shape == (3, 64, 3)
    for w, (_, tstate) in enumerate(worlds):
        one = rc.raycast(tstate, origins[w], dirs[w], TCFG, max_dist=30.0)
        for name in ("t", "point", "normal", "body", "hit"):
            assert torch.equal(getattr(hits, name)[w],
                               getattr(one, name)[0]), name
    jbatch = JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ref = jax.vmap(lambda s, o, d: jax_rc.raycast(s, o, d, JCFG,
                                                  max_dist=30.0))(
        jbatch, jnp.asarray(origins.numpy()), jnp.asarray(dirs.numpy()))
    _hold({f: getattr(hits, f).numpy() for f in to_numpy(ref)},
          to_numpy(ref))

    # rays shared by every world: (R, 3)
    shared = rc.raycast(batch, origins[0], dirs[0], TCFG, max_dist=30.0)
    assert torch.equal(shared.t[0], hits.t[0])
    assert shared.t.shape == (3, 64)


def _both_meshes(verts, tris, slot, pad):
    return (jax_tm.build_trimesh(verts, tris, slot=slot,
                                 pad_to_multiple=pad),
            tm.build_trimesh(verts, tris, slot=slot, pad_to_multiple=pad,
                             device="cpu"))


def _hold_mesh(jmesh, tmesh, origins, dirs, **kw):
    origins = np.asarray(origins, np.float32)
    dirs = np.asarray(dirs, np.float32)
    ref = to_numpy(jax_rc.raycast_mesh(origins, dirs, jmesh, **kw))
    hits = rc.raycast_mesh(torch.from_numpy(origins), torch.from_numpy(dirs),
                           tmesh, **kw)
    got = {f: getattr(hits, f).numpy() for f in ref}
    _hold(got, ref)
    return got


def test_raycast_mesh_floor_lidar():
    n, size = 4, 20.0
    xs = np.linspace(-size / 2, size / 2, n + 1)
    verts = np.array([[x, 0.0, z] for z in xs for x in xs], np.float32)
    tris = np.array([[r * (n + 1) + c + d for d in ds] for r in range(n)
                     for c in range(n)
                     for ds in ((0, 1, n + 1), (1, n + 2, n + 1))], np.int32)
    meshes = _both_meshes(verts, tris, slot=3, pad=1024)
    # a downward 5-ray lidar from y = 2
    xs = np.linspace(-5, 5, 5) + 0.3
    origins = np.stack([xs, np.full(5, 2.0), np.full(5, 0.2)], -1)
    got = _hold_mesh(*meshes, origins, np.tile([[0.0, -1.0, 0.0]], (5, 1)))
    assert got["hit"].all() and (got["body"] == 3).all()
    np.testing.assert_allclose(got["t"], 2.0, atol=1e-5)
    np.testing.assert_allclose(got["normal"][:, 1], 1.0, atol=1e-5)


@pytest.mark.parametrize("chunk", [2048, 7])
def test_raycast_mesh_ridge_matches_jax(chunk):
    """Rays from above, from below (the normal turns to face them), along
    the valley and past the mesh's edge, on the twin-ridge mesh padded to
    128 triangles."""
    verts, tris = ridge_mesh_geometry()
    jmesh, tmesh = _both_meshes(verts, tris, slot=1, pad=128)
    rng = np.random.default_rng(9)
    xz = rng.uniform([-2.8, -1.8], [2.8, 1.8], size=(24, 2))
    above = np.stack([xz[:, 0], np.full(24, 3.0), xz[:, 1]], -1)
    below = above * [1.0, -1.0, 1.0]
    down = rng.normal(scale=0.1, size=(24, 3)) + [0.0, -1.0, 0.0]
    origins = np.concatenate([above, below, [[-2.9, 0.2, 0.1],
                                             [5.0, 3.0, 0.0]]])
    dirs = np.concatenate([down, -down, [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]])
    ref = to_numpy(jax_rc.raycast_mesh(origins.astype(np.float32),
                                       dirs.astype(np.float32), jmesh,
                                       max_dist=40.0))
    hits = rc.raycast_mesh(torch.from_numpy(origins.astype(np.float32)),
                           torch.from_numpy(dirs.astype(np.float32)), tmesh,
                           max_dist=40.0, chunk=chunk)
    got = {f: getattr(hits, f).numpy() for f in ref}
    _hold(got, ref)
    assert got["hit"][:48].sum() >= 40 and not got["hit"][-1]
    assert (got["normal"][:24][got["hit"][:24], 1] > 0).all()
    assert (got["normal"][24:48][got["hit"][24:48], 1] < 0).all()


def test_raycast_mesh_max_dist():
    verts, tris = ridge_mesh_geometry()
    meshes = _both_meshes(verts, tris, slot=0, pad=128)
    got = _hold_mesh(*meshes, [[0.0, 30.0, 0.0]], [[0.0, -1.0, 0.0]],
                     max_dist=10.0)
    assert not got["hit"][0] and int(got["body"][0]) == -1
    assert float(got["t"][0]) == 10.0
