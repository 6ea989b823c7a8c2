"""The port's body API, quaternion extraction, wire transforms, debug dump
and player controller against the JAX package.

Every body-API function runs on 3 worlds of different occupancy (4, 6
and 8 of 8 slots: the last is full) and is held bitwise to ``jax.vmap`` of
the JAX function with the same arguments. ``from_matrix`` and the nine
transforms are held at atol 1e-6 in float32, on rotations from a numpy seed
and on each pivot branch of the extraction.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import single_cpu_thread  # noqa: F401  (autouse)
from rl_ode_physics_tpu.core import world as jw
from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models import player as jplayer
from rl_ode_physics_tpu.models import scenes as jscenes
from rl_ode_physics_tpu.utils import quat as jquat
from rl_ode_physics_tpu.utils import transforms as jtf
from rl_ode_physics_tpu.utils.viz import dump_obj as jax_dump_obj
from rl_ode_physics_tpu_torch.core import world as tw
from rl_ode_physics_tpu_torch.models import player as tplayer
from rl_ode_physics_tpu_torch.utils import bridge
from rl_ode_physics_tpu_torch.utils import quat as tquat
from rl_ode_physics_tpu_torch.utils import transforms as ttf
from rl_ode_physics_tpu_torch.utils.viz import dump_obj as torch_dump_obj

CAPS = dict(max_bodies=8, max_pair_candidates=32, max_contacts=64)


def _jax_batch():
    """3 arena worlds of 8 slots: 4, 6 and 8 occupied (the last full)."""
    base = jscenes.grass_plane_world(JaxConfig(**CAPS))
    worlds = []
    for extra in (0, 2, 4):
        w = base
        for i in range(extra):
            w, _ = jw.add_body(w, 1 + i % 2, jnp.asarray([0.0, 1.0 + i, 0.0]),
                               jnp.asarray([0.3, 0.3, 0.3]))
        worlds.append(w)
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *worlds)


def _fields(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _same(jax_state, torch_state):
    want, got = _fields(jax_state), bridge.world_to_numpy(torch_state)
    for name, ref in want.items():
        assert got[name].dtype == ref.dtype, name
        assert np.array_equal(got[name], ref), name


PER_WORLD = np.array([4, 5, 7], np.int32)
QUAT = (0.5, 0.5, -0.5, 0.5)

# name → (JAX function of (state, per-world array), port call on (state,
# per-world tensor)); every call also gets the per-world array, used or not
CASES = {
    "add_body": (
        lambda s, p: jw.add_body(s, 1, jnp.asarray([0.5, 2.0, 1.0]),
                                 jnp.asarray([0.3, 0.0, 0.0])),
        lambda s, p: tw.add_body(s, 1, (0.5, 2.0, 1.0), (0.3, 0.0, 0.0))),
    "add_body_auto_mass_per_world_type": (
        lambda s, p: jw.add_body(
            s, jnp.minimum(p - 3, 3), jnp.asarray([0.5, 2.0, 1.0]),
            jnp.asarray([0.3, 0.7, 0.9]), quat=jnp.asarray(QUAT),
            linvel=(1.0, 0.0, -2.0), angvel=(0.0, 3.0, 0.0),
            color=(1, 2, 3, 4), auto_mass=True, density=1.3),
        lambda s, p: tw.add_body(
            s, torch.clamp_max(p - 3, 3), (0.5, 2.0, 1.0), (0.3, 0.7, 0.9),
            quat=QUAT,
            linvel=(1.0, 0.0, -2.0), angvel=(0.0, 3.0, 0.0),
            color=(1, 2, 3, 4), auto_mass=True, density=1.3)),
    "add_body_kinematic_capsule": (
        lambda s, p: jw.add_body(s, 3, jnp.asarray([0.0, 2.0, -3.0]),
                                 jnp.asarray([0.5, 1.0, 0.0]),
                                 kinematic=True, auto_mass=True,
                                 category=1, collide=3),
        lambda s, p: tw.add_body(s, 3, (0.0, 2.0, -3.0), (0.5, 1.0, 0.0),
                                 kinematic=True, auto_mass=True,
                                 category=1, collide=3)),
    "add_body_map": (
        lambda s, p: jw.add_body_map(s, jnp.asarray([1.0, 0.5, 1.0]),
                                     jnp.asarray([0.1, -0.2, 0.3]),
                                     jnp.asarray([2.0, 0.5, 1.0]),
                                     color=(9, 8, 7, 255)),
        lambda s, p: tw.add_body_map(s, (1.0, 0.5, 1.0), (0.1, -0.2, 0.3),
                                     (2.0, 0.5, 1.0), color=(9, 8, 7, 255))),
    "release_body": (
        lambda s, p: jw.release_body(s, 2),
        lambda s, p: tw.release_body(s, 2)),
    "release_body_per_world": (
        lambda s, p: jw.release_body(s, p),
        lambda s, p: tw.release_body(s, p)),
    "release_body_negative": (
        lambda s, p: jw.release_body(s, -1),
        lambda s, p: tw.release_body(s, -1)),
    "set_body_pose": (
        lambda s, p: jw.set_body_pose(s, p, pos=jnp.asarray([1.0, 2.0, 3.0]),
                                      quat=jnp.asarray(QUAT),
                                      linvel=jnp.asarray([0.5, 0.5, 0.5]),
                                      angvel=jnp.asarray([-1.0, 0.0, 1.0])),
        lambda s, p: tw.set_body_pose(s, p, pos=(1.0, 2.0, 3.0), quat=QUAT,
                                      linvel=(0.5, 0.5, 0.5),
                                      angvel=(-1.0, 0.0, 1.0))),
    "set_body_pose_pos_only": (
        lambda s, p: jw.set_body_pose(s, 3, pos=jnp.asarray([1.0, 2.0, 3.0])),
        lambda s, p: tw.set_body_pose(s, 3, pos=(1.0, 2.0, 3.0))),
    "set_body_surface": (
        lambda s, p: jw.set_body_surface(s, p, friction=0.4,
                                         restitution=0.6),
        lambda s, p: tw.set_body_surface(s, p, friction=0.4,
                                         restitution=0.6)),
    "add_force": (
        lambda s, p: jw.add_force(jw.add_force(s, p, jnp.asarray(
            [1.0, -2.0, 3.0])), 4, jnp.asarray([0.25, 0.25, 0.25])),
        lambda s, p: tw.add_force(tw.add_force(s, p, (1.0, -2.0, 3.0)), 4,
                                  (0.25, 0.25, 0.25))),
    "add_torque": (
        lambda s, p: jw.add_torque(s, p, jnp.asarray([0.0, 0.1, 9.0])),
        lambda s, p: tw.add_torque(s, p, (0.0, 0.1, 9.0))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_body_api_matches_jax_vmap_bitwise(name):
    jfn, tfn = CASES[name]
    jb = _jax_batch()
    tb = bridge.world_from_numpy(_fields(jb), device="cpu")
    jout = jax.vmap(jfn)(jb, jnp.asarray(PER_WORLD))
    tout = tfn(tb, torch.from_numpy(PER_WORLD))
    if isinstance(jout, tuple):
        (jout, jslot), (tout, tslot) = jout, tout
        assert tslot.dtype == torch.int32
        assert np.array_equal(tslot.numpy(), np.asarray(jslot))
    _same(jout, tout)


def test_add_body_until_full_reports_minus_one():
    """One more spawn than the emptiest world has free slots: each world
    reports -1 from the spawn that finds it full and is left as it was."""
    jb = _jax_batch()
    tb = bridge.world_from_numpy(_fields(jb), device="cpu")
    jadd = jax.vmap(lambda s: jw.add_body(
        s, 2, jnp.asarray([0.0, 4.0, 0.0]), jnp.asarray([0.4, 0.5, 0.6]),
        auto_mass=True))
    slots = []
    for _ in range(5):
        jb, jslot = jadd(jb)
        tb, tslot = tw.add_body(tb, 2, (0.0, 4.0, 0.0), (0.4, 0.5, 0.6),
                                auto_mass=True)
        assert np.array_equal(tslot.numpy(), np.asarray(jslot))
        slots.append(tslot.tolist())
    _same(jb, tb)
    assert slots[0] == [4, 6, -1] and slots[4] == [-1, -1, -1]


# --- quaternions and wire transforms ----------------------------------------

def _random_rotations(n=64, seed=0):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jquat.to_matrix(jnp.asarray(q, jnp.float32)))


def _pivot_rotations():
    """A rotation for each pivot of the extraction: the identity (trace),
    π about x, y and z (m00, m11, m22 largest), and 90° about x, where the
    trace and m00 tie (the first maximum, the trace, is taken)."""
    def about(axis, angle):
        q = np.zeros(4)
        q[0] = np.cos(angle / 2)
        q[1 + axis] = np.sin(angle / 2)
        return np.array(jquat.to_matrix(jnp.asarray(q, jnp.float32)))
    return np.stack([np.eye(3, dtype=np.float32), about(0, np.pi),
                     about(1, np.pi), about(2, np.pi), about(0, np.pi / 2)])


@pytest.mark.parametrize("which", ["random", "pivots"])
def test_from_matrix_matches_jax(which):
    m = _random_rotations() if which == "random" else _pivot_rotations()
    want = np.asarray(jquat.from_matrix(jnp.asarray(m)))
    got = tquat.from_matrix(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if which == "pivots":
        tr = np.trace(m, axis1=-2, axis2=-1)
        piv = np.stack([tr, m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], -1)
        assert piv.argmax(-1).tolist() == [0, 1, 2, 3, 0]


def test_conj_rotate_inv_axis_angle_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    axis = rng.normal(size=(16, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-3, 3, size=16).astype(np.float32)
    pairs = [
        (jquat.conj(jnp.asarray(q)), tquat.conj(torch.from_numpy(q))),
        (jquat.rotate_inv(jnp.asarray(q), jnp.asarray(v)),
         tquat.rotate_inv(torch.from_numpy(q), torch.from_numpy(v))),
        (jquat.from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)),
         tquat.from_axis_angle(torch.from_numpy(axis),
                               torch.from_numpy(angle))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _transform_inputs(seed=2):
    rng = np.random.default_rng(seed)
    rot = np.concatenate([_random_rotations(16, seed), _pivot_rotations()])
    n = len(rot)
    pos = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    euler = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    q = np.asarray(jquat.from_matrix(jnp.asarray(rot)))
    col = np.asarray(jtf.mat16_from_pos_rot(jnp.asarray(pos),
                                            jnp.asarray(rot)))
    row = np.asarray(jtf.mat16_rowmajor_from_pos_euler(
        jnp.asarray(pos), jnp.asarray(euler)))
    # writable copies: torch.from_numpy takes no read-only JAX buffer
    return {k: np.array(v) for k, v in dict(
        pos=pos, rot=rot, euler=euler, q=q, col=col, row=row).items()}


TRANSFORMS = {
    "mat16_from_pos_rot": ("pos", "rot"),
    "mat16_from_pos_quat": ("pos", "q"),
    "pos_from_mat16": ("col",),
    "rot_from_mat16": ("col",),
    "quat_from_mat16": ("col",),
    "mat16_from_pos_euler": ("pos", "euler"),
    "mat16_rowmajor_from_pos_euler": ("pos", "euler"),
    "rot_from_mat16_rowmajor": ("row",),
    "quat_from_mat16_rowmajor": ("row",),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    inputs = _transform_inputs()
    args = [inputs[k] for k in TRANSFORMS[name]]
    want = np.asarray(getattr(jtf, name)(*map(jnp.asarray, args)))
    got = getattr(ttf, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_transform_broadcasts_a_shared_rotation():
    pos = np.random.default_rng(3).normal(size=(2, 5, 3)).astype(np.float32)
    rot = _pivot_rotations()[1]
    want = np.asarray(jtf.mat16_from_pos_rot(jnp.asarray(pos),
                                             jnp.asarray(rot)))
    got = ttf.mat16_from_pos_rot(torch.from_numpy(pos),
                                 torch.from_numpy(rot)).numpy()
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- debug dump and player controller --------------------------------------

def _parse_obj(text):
    names = re.findall(r"^o (\S+)$", text, re.M)
    verts = np.array([[float(x) for x in line.split()[1:]]
                      for line in text.splitlines() if line.startswith("v ")])
    faces = [line for line in text.splitlines() if line.startswith("f ")]
    return names, verts, faces


def test_dump_obj_matches_jax(tmp_path):
    cfg = JaxConfig(**CAPS)
    world = jscenes.capsule_stack_world(cfg, num_bodies=4, seed=7)
    world = jw.make_step_fn(cfg, substeps=20, donate=False)(world)
    arrays = _fields(world)
    batch = bridge.world_from_numpy(
        {k: np.stack([v, v]) for k, v in arrays.items()}, device="cpu")
    jpath, tpath = tmp_path / "jax.obj", tmp_path / "torch.obj"
    assert (jax_dump_obj(world, str(jpath))
            == torch_dump_obj(batch, str(tpath), world=1) == 8)
    jn, jv, jf = _parse_obj(jpath.read_text())
    tn, tv, tf_ = _parse_obj(tpath.read_text())
    assert tn == jn and tf_ == jf
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    assert (torch_dump_obj(batch, str(tpath), include_static=False)
            == jax_dump_obj(world, str(jpath), include_static=False) == 4)


def test_update_local_matches_jax_bitwise():
    rng = np.random.default_rng(4)
    keys = [f.name for f in dataclasses.fields(jplayer.PlayerInput)]
    jcam, tcam = jplayer.PlayerCamera(), tplayer.PlayerCamera()
    for _ in range(200):
        press = dict(zip(keys, (rng.uniform(size=len(keys)) < 0.3).tolist()))
        dt = float(rng.uniform(0.001, 0.05))
        jcam = jplayer.update_local(jcam, jplayer.PlayerInput(**press),
                                    2.0, 2.0, dt)
        tcam = tplayer.update_local(tcam, tplayer.PlayerInput(**press),
                                    2.0, 2.0, dt)
        assert np.array_equal(tcam.pos, jcam.pos)
        assert (tcam.yaw, tcam.pitch, tcam.mult, tcam.fovy) == (
            jcam.yaw, jcam.pitch, jcam.mult, jcam.fovy)
        assert np.array_equal(tcam.target, jcam.target)
