"""The port's joints (``ops/joints.py``) against the JAX package's, on the
13 scenes of ``tests/test_joints.py``.

Each scene's world is built with the JAX builder and carried to the port;
its joint table is built on each side with that package's own ``add_*``
calls. Then, on each side:
- the joint table (float32 roundoff) and ``connected_mask`` (bitwise);
- ``joint_rows`` on the scene's state: body slots and live flags exactly,
  every float field to float32 roundoff (atol 1e-6, rtol 1e-5);
- the step: the JAX step and the port's over the same substeps, at
  atol 1e-4 (pos, quat, linvel, angvel), tick and overflow exact. A scene
  whose event (a stop, a bounce) comes late is run on the JAX side alone
  up to shortly before it (``warm``), and both sides step through it from
  there. The chain's damping between control steps is applied on both.
The feedback case holds ``step_with_diagnostics``' joint forces to the JAX
package's, and the hanging bob's to m·g; the vmap case steps 3 worlds of
one shared joint table for 20 substeps against ``jax.vmap``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core import world as jax_world
from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.state import BodyType
from rl_ode_physics_tpu.models.builder import WorldBuilder
from rl_ode_physics_tpu.ops import joints as jax_jt
from rl_ode_physics_tpu.parallel.batch import replicate as jax_replicate
from rl_ode_physics_tpu_torch.core import world
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.ops import joints as jt
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    jax_state, single_cpu_thread, to_numpy)

CAPS = dict(max_bodies=8, max_pair_candidates=32, max_contacts=32)
STEP_ATOL = 1e-4


def _cpu(module):
    """``empty_joints`` of either package, the port's on the CPU."""
    if module is jt:
        return lambda cap: jt.empty_joints(cap, device="cpu")
    return module.empty_joints


def _anchor_block(b, y=3.0):
    b.add_body_map((0.0, y, 0.0), (0.0, 0.0, 0.0), (0.2, 0.2, 0.2))


def pendulum(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b)
        b.add_body(BodyType.BOX, (1.0, 3.0, 0.0), (0.3, 0.3, 0.3))
        return b.finish()
    return jm.add_ball(_cpu(jm)(4), w, 0, 0, 1, (0.0, 3.0, 0.0))


def door(jm, w=None, limits=None, motor=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b)
        b.add_body(BodyType.BOX, (1.0, 3.0, 0.0), (1.6, 0.2, 0.2))
        return b.finish()
    j = jm.add_hinge(_cpu(jm)(4), w, 0, 0, 1, (0.0, 3.0, 0.0),
                     (0.0, 0.0, 1.0))
    if limits is not None:
        j = jm.set_hinge_limits(j, 0, *limits)
    if motor is not None:
        j = jm.set_hinge_motor(j, 0, *motor)
    return j


def chain(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b, 5.0)
        for i in range(3):
            b.add_body(BodyType.BOX, (0.8 * (i + 1), 5.0, 0.0),
                       (0.3, 0.3, 0.3))
        return b.finish()
    j = _cpu(jm)(4)
    for slot, x in enumerate((0.4, 1.2, 2.0)):
        j = jm.add_ball(j, w, slot, slot, slot + 1, (x, 5.0, 0.0))
    return j


def bob_on_floor(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (20.0, 0.5, 20.0))
        b.add_body_map((0.0, 1.1, 0.0), (0.0, 0.0, 0.0), (0.2, 0.2, 0.2))
        b.add_body(BodyType.SPHERE, (1.0, 1.1, 0.0), (0.3, 0.0, 0.0))
        return b.finish()
    return jm.add_ball(_cpu(jm)(2), w, 0, 1, 2, (0.0, 1.1, 0.0))


def welded(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        b.add_body(BodyType.BOX, (0.0, 4.0, 0.0), (0.4, 0.4, 0.4))
        b.add_body(BodyType.BOX, (0.7, 4.0, 0.0), (0.4, 0.4, 0.4))
        w = b.finish()
        return w.replace(angvel=w.angvel.at[0].set(jnp.asarray(
            [0.0, 2.0, 1.0])))
    return jm.add_fixed(_cpu(jm)(2), w, 0, 0, 1)


def slider(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b)
        b.add_body(BodyType.BOX, (0.0, 3.0, 0.0), (0.4, 0.4, 0.4))
        return b.finish()
    j = jm.add_slider(_cpu(jm)(2), w, 0, 0, 1, (1.0, 0.0, 0.0))
    j = jm.set_hinge_motor(j, 0, vel=1.0, fmax=100.0)
    return jm.set_hinge_limits(j, 0, lo=-10.0, hi=1.5)


def universal(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b)
        b.add_body(BodyType.BOX, (1.0, 3.0, 0.0), (0.5, 0.3, 0.3))
        w = b.finish()
        return w.replace(angvel=w.angvel.at[1].set(jnp.asarray(
            [3.0, 0.0, 1.0])))
    return jm.add_universal(_cpu(jm)(2), w, 0, 0, 1, (0.0, 3.0, 0.0),
                            (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def hanging_bob(jm, w=None):
    if w is None:
        b = WorldBuilder(JaxConfig(**CAPS), 0)
        _anchor_block(b)
        b.add_body(BodyType.BOX, (0.0, 2.0, 0.0), (0.3, 0.3, 0.3))
        return b.finish()
    return jm.add_ball(_cpu(jm)(2), w, 0, 0, 1, (0.0, 3.0, 0.0))


# name: (scene, solver, JAX-only warm substeps, compared substeps, damping
# between control steps of 8)
SCENES = {
    "ball_pendulum_holds_anchor": (pendulum, "JACOBI", 0, 32, None),
    "ball_pendulum_pgs": (pendulum, "PGS", 0, 32, None),
    "hinge_restricts_rotation_axis": (door, "JACOBI", 0, 32, None),
    "ball_chain_hangs_vertically": (chain, "JACOBI", 0, 32, 0.9),
    "joint_with_contacts": (bob_on_floor, "JACOBI", 0, 32, None),
    "hinge_motor": (functools.partial(door, motor=(2.0, 50.0)), "JACOBI",
                    0, 32, None),
    "hinge_limit": (functools.partial(door, limits=(-np.pi / 4, np.pi / 4)),
                    "JACOBI", 56, 32, None),
    "fixed_joint": (welded, "JACOBI", 0, 32, None),
    "slider": (slider, "JACOBI", 160, 32, None),
    "universal": (universal, "JACOBI", 0, 32, None),
    "hinge_stop_bounce": (functools.partial(
        door, limits=(-np.pi / 4, np.pi / 4, 0.8)), "JACOBI", 56, 32, None),
}


def _configs(solver):
    return (JaxConfig(**CAPS, solver=JaxSolverKind[solver]),
            EngineConfig(**CAPS, solver=SolverKind[solver]))


@functools.lru_cache(maxsize=None)
def _jax_step(solver):
    jcfg, _ = _configs(solver)
    return jax.jit(lambda s, j: jax_world.step(s, jcfg, joints=j))


def _both(scene, w):
    """The scene's joint table on each side, built by each package."""
    tw = bridge.world_from_numpy(to_numpy(w), device="cpu")
    return scene(jax_jt, w), tw, scene(jt, tw)


def _compare_tables(jj, tj):
    ref = to_numpy(jj)
    got = bridge.joints_to_numpy(tj, 0)
    for name, r in ref.items():
        if r.dtype.kind == "f":
            np.testing.assert_allclose(got[name], r, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            assert np.array_equal(got[name], r), name


def _compare_rows(w, jj, tw, tj, jcfg, tcfg):
    ref = {k: np.asarray(v) for k, v in
           jax_jt.joint_rows(w, jj, jcfg).items()}
    got = jt.joint_rows(tw, tj, tcfg)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name][0].numpy()
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            assert np.array_equal(g, r), name
    return got


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_matches_jax(name):
    scene, solver, warm, substeps, damping = SCENES[name]
    jcfg, tcfg = _configs(solver)
    jstep = _jax_step(solver)
    w = scene(None)
    jj = scene(jax_jt, w)
    for _ in range(warm):
        w = jstep(w, jj)
    jj, tw, tj = _both(scene, scene(None))
    if warm:
        # the table is the creation pose's; the state the warmed one's
        tw = bridge.world_from_numpy(to_numpy(w), device="cpu")
    _compare_tables(jj, tj)
    n = tw.num_slots
    mask = jt.connected_mask(tj, n)
    assert mask.shape == (1, n, n)
    assert np.array_equal(mask[0].numpy(),
                          np.asarray(jax_jt.connected_mask(jj, n)))
    _compare_rows(w, jj, tw, tj, jcfg, tcfg)

    tstep = world.make_step_fn(tcfg, substeps=1, joints=tj)
    for i in range(substeps):
        w = jstep(w, jj)
        tw = tstep(tw)
        if damping is not None and i % 8 == 7:
            w = w.replace(linvel=w.linvel * damping, angvel=w.angvel * damping)
            tw = tw.replace(linvel=tw.linvel * damping,
                            angvel=tw.angvel * damping)
    ref, got = to_numpy(w), bridge.world_to_numpy(tw, 0)
    for field in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[field], ref[field], atol=STEP_ATOL,
                                   rtol=0, err_msg=field)
    for field in ("tick", "overflow"):
        assert np.array_equal(got[field], ref[field]), field
    # the scene moved
    assert np.abs(ref["pos"] - to_numpy(scene(None))["pos"]).max() > 0.01
    for f in (jt.hinge_angle, jt.slider_position):
        jf = getattr(jax_jt, f.__name__)
        np.testing.assert_allclose(f(tw, tj)[0].numpy(),
                                   np.asarray(jf(w, jj)), atol=1e-4)


def test_joints_under_vmap_match_the_port_batch():
    """``tests/test_joints.py::test_joints_under_vmap``: the pendulum in 3
    worlds (velocities kicked apart), one joint table shared, 20 substeps
    of ``jax.vmap(step)`` against the port's batch."""
    jcfg, tcfg = _configs("JACOBI")
    w = pendulum(None)
    jj = pendulum(jax_jt, w)
    batch = to_numpy(jax_replicate(w, 3))
    rng = np.random.default_rng(2)
    batch["linvel"] = (batch["linvel"] + np.where(
        batch["inv_mass"][..., None] > 0,
        rng.normal(scale=0.3, size=batch["linvel"].shape), 0)
    ).astype(np.float32)
    jb = jax_state(batch)
    tb = bridge.world_from_numpy(batch, device="cpu")
    tj = pendulum(jt, bridge.world_from_numpy(to_numpy(w), device="cpu"))
    f = jax.jit(jax.vmap(lambda s: jax_world.step(s, jcfg, joints=jj)))
    tstep = world.make_step_fn(tcfg, substeps=1, joints=tj)
    for _ in range(20):
        jb = f(jb)
        tb = tstep(tb)
    ref, got = to_numpy(jb), bridge.world_to_numpy(tb)
    for field in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[field], ref[field], atol=STEP_ATOL,
                                   rtol=0, err_msg=field)
    assert np.abs(got["pos"][0] - got["pos"][1]).max() > 1e-3
    d = np.linalg.norm(got["pos"][:, 1] - np.array([0.0, 3.0, 0.0]), axis=-1)
    assert (np.abs(d - 1.0) < 0.06).all()


def test_joint_feedback_matches_jax():
    """``step_with_diagnostics``' joint forces and torques against the JAX
    package's, on the bob after 200 JAX substeps of hanging: the force on
    the bob holds m·g up, as the JAX test asks."""
    jcfg, tcfg = _configs("JACOBI")
    w = hanging_bob(None)
    jj = hanging_bob(jax_jt, w)
    f = jax.jit(lambda s: jax_world.step_with_diagnostics(s, jcfg,
                                                          joints=jj))
    for _ in range(200):
        w, m = f(w)
    tj = hanging_bob(jt, bridge.world_from_numpy(
        to_numpy(hanging_bob(None)), device="cpu"))
    tw = bridge.world_from_numpy(to_numpy(w), device="cpu")
    w, ref = f(w)
    tw, got = world.step_with_diagnostics(tw, tcfg, joints=tj)
    keys = {k for k in ref if k.startswith("joint_")}
    assert keys == {"joint_force_a", "joint_torque_a", "joint_force_b",
                    "joint_torque_b"}
    assert keys <= set(got)
    for k in keys:
        assert got[k].shape == (1, 2, 3)
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(ref[k]),
                                   atol=1e-3, rtol=1e-4, err_msg=k)
    fb = got["joint_force_b"][0, 0].numpy()
    assert abs(fb[1] - 9.81) < 0.6, fb
    assert abs(fb[0]) < 0.6 and abs(fb[2]) < 0.6
    # PGS reports no joint feedback, as in the JAX package
    _, m_pgs = world.step_with_diagnostics(
        tw, tcfg.replace(solver=SolverKind.PGS), joints=tj)
    assert not any(k.startswith("joint_") for k in m_pgs)


def test_joint_feedback_sums_rows():
    """``feedback`` of random row impulses against the JAX function."""
    jcfg, tcfg = _configs("JACOBI")
    w = chain(None)
    jj, tw, tj = _both(chain, w)
    rows = _compare_rows(w, jj, tw, tj, jcfg, tcfg)
    lam = np.random.default_rng(7).normal(
        size=rows["rhs"].shape[1]).astype(np.float32)
    jrows = jax_jt.joint_rows(w, jj, jcfg)
    ref = jax_jt.feedback(jrows, jnp.asarray(lam), jcfg.dt)
    got = jt.feedback(rows, torch.from_numpy(lam)[None], tcfg.dt)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


def test_sequential_pass_skips_only_dead_rows():
    """``joint_iteration_seq`` over ``live_joint_rows`` equals the pass over
    every row (a dead row adds zero)."""
    _, tcfg = _configs("PGS")
    w = door(None)
    tw = bridge.world_from_numpy(to_numpy(w), device="cpu")
    tj = door(jt, tw, limits=(-0.1, 0.1), motor=(1.0, 5.0))
    rows = jt.joint_rows(tw, tj, tcfg)
    visit = jt.live_joint_rows(rows)
    assert 0 < len(visit) < rows["rhs"].shape[1]
    vel8 = torch.randn((1, tw.num_slots, 8), generator=torch.Generator()
                       .manual_seed(1))
    lam = torch.zeros_like(rows["rhs"])
    cfm = tcfg.cfm / tcfg.dt
    a = jt.joint_iteration_seq(vel8, rows, lam, 1.3, cfm, visit)
    b = jt.joint_iteration_seq(vel8, rows, lam, 1.3, cfm,
                               list(range(rows["rhs"].shape[1])))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_hinge_chain_throughput_capacities():
    """``core/config.hinge_chain_config``: its capacities are 1.5-2.5x the
    JAX package's peaks (box-box pairs tested, contact rows) over 144
    substeps of ``hinge_chain_scene`` in 4 worlds kicked apart, at
    capacities nothing can overflow; the JAX package steps the chosen
    configuration, and the port follows it for 16 substeps at atol 1e-4,
    overflow 0 on both."""
    from rl_ode_physics_tpu.models import scenes as jax_scenes
    from rl_ode_physics_tpu_torch.core.config import hinge_chain_config
    from rl_ode_physics_tpu_torch.models import scenes

    tcfg = hinge_chain_config()
    kw = {f: getattr(tcfg, f) for f in (
        "max_bodies", "max_pair_candidates", "max_contacts", "bucket_caps",
        "enable_capsules", "enable_planes")}
    jcfg = JaxConfig.throughput(**kw)
    wide = jcfg.replace(max_pair_candidates=64, max_contacts=64,
                        bucket_caps=((1, 1, 16), (1, 2, 16), (2, 2, 28)))
    w, jj = jax_scenes.hinge_chain_scene(wide)
    batch = to_numpy(jax_replicate(w, 4))
    rng = np.random.default_rng(0)
    dyn = batch["inv_mass"] > 0
    batch["linvel"] = (batch["linvel"] + np.where(
        dyn[..., None], rng.normal(scale=0.5, size=batch["linvel"].shape), 0)
    ).astype(np.float32)

    def body(carry, _):
        s, seen = carry
        s, m = jax.vmap(lambda x: jax_world.step_with_diagnostics(
            x, wide, joints=jj))(s)
        seen = jnp.maximum(seen, jnp.stack(
            [m["num_pairs"].max(), m["num_contacts"].max()]))
        return (s, seen), None

    b, seen = jax.jit(lambda b: jax.lax.scan(
        body, (b, jnp.zeros(2, jnp.int32)), None, length=144)[0])(
            jax_state(batch))
    assert int(np.max(b.overflow)) == 0
    pairs, rows = int(seen[0]), int(seen[1])
    assert 1.5 * pairs <= tcfg.bucket_capacity(2, 2) <= 2.5 * pairs
    assert 1.5 * rows <= tcfg.max_contacts <= 2.5 * rows
    print(f"[hinge_chain throughput] peaks: {pairs} box-box pairs, {rows} "
          f"contact rows; capacities {tcfg.bucket_capacity(2, 2)}, "
          f"{tcfg.max_contacts}")

    _, tj = scenes.hinge_chain_scene(tcfg, device="cpu")
    jb, tb = jax_state(batch), bridge.world_from_numpy(batch, device="cpu")
    jf = jax.jit(jax.vmap(lambda s: jax_world.step(s, jcfg, joints=jj)))
    tstep = world.make_step_fn(tcfg, substeps=1, joints=tj)
    for _ in range(16):
        jb, tb = jf(jb), tstep(tb)
    ref, got = to_numpy(jb), bridge.world_to_numpy(tb)
    for field in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[field], ref[field], atol=STEP_ATOL,
                                   rtol=0, err_msg=field)
    assert (ref["overflow"] == 0).all() and (got["overflow"] == 0).all()


@pytest.mark.parametrize("pipeline", [
    dict(), dict(exact_box_clip=True), dict(typed_buckets=True),
    dict(typed_buckets=True, cm_narrowphase=False),
    dict(typed_buckets=True, sap_window=3, sap_broad=2),
    dict(dense_pipeline=True)],
    ids=["classic", "exact_clip", "typed_cm", "typed_row_major", "sap",
         "dense"])
@pytest.mark.parametrize("solver", [
    dict(solver=SolverKind.JACOBI), dict(solver=SolverKind.PGS),
    dict(solver=SolverKind.DANTZIG), dict(solver_cm=True),
    dict(solver_matmul_dtype="bfloat16")],
    ids=["jacobi", "pgs", "dantzig", "solver_cm", "bf16"])
def test_every_config_steps_with_joints(solver, pipeline):
    """Every solver under every narrowphase pipeline builds a step with a
    joint table and steps the hinge chain (2 worlds, 2 substeps) to a
    finite state with its anchor held; with the step built without joints
    too. (The dense pipeline's positional solve has no joints, as in the
    JAX package.)"""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import replicate

    cfg = EngineConfig(max_bodies=8, max_pair_candidates=16, max_contacts=32,
                       **solver, **pipeline)
    state, table = scenes.hinge_chain_scene(cfg, device="cpu")
    batch = replicate(state, 2, device="cpu")
    for joints in (None, table):
        out = world.make_step_fn(cfg, substeps=2, joints=joints)(batch)
        for field in ("pos", "quat", "linvel", "angvel"):
            assert bool(torch.isfinite(getattr(out, field)).all()), field
        assert (out.tick == 2).all() and (out.overflow == 0).all()
    if not cfg.dense_pipeline:
        # the hinge's anchor point stays on the static anchor at (0, 4, 0)
        rows = jt.joint_rows(out, table, cfg)
        assert float(rows["rhs"][:, :3].abs().max()) < 0.5
