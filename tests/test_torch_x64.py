"""The port in float64 against the JAX package's float64 conformance
trajectories, on the CPU.

JAX's x64 mode is process-global, so the JAX side runs the unedited helper
``tests/_traj_engine.py <scene> <out.npz> <steps> <solver>`` in a
subprocess, as ``tests/test_conformance_referee.py`` does: the conformance
configuration (PGS in buffer row order or the direct DANTZIG solve, exact
box clipping, K=8, float64), the scene's initial state, its mesh or joint
table and the per-step ``pos``/``quat``. The port steps the same initial
state, bridged from the npz, under the same configuration values, and must
stay within 1e-9 of every step (measured: below 1e-15 over the PGS runs).
``sphere_drop`` runs 72 steps, so that the sphere lands (at about step
63); the other PGS runs 60, the DANTZIG runs and the hinge chain 40.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    SUBPROCESS_ENV, single_cpu_thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-9
# (scene, solver): steps
RUNS = {("sphere_drop", "pgs"): 72, ("mini_stack", "pgs"): 60,
        ("ridge_mesh", "pgs"): 60, ("mini_stack", "dantzig"): 40,
        ("hinge_chain", "pgs"): 40, ("hinge_chain", "dantzig"): 40}

# tests/_traj_engine.py:make_cfg("pgs"), by value
CONFORMANCE = dict(max_bodies=16, max_pair_candidates=128, max_contacts=256,
                   dtype="float64", solver=SolverKind.PGS,
                   exact_box_clip=True, max_contacts_per_pair=8,
                   matmul_precision="highest")


def _config(solver):
    """``tests/_traj_engine.py:make_cfg(solver)``, by value: DANTZIG's row
    capacity is 96."""
    if solver == "dantzig":
        return EngineConfig(**dict(CONFORMANCE, max_contacts=96,
                                   solver=SolverKind.DANTZIG))
    return EngineConfig(**CONFORMANCE)


@pytest.fixture(scope="module")
def jax_trajectory(tmp_path_factory):
    """(scene, solver) → the JAX package's npz, each run once for the
    module."""
    runs = {}

    def get(scene, solver="pgs"):
        if (scene, solver) not in runs:
            runs[scene, solver] = _jax_trajectory(
                scene, solver, tmp_path_factory.mktemp(f"{scene}_{solver}"))
        return runs[scene, solver]

    return get


def _jax_trajectory(scene, solver, tmp_path):
    out = tmp_path / f"{scene}.npz"
    r = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_traj_engine.py"), scene,
         str(out), str(RUNS[scene, solver]), solver],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=SUBPROCESS_ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(out)


def _initial_state(data, config):
    """The npz's initial state as the port's one-world state; the fields
    the npz leaves out (surface, accumulators, counters) are those a fresh
    world of ``config`` has."""
    init = {k[len("init_"):]: data[k] for k in data.files
            if k.startswith("init_")}
    n = init["pos"].shape[0]
    arrays = dict(init, body_type=init["body_type"].astype(np.int32),
                  force=np.zeros((n, 3)), torque=np.zeros((n, 3)),
                  friction=np.full(n, config.mu),
                  restitution=np.full(n, config.bounce),
                  color=np.zeros((n, 4), np.uint8), tick=np.int32(0),
                  rng_state=np.uint32(0), overflow=np.int32(0))
    return bridge.world_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("scene,solver", [
    pytest.param(scene, solver,
                 id=scene if solver == "pgs" else f"{scene}-{solver}")
    for scene, solver in RUNS])
def test_conformance_trajectory_matches_jax(scene, solver, jax_trajectory):
    config = _config(solver)
    steps = RUNS[scene, solver]
    data = jax_trajectory(scene, solver)
    state = _initial_state(data, config)
    assert state.pos.dtype == torch.float64
    mesh = joints = None
    if "mesh_v0" in data.files:
        mesh = bridge.trimesh_from_numpy(
            {k: data[f"mesh_{k}"] for k in ("v0", "e1", "e2", "normal",
                                            "slot")}, device="cpu")
    if "jnt_kind" in data.files:
        joints = bridge.joints_from_numpy(
            {k[len("jnt_"):]: data[k] for k in data.files
             if k.startswith("jnt_")}, device="cpu")
        assert joints.anchor_a.dtype == torch.float64
    step = make_step_fn(config, substeps=1, trimesh=mesh, joints=joints)
    worst = 0.0
    for i in range(steps):
        state = step(state)
        for name in ("pos", "quat"):
            err = float(np.abs(getattr(state, name)[0].numpy()
                               - data[name][i]).max())
            worst = max(worst, err)
            assert err <= TOL, (scene, solver, i, name, err)
    assert int(state.overflow[0]) == 0
    # the bodies moved: the comparison is not of a scene at rest
    moved = np.abs(data["pos"][-1] - data["init_pos"]).max()
    assert moved > 0.05, moved
    print(f"[x64:{scene}:{solver}] max abs pos/quat err {worst:.3e} over "
          f"{steps} steps")


def test_port_hinge_chain_builds_the_npz_joints(jax_trajectory):
    """The port's f64 ``hinge_chain_scene`` gives the JAX builder's initial
    state and joint table bit for bit."""
    config = _config("pgs")
    data = jax_trajectory("hinge_chain")
    state, joints = scenes.hinge_chain_scene(config, device="cpu")
    want = _initial_state(data, config)
    for name in ("pos", "quat", "inv_mass", "inv_inertia", "body_type",
                 "size", "is_static"):
        assert torch.equal(getattr(state, name), getattr(want, name)), name
    got = bridge.joints_to_numpy(joints, 0)
    for name, value in got.items():
        ref = data[f"jnt_{name}"]
        assert value.dtype == ref.dtype, name
        assert np.array_equal(value, ref), name


def test_port_scenes_build_the_npz_initial_state(jax_trajectory):
    """The port's own f64 scene builders give the JAX builders' initial
    state bit for bit (the map boxes' quaternions through float32, as the
    JAX builder computes them), and the same mesh."""
    config = _config("pgs")
    data = jax_trajectory("ridge_mesh")
    state, mesh = scenes.ridge_mesh_scene(config, device="cpu")
    want = _initial_state(data, config)
    for name in ("pos", "quat", "linvel", "angvel", "inv_mass",
                 "inv_inertia", "body_type", "size", "category", "collide",
                 "is_static", "is_kinematic", "friction", "restitution"):
        got = getattr(state, name)
        assert got.dtype == getattr(want, name).dtype, name
        assert torch.equal(got, getattr(want, name)), name
    for name in ("v0", "e1", "e2", "normal"):
        assert getattr(mesh, name).dtype == torch.float64
        assert np.array_equal(getattr(mesh, name).numpy(),
                              data[f"mesh_{name}"]), name
    assert mesh.slot == int(data["mesh_slot"])


def test_f64_sphere_drop_settles_exactly():
    """``tests/test_x64.py``'s f64 run in the port: the sphere of radius
    0.15 dropped from 2 m rests at y = 0.65 on the arena floor after 360
    substeps (JACOBI, ODE's double-precision CFM)."""
    config = EngineConfig(max_bodies=8, max_pair_candidates=32,
                          max_contacts=64, dtype="float64", cfm=1e-10)
    state = scenes.sphere_drop_world(config, height=2.0, radius=0.15,
                                     device="cpu")
    assert state.pos.dtype == torch.float64
    state = make_step_fn(config, substeps=360)(state)
    assert state.pos.dtype == torch.float64
    assert abs(float(state.pos[0, 4, 1]) - 0.65) < 1e-4
    assert abs(float(state.linvel[0, 4, 1])) < 1e-3
