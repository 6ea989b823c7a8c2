"""The port's copy of the float64 referee (``testing/referee.py``), held to
the JAX package's referee and to the port's float64 engine on the CPU.

- The port's referee steps the JAX referee's initial dicts bit for bit
  like the JAX referee, on five scenes, under PGS and DANTZIG.
- The port's converters read the port's objects as the JAX converters
  read the JAX objects they were bridged from, bit for bit.
- The port's CPU float64 engine against the port's referee: BASELINE's
  bar is 1e-5; the port's float64 tolerance, 1e-9, is held here
  (``tests/test_torch_x64.py`` holds the engine to JAX's at the same).
  The 1k-step runs of ``tests/test_conformance_referee.py:103-146`` are
  in the slow tier, at 1e-5.
"""

import numpy as np
import pytest

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.testing import referee as jax_referee
from rl_ode_physics_tpu_torch import testing as port_testing
from rl_ode_physics_tpu_torch.testing import conformance
from rl_ode_physics_tpu_torch.testing import referee as port_referee
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import single_cpu_thread, to_numpy  # noqa: F401

SCENES = ("sphere_drop", "mini_stack", "capsule_pile", "hinge_chain",
          "ridge_mesh")
BITWISE_STEPS = 10
TOL = 1e-9                # the port's float64 tolerance
BASELINE_TOL = 1e-5       # BASELINE's relative trajectory error bar


def _jax_scene(name):
    """(state, joints or None, mesh or None) of a JAX scene at the
    conformance capacities, in float32 (JAX's x64 is off here)."""
    cfg = JaxConfig(max_bodies=16, max_pair_candidates=128, max_contacts=256)
    if name == "sphere_drop":
        return jax_scenes.sphere_drop_world(cfg, height=2.0), None, None
    if name == "mini_stack":
        return jax_scenes.mini_stack_world(cfg), None, None
    if name == "capsule_pile":
        return jax_scenes.capsule_pile_world(cfg), None, None
    if name == "hinge_chain":
        state, joints = jax_scenes.hinge_chain_scene(cfg)
        return state, joints, None
    state, mesh = jax_scenes.ridge_mesh_scene(cfg)
    return state, None, mesh


def _assert_dicts_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype, key
        assert np.array_equal(a, b), key


def test_exports_mirror_the_jax_package():
    from rl_ode_physics_tpu import testing as jax_testing
    assert port_testing.__all__ == jax_testing.__all__


@pytest.mark.parametrize("solver", ["pgs", "dantzig"])
@pytest.mark.parametrize("scene", SCENES)
def test_referee_steps_bitwise_like_the_jax_referee(scene, solver):
    state, joints, mesh = _jax_scene(scene)
    init = jax_referee.state_to_numpy(state)
    jnts = () if joints is None else jax_referee.jointset_to_numpy(joints)
    mesh_d = None if mesh is None else jax_referee.trimesh_to_numpy(mesh)
    if jnts and solver == "dantzig":
        for ref in (jax_referee, port_referee):
            with pytest.raises(NotImplementedError):
                ref.referee_step(dict(init), ref.RefereeConfig(solver=solver),
                                 joints=jnts, mesh=mesh_d)
        return
    w_j, w_p = dict(init), dict(init)
    cfg_j = jax_referee.RefereeConfig(solver=solver)
    cfg_p = port_referee.RefereeConfig(solver=solver)
    for _ in range(BITWISE_STEPS):
        w_j = jax_referee.referee_step(w_j, cfg_j, joints=jnts, mesh=mesh_d)
        w_p = port_referee.referee_step(w_p, cfg_p, joints=jnts, mesh=mesh_d)
        _assert_dicts_equal(w_p, w_j)


@pytest.mark.parametrize("scene", SCENES)
def test_converters_equal_the_jax_converters(scene):
    state, joints, mesh = _jax_scene(scene)
    port_state = bridge.world_from_numpy(to_numpy(state), device="cpu")
    _assert_dicts_equal(port_referee.state_to_numpy(port_state),
                        jax_referee.state_to_numpy(state))
    if joints is not None:
        port_joints = bridge.joints_from_numpy(to_numpy(joints),
                                               device="cpu")
        got = port_referee.jointset_to_numpy(port_joints)
        ref = jax_referee.jointset_to_numpy(joints)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            _assert_dicts_equal(g, r)
    if mesh is not None:
        port_mesh = bridge.trimesh_from_numpy(to_numpy(mesh), device="cpu")
        _assert_dicts_equal(port_referee.trimesh_to_numpy(port_mesh),
                            jax_referee.trimesh_to_numpy(mesh))


def test_state_to_numpy_reads_the_given_world():
    state, _, _ = _jax_scene("mini_stack")
    arrays = to_numpy(state)
    two = {k: np.stack([v, v]) for k, v in arrays.items()}
    two["pos"] = two["pos"].copy()
    two["pos"][1] += 1.0
    port_state = bridge.world_from_numpy(two, device="cpu")
    got = port_referee.state_to_numpy(port_state, world=1)
    np.testing.assert_array_equal(got["pos"], two["pos"][1].astype(np.float64))
    assert not np.array_equal(got["pos"],
                              port_referee.state_to_numpy(port_state)["pos"])


@pytest.mark.parametrize("scene,steps", [("sphere_drop", 72),
                                         ("mini_stack", 60)])
def test_cpu_float64_engine_follows_the_referee(scene, steps):
    got = conformance.compare(scene, steps, device="cpu")
    print(f"[referee:{scene}] {steps} steps: max rel pos err "
          f"{got['pos_err']:.3e}, max abs quat err {got['quat_err']:.3e}")
    assert got["pos_err"] <= TOL
    assert got["quat_err"] <= TOL


@pytest.mark.slow
@pytest.mark.parametrize("scene", conformance.SCENES)
def test_cpu_float64_engine_meets_the_baseline_bar_over_1k_steps(scene):
    got = conformance.compare(scene, 1000, device="cpu")
    print(f"[referee:{scene}] 1000 steps: max rel pos err "
          f"{got['pos_err']:.3e}, max abs quat err {got['quat_err']:.3e}")
    assert got["pos_err"] <= BASELINE_TOL
    assert got["quat_err"] <= 1e-3
