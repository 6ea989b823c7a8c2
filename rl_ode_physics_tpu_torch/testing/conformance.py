"""The port's engine against the float64 referee, trajectory by trajectory.

The BASELINE bar is a relative trajectory error of at most 1e-5 against
the independent QuickStep referee over 1k steps. Here both step the same
initial state of a conformance scene (``tests/_traj_engine.py``'s scenes
and settings: PGS in buffer row order, exact box clipping, K=8,
float64), one world, on any device:

    from rl_ode_physics_tpu_torch.testing import conformance
    got = conformance.compare("mini_stack", steps=60, device="cuda")
    got["pos_err"], got["quat_err"]

``pos_err`` is the largest |Δx| / max(1, |x_ref|) over steps and active
bodies, ``quat_err`` the largest absolute quaternion difference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.testing.referee import (
    RefereeConfig, jointset_to_numpy, referee_step, state_to_numpy,
    trimesh_to_numpy)

SCENES = ("sphere_drop", "mini_stack", "hinge_chain", "ridge_mesh")


def conformance_config() -> EngineConfig:
    """``tests/_traj_engine.py:make_cfg("pgs")``, by value."""
    return EngineConfig(
        max_bodies=16, max_pair_candidates=128, max_contacts=256,
        dtype="float64", solver=SolverKind.PGS, exact_box_clip=True,
        max_contacts_per_pair=8, matmul_precision="highest")


def build(scene: str, config: EngineConfig, device="cuda"):
    """(one-world state, joints or None, mesh or None) of a conformance
    scene, as ``tests/_traj_engine.py:build`` makes them."""
    if scene == "sphere_drop":
        return (scenes.sphere_drop_world(config, height=2.0, device=device),
                None, None)
    if scene == "mini_stack":
        return scenes.mini_stack_world(config, device=device), None, None
    if scene == "hinge_chain":
        state, joints = scenes.hinge_chain_scene(config, device=device)
        return state, joints, None
    if scene == "ridge_mesh":
        state, mesh = scenes.ridge_mesh_scene(config, device=device)
        return state, None, mesh
    raise ValueError(f"unknown scene {scene!r}")


def engine_trajectory(state, config: EngineConfig, steps: int, joints=None,
                      trimesh=None):
    """(pos (T, N, 3), quat (T, N, 4), final state): the positions and
    quaternions of world 0 over ``steps`` steps of the port's engine, on the
    state's device, as float64 numpy arrays, and the state after them."""
    # not donated: the trajectory keeps every step's state
    step = make_step_fn(config, substeps=1, donate=False, joints=joints,
                        trimesh=trimesh)
    pos, quat = [], []
    for _ in range(steps):
        state = step(state)
        pos.append(state.pos[0])
        quat.append(state.quat[0])
    return (torch.stack(pos).cpu().double().numpy(),
            torch.stack(quat).cpu().double().numpy(), state)


def referee_trajectory(init: dict, steps: int, joints=(), mesh=None):
    """(pos (T, N, 3), quat (T, N, 4)) of the referee over ``steps`` steps
    from ``init`` (``state_to_numpy``), under ODE's defaults, as the
    engine's conformance configuration."""
    cfg = RefereeConfig()
    w = dict(init)
    pos, quat = [], []
    for _ in range(steps):
        w = referee_step(w, cfg, joints=joints, mesh=mesh)
        pos.append(w["pos"].copy())
        quat.append(w["quat"].copy())
    return np.stack(pos), np.stack(quat)


def max_rel_err(pos_e, pos_r, active) -> float:
    """max over steps and active bodies of |Δx| / max(1, |x_ref|): the
    relative trajectory error in BASELINE's sense."""
    diff = np.linalg.norm(pos_e - pos_r, axis=-1)            # (T, N)
    ref = np.maximum(np.linalg.norm(pos_r, axis=-1), 1.0)
    rel = np.where(active[None, :], diff / ref, 0.0)
    return float(rel.max())


def trajectories(scene: str, steps: int, device="cuda",
                 config: EngineConfig | None = None) -> dict:
    """The port's engine under ``config`` (default
    ``conformance_config()``) on ``device`` and the referee, ``steps`` steps
    of ``scene`` from the same initial state: their (T, N, 3) positions and
    (T, N, 4) quaternions as float64 numpy arrays (``pos_e``, ``quat_e``,
    ``pos_r``, ``quat_r``), the initial state as the referee reads it
    (``init``), the engine's final state (``final``), and the seconds each
    side took (the engine's after a ``synchronize``)."""
    config = config or conformance_config()
    state, joints, mesh = build(scene, config, device)
    init = state_to_numpy(state)
    ref_joints = () if joints is None else jointset_to_numpy(joints)
    ref_mesh = None if mesh is None else trimesh_to_numpy(mesh)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    pos_e, quat_e, final = engine_trajectory(state, config, steps, joints,
                                             mesh)
    sync()
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos_r, quat_r = referee_trajectory(init, steps, ref_joints, ref_mesh)
    referee_s = time.perf_counter() - t0
    return dict(pos_e=pos_e, quat_e=quat_e, pos_r=pos_r, quat_r=quat_r,
                init=init, final=final, engine_s=engine_s,
                referee_s=referee_s)


def compare(scene: str, steps: int, device="cuda",
            config: EngineConfig | None = None) -> dict:
    """The port's engine under ``config`` (default ``conformance_config()``)
    on ``device`` and the referee, ``steps`` steps of ``scene`` from the
    same initial state: their largest relative position error, largest
    absolute quaternion error, and the seconds each took (the engine's
    after a ``synchronize``)."""
    t = trajectories(scene, steps, device, config)
    active = t["init"]["body_type"] != 0
    return dict(
        scene=scene, steps=steps,
        pos_err=max_rel_err(t["pos_e"], t["pos_r"], active),
        quat_err=float(np.abs(t["quat_e"] - t["quat_r"])[:, active, :].max()),
        engine_s=t["engine_s"], referee_s=t["referee_s"])
