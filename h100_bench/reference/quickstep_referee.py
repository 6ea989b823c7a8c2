"""Plain reference of the ``quickstep-f64`` configuration.

The float64 QuickStep referee (``referee.py``, scalar NumPy: all-pairs
broadphase, the primitive pair kernels with exact box clipping, PGS in
buffer row order, semi-implicit Euler) steps each sampled world from the
state the program held before the sampled call, ``substeps_per_call``
substeps, and the program's state after the call is judged against it.

Numbers (each the largest over the sampled world-calls and every active
body that is not static):

* ``pose_gap``: the largest of |dx| in m and |dq| (quaternion components);
* ``vel_gap``: the largest of |dv| in m/s and |dw| in rad/s.

"""

from __future__ import annotations

import numpy as np

import referee as R

FIELDS = ("pos", "quat", "linvel", "angvel")


def referee_config(cfg: dict) -> R.RefereeConfig:
    e = cfg["engine"]
    if e["solver"] != "pgs" or not e["exact_box_clip"]:
        raise ValueError("the QuickStep referee holds PGS with exact box "
                         "clipping")
    return R.RefereeConfig(
        dt=e["dt"], gravity=tuple(e["gravity"]),
        solver_iterations=e["solver_iterations"], sor_omega=e["sor_omega"],
        erp=e["erp"], cfm=e["cfm"],
        max_correcting_vel=e["max_correcting_vel"], bounce=e["bounce"],
        bounce_vel=e["bounce_vel"], mu=float(e["mu"]),
        friction=e["friction"],
        max_contacts_per_pair=e["max_contacts_per_pair"])


def world(side: dict, j: int) -> dict:
    """World ``j`` of a sample's side as the referee reads it."""
    def f(name):
        return np.asarray(side[name][j], np.float64)
    return dict(
        pos=f("pos"), quat=f("quat"), linvel=f("linvel"),
        angvel=f("angvel"), inv_mass=f("inv_mass"),
        inv_inertia=f("inv_inertia"),
        body_type=np.asarray(side["body_type"][j], np.int64),
        size=f("size"),
        category=np.asarray(side["category"][j]).astype(np.uint32),
        collide=np.asarray(side["collide"][j]).astype(np.uint32),
        is_static=np.asarray(side["is_static"][j], bool),
        is_kinematic=np.asarray(side["is_kinematic"][j], bool))


def advance(before: dict, j: int, cfg: dict, traffic: dict) -> dict:
    """World ``j`` of ``before`` after one call's substeps: float64 arrays
    of ``FIELDS``."""
    rc = referee_config(cfg)
    w = world(before, j)
    for _ in range(int(traffic["substeps_per_call"])):
        w = R.referee_step(w, rc)
    return {name: w[name] for name in FIELDS}


def answers(before: dict, j: int, cfg: dict, traffic: dict) -> list:
    """The one state the referee allows after the call."""
    return [advance(before, j, cfg, traffic)]


def gaps(after: dict, allowed: list, before: dict) -> dict:
    """One world-call's numbers: ``after`` against the referee's state,
    on the active bodies that are not static."""
    ref = allowed[0]
    moving = (np.asarray(before["body_type"]) != 0) & ~np.asarray(
        before["is_static"], bool)
    d = {name: np.abs(np.asarray(after[name], np.float64) - ref[name])
         .max(-1) for name in FIELDS}
    pose = np.maximum(d["pos"], d["quat"])
    vel = np.maximum(d["linvel"], d["angvel"])
    return dict(pose_gap=float(np.where(moving, pose, 0.0).max()),
                vel_gap=float(np.where(moving, vel, 0.0).max()))
