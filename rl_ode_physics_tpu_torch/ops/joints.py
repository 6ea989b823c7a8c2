"""Bilateral joints (ball, hinge, fixed, slider, universal) as solver rows.

The port of ``rl_ode_physics_tpu/ops/joints.py``: ODE-style bilateral
constraint rows solved interleaved with the contact rows.

* BALL   — 3 rows driving the anchors' relative velocity to the ERP-scaled
  anchor separation (dJointCreateBall).
* HINGE  — the 3 ball rows + 2 angular rows keeping the relative angular
  velocity along the axis, + an optional motor row (dParamVel/dParamFMax)
  and a one-sided limit row (dParamLoStop/HiStop/Bounce).
* FIXED  — 3 anchor rows + 3 angular rows locking all relative rotation.
* SLIDER — 2 lateral anchor rows + 3 rotation-lock rows + optional linear
  motor and position-limit rows along the axis.
* UNIVERSAL — the 3 ball rows + 1 row keeping axis 1 (on body a)
  perpendicular to axis 2 (on body b).

A ``JointSet`` is a fixed-capacity table of ``J`` slots (kind 0 = empty)
with a leading world axis like ``WorldState``: ``kind`` is ``(B, J)``,
anchors ``(B, J, 3)``. A table of one world (B = 1) serves every world of
a batch. Anchors and axes are stored in body-local coordinates and
transformed by the current poses every step, like ODE's.

Rows come ``ROWS_PER_JOINT`` = 7 to a slot, ``R = J·7`` in all. The
throughput solver relaxes them with ``joint_iteration`` (all rows from the
same velocities, mass-split, one-hot ``bmm`` gathers and scatters, so the
sums run in a fixed order on every device); PGS and the DANTZIG post-pass
with ``joint_iteration_seq`` (row after row, a Python loop over the rows
live in some world, on (B,) tensors).
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState, world_inv_inertia
from rl_ode_physics_tpu_torch.utils import quat as quat_m

_EPS = 1e-9

JOINT_NONE = 0
JOINT_BALL = 1
JOINT_HINGE = 2
JOINT_FIXED = 3
JOINT_SLIDER = 4
JOINT_UNIVERSAL = 5

# rows emitted per joint slot: 3 linear + 2 angular constraint rows (ball
# leaves the angular rows dead) + 1 motor row + 1 limit row
ROWS_PER_JOINT = 7


@dataclasses.dataclass
class JointSet:
    """Fixed-capacity joint table of B worlds (B = 1: shared by a batch)."""

    kind: torch.Tensor        # (B, J) int32 JOINT_* code (0 = empty slot)
    a: torch.Tensor           # (B, J) int32 body slot
    b: torch.Tensor           # (B, J) int32 body slot
    anchor_a: torch.Tensor    # (B, J, 3) anchor in a's local frame
    anchor_b: torch.Tensor    # (B, J, 3) anchor in b's local frame
    axis_a: torch.Tensor      # (B, J, 3) hinge axis in a's local frame
    axis_b: torch.Tensor      # (B, J, 3) hinge axis in b's local frame
    ref_a: torch.Tensor       # (B, J, 3) angle reference ⊥ axis, a's frame
    ref_b: torch.Tensor       # (B, J, 3) the same world vector in b's frame
    lo: torch.Tensor          # (B, J) lo stop (rad, or m for a slider)
    hi: torch.Tensor          # (B, J) hi stop
    stop_bounce: torch.Tensor  # (B, J) stop restitution (0 = off)
    motor_vel: torch.Tensor   # (B, J) motor target velocity
    motor_fmax: torch.Tensor  # (B, J) motor max force/torque, 0 = off

    def replace(self, **changes) -> "JointSet":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "JointSet":
        return JointSet(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    @property
    def capacity(self) -> int:
        return self.kind.shape[-1]


def empty_joints(capacity: int, dtype=torch.float32, num_worlds: int = 1,
                 device="cuda") -> JointSet:
    """A table of ``capacity`` empty slots in ``num_worlds`` worlds."""
    shape = (num_worlds, capacity)
    kw = dict(dtype=dtype, device=device)

    def rows3(v):
        return torch.tensor(v, **kw).expand(shape + (3,)).clone()

    inf = torch.full(shape, torch.inf, **kw)
    zero = torch.zeros(shape, **kw)
    ints = torch.zeros(shape, dtype=torch.int32, device=device)
    return JointSet(kind=ints, a=ints.clone(), b=ints.clone(),
                    anchor_a=rows3([0.0, 0.0, 0.0]),
                    anchor_b=rows3([0.0, 0.0, 0.0]),
                    axis_a=rows3([0.0, 0.0, 1.0]),
                    axis_b=rows3([0.0, 0.0, 1.0]),
                    ref_a=rows3([1.0, 0.0, 0.0]),
                    ref_b=rows3([1.0, 0.0, 0.0]),
                    lo=-inf, hi=inf.clone(), stop_bounce=zero,
                    motor_vel=zero.clone(), motor_fmax=zero.clone())


def _set(x: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of the table field ``x`` with ``slot`` set to ``value`` in
    every world."""
    out = x.clone()
    out[:, slot] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return out


def _vec(state: WorldState, v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=state.pos.dtype, device=state.device)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), _EPS)


def _rot(state: WorldState, body: int, world: int) -> torch.Tensor:
    return quat_m.to_matrix(state.quat[world, body])


def _to_local(state: WorldState, body: int, world_point, world: int):
    r = _rot(state, body, world)
    return r.T @ (_vec(state, world_point) - state.pos[world, body])


def add_ball(joints: JointSet, state: WorldState, slot: int, a: int, b: int,
             world_anchor, world: int = 0) -> JointSet:
    """dJointCreateBall + dJointSetBallAnchor: the world anchor stored in
    both bodies' local frames, from the poses of world ``world``."""
    wa = _vec(state, world_anchor)
    return joints.replace(
        kind=_set(joints.kind, slot, JOINT_BALL),
        a=_set(joints.a, slot, a), b=_set(joints.b, slot, b),
        anchor_a=_set(joints.anchor_a, slot, _to_local(state, a, wa, world)),
        anchor_b=_set(joints.anchor_b, slot, _to_local(state, b, wa, world)))


def add_hinge(joints: JointSet, state: WorldState, slot: int, a: int, b: int,
              world_anchor, world_axis, world: int = 0) -> JointSet:
    """dJointCreateHinge + SetHingeAnchor/SetHingeAxis."""
    j = add_ball(joints, state, slot, a, b, world_anchor, world)
    ax = _unit(_vec(state, world_axis))
    ra, rb = _rot(state, a, world), _rot(state, b, world)
    # any world vector ⊥ axis at creation defines angle 0
    ref_w, _ = _perp_basis(ax)
    return j.replace(
        kind=_set(j.kind, slot, JOINT_HINGE),
        axis_a=_set(j.axis_a, slot, ra.T @ ax),
        axis_b=_set(j.axis_b, slot, rb.T @ ax),
        ref_a=_set(j.ref_a, slot, ra.T @ ref_w),
        ref_b=_set(j.ref_b, slot, rb.T @ ref_w))


def set_hinge_limits(joints: JointSet, slot: int, lo, hi,
                     bounce=0.0) -> JointSet:
    """dParamLoStop / dParamHiStop / dParamBounce, relative to the creation
    pose: radians for a hinge, meters for a slider."""
    return joints.replace(lo=_set(joints.lo, slot, lo),
                          hi=_set(joints.hi, slot, hi),
                          stop_bounce=_set(joints.stop_bounce, slot, bounce))


def set_hinge_motor(joints: JointSet, slot: int, vel, fmax) -> JointSet:
    """dParamVel / dParamFMax: drive the joint's velocity toward ``vel``
    with a force or torque bounded by ``fmax`` (0 = off)."""
    return joints.replace(motor_vel=_set(joints.motor_vel, slot, vel),
                          motor_fmax=_set(joints.motor_fmax, slot, fmax))


def add_fixed(joints: JointSet, state: WorldState, slot: int, a: int, b: int,
              world: int = 0) -> JointSet:
    """dJointCreateFixed + dJointSetFixed: lock the current relative pose,
    anchored at the midpoint of the body origins."""
    mid = 0.5 * (state.pos[world, a] + state.pos[world, b])
    j = add_ball(joints, state, slot, a, b, mid, world)
    za, xa = _vec(state, [0.0, 0.0, 1.0]), _vec(state, [1.0, 0.0, 0.0])
    ra, rb = _rot(state, a, world), _rot(state, b, world)
    return j.replace(
        kind=_set(j.kind, slot, JOINT_FIXED),
        axis_a=_set(j.axis_a, slot, ra.T @ za),
        axis_b=_set(j.axis_b, slot, rb.T @ za),
        ref_a=_set(j.ref_a, slot, ra.T @ xa),
        ref_b=_set(j.ref_b, slot, rb.T @ xa))


def add_slider(joints: JointSet, state: WorldState, slot: int, a: int, b: int,
               world_axis, world: int = 0) -> JointSet:
    """dJointCreateSlider + dJointSetSliderAxis: translation along
    ``world_axis`` only, relative rotation locked; position 0 is the
    creation pose, anchored at body a's origin."""
    ax = _unit(_vec(state, world_axis))
    j = add_ball(joints, state, slot, a, b, state.pos[world, a], world)
    ra, rb = _rot(state, a, world), _rot(state, b, world)
    ref_w, _ = _perp_basis(ax)
    return j.replace(
        kind=_set(j.kind, slot, JOINT_SLIDER),
        axis_a=_set(j.axis_a, slot, ra.T @ ax),
        axis_b=_set(j.axis_b, slot, rb.T @ ax),
        ref_a=_set(j.ref_a, slot, ra.T @ ref_w),
        ref_b=_set(j.ref_b, slot, rb.T @ ref_w))


def add_universal(joints: JointSet, state: WorldState, slot: int, a: int,
                  b: int, world_anchor, axis1, axis2,
                  world: int = 0) -> JointSet:
    """dJointCreateUniversal: ball anchor + axis1 (fixed in a) kept
    perpendicular to axis2 (fixed in b); axis1 ⊥ axis2 at creation."""
    j = add_ball(joints, state, slot, a, b, world_anchor, world)
    a1, a2 = _unit(_vec(state, axis1)), _unit(_vec(state, axis2))
    ra, rb = _rot(state, a, world), _rot(state, b, world)
    return j.replace(
        kind=_set(j.kind, slot, JOINT_UNIVERSAL),
        axis_a=_set(j.axis_a, slot, ra.T @ a1),
        axis_b=_set(j.axis_b, slot, rb.T @ a2))


def _perp_basis(u):
    """Deterministic orthonormal (p, q) completing unit axis u; (..., 3)."""
    ax = torch.argmin(torch.abs(u), dim=-1)
    e = torch.nn.functional.one_hot(ax, 3).to(u.dtype)
    p = torch.linalg.cross(u, e, dim=-1)
    p = p / torch.clamp_min(
        torch.linalg.vector_norm(p, dim=-1, keepdim=True), _EPS)
    q = torch.linalg.cross(u, p, dim=-1)
    return p, q


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) per-slot values at (B or 1, J) slots → (B, J, ...)."""
    b = x.shape[0]
    idx = idx.to(torch.int64).expand(b, idx.shape[-1])
    flat = x.reshape(b, x.shape[1], -1)
    out = torch.gather(flat, 1, idx[..., None].expand(
        b, idx.shape[1], flat.shape[-1]))
    return out.reshape((b, idx.shape[1]) + x.shape[2:])


def _mv(m, v):
    """(..., 3, 3) · (..., 3) → (..., 3)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _frames(state: WorldState, joints: JointSet):
    """Both bodies' rotations, positions and the world-frame anchors."""
    ra = quat_m.to_matrix(_take(state.quat, joints.a))      # (B, J, 3, 3)
    rb = quat_m.to_matrix(_take(state.quat, joints.b))
    pos_a, pos_b = _take(state.pos, joints.a), _take(state.pos, joints.b)
    pa = pos_a + _mv(ra, joints.anchor_a)
    pb = pos_b + _mv(rb, joints.anchor_b)
    return ra, rb, pos_a, pos_b, pa, pb


def slider_position(state: WorldState, joints: JointSet) -> torch.Tensor:
    """(B, J) slide distance along the axis relative to the creation pose
    (dJointGetSliderPosition)."""
    ra, _, _, _, pa, pb = _frames(state, joints)
    u = _mv(ra, joints.axis_a)
    return torch.sum((pb - pa) * u, -1)


def hinge_angle(state: WorldState, joints: JointSet) -> torch.Tensor:
    """(B, J) hinge angles (radians, relative to the creation pose)."""
    ra = quat_m.to_matrix(_take(state.quat, joints.a))
    rb = quat_m.to_matrix(_take(state.quat, joints.b))
    u = _mv(ra, joints.axis_a)
    u = u / torch.clamp_min(
        torch.linalg.vector_norm(u, dim=-1, keepdim=True), _EPS)
    pa = _mv(ra, joints.ref_a)
    pb = _mv(rb, joints.ref_b)
    # both references projected into the plane ⊥ u, angle from a's to b's
    pa = pa - u * torch.sum(pa * u, -1, keepdim=True)
    pb = pb - u * torch.sum(pb * u, -1, keepdim=True)
    s = torch.sum(torch.linalg.cross(pa, pb, dim=-1) * u, -1)
    c = torch.sum(pa * pb, -1)
    return torch.atan2(s, c)


def connected_mask(joints: JointSet, num_slots: int) -> torch.Tensor:
    """(B, N, N) True where two slots are joined by a live joint (ODE's
    ``dAreConnected``); the pair phases exclude these pairs."""
    live = joints.kind != JOINT_NONE
    cols = torch.arange(num_slots, device=joints.kind.device)
    oh_a = ((joints.a[..., None] == cols) & live[..., None]).float()
    oh_b = ((joints.b[..., None] == cols) & live[..., None]).float()
    m = torch.bmm(oh_a.transpose(1, 2), oh_b) > 0               # (B, N, N)
    return m | m.transpose(1, 2)


def joint_rows(state: WorldState, joints: JointSet, config: EngineConfig):
    """Per-step packed bilateral rows, R = J·ROWS_PER_JOINT per world, each
    joint's 7 rows together: a dict of (B, R, …) tensors with the body
    slots, the linear axis ``n`` (zero on angular rows), the angular
    weights ``wa``/``wb``, the angular responses I⁻¹·w, the inverse
    masses, the effective mass ``d`` (split by the bodies' joint degree,
    for the batched pass) and ``d_seq`` (for the sequential one), the
    target ``rhs``, ``live`` and the impulse bounds ``lob``/``hib``."""
    f = state.pos.dtype
    dev = state.device
    bsz, jcap = state.num_worlds, joints.capacity
    dt = config.dt
    erp_dt = config.erp / dt

    def wide(x):
        return x.expand((bsz,) + x.shape[1:])

    kind = wide(joints.kind)
    a, b = wide(joints.a), wide(joints.b)
    ra, rb, pos_a, pos_b, pa, pb = _frames(state, joints)
    arm_a, arm_b = pa - pos_a, pb - pos_b                    # (B, J, 3)

    axis_w = _mv(ra, joints.axis_a)
    axis_w = axis_w / torch.clamp_min(
        torch.linalg.vector_norm(axis_w, dim=-1, keepdim=True), _EPS)
    axis_b_w = _mv(rb, joints.axis_b)
    p_ax, q_ax = _perp_basis(axis_w)

    is_ball = kind == JOINT_BALL
    is_hinge = kind == JOINT_HINGE
    is_fixed = kind == JOINT_FIXED
    is_slider = kind == JOINT_SLIDER
    is_univ = kind == JOINT_UNIVERSAL
    rot_locked = is_fixed | is_slider
    live_j = is_ball | is_hinge | is_fixed | is_slider | is_univ

    def cross(x, y):
        return torch.linalg.cross(x, y, dim=-1)

    err = pa - pb                                         # anchor separation
    mis = cross(axis_b_w, axis_w)                         # hinge misalignment
    # full orientation error for rotation-locked joints (two-frame form)
    ref_a_w = _mv(ra, joints.ref_a)
    ref_b_w = _mv(rb, joints.ref_b)
    rot_err = 0.5 * (cross(axis_b_w, axis_w) + cross(ref_b_w, ref_a_w))

    eye = torch.eye(3, dtype=f, device=dev)
    inf_j = torch.full((bsz, jcap), torch.inf, dtype=f, device=dev)
    zero_j = torch.zeros((bsz, jcap), dtype=f, device=dev)
    zero3 = torch.zeros((bsz, jcap, 3), dtype=f, device=dev)

    def sel3(c, x, y):
        return torch.where(c[..., None], x, y)

    def basis(i):
        return eye[i].expand(bsz, jcap, 3)

    rows_n, rows_wa, rows_wb = [], [], []
    rows_rhs, rows_live, rows_lob, rows_hib = [], [], [], []
    # 3 anchor rows. Ball/hinge/fixed: world basis axes. Slider: the two
    # lateral axes ⊥ the slide axis, and the third slot becomes the first
    # rotation-lock row.
    lat = (p_ax, q_ax)
    for i in range(3):
        e_i = basis(i)
        if i < 2:
            n = sel3(is_slider, lat[i], e_i)
            rows_n.append(n)
            rows_wa.append(cross(arm_a, n))
            rows_wb.append(cross(arm_b, n))
            rows_rhs.append(erp_dt * torch.where(
                is_slider, torch.sum(err * n, -1), err[..., i]))
        else:
            rows_n.append(sel3(~is_slider, e_i, zero3))
            rows_wa.append(sel3(is_slider, basis(0), cross(arm_a, e_i)))
            rows_wb.append(sel3(is_slider, basis(0), cross(arm_b, e_i)))
            rows_rhs.append(erp_dt * torch.where(
                is_slider, rot_err[..., 0], err[..., i]))
        rows_live.append(live_j)
        rows_lob.append(-inf_j)
        rows_hib.append(inf_j)
    # universal: keep axis1 (a-fixed) ⊥ axis2 (b-fixed), row axis a1×a2
    u_cross = cross(axis_w, axis_b_w)
    u_norm = torch.linalg.vector_norm(u_cross, dim=-1, keepdim=True)
    u_cross = u_cross / torch.clamp_min(u_norm, 1e-3)   # degenerate at gimbal
    c_perp = torch.sum(axis_w * axis_b_w, -1)

    # 2 angular rows. Hinge: the perpendicular pair with the misalignment
    # bias. Fixed: rot-lock about e_x, e_y. Slider: e_y, e_z. Universal:
    # the first is the perpendicularity row, the second dead.
    for k_ang in range(2):
        ax = sel3(is_hinge, lat[k_ang],
                  sel3(is_slider, basis(k_ang + 1), basis(k_ang)))
        if k_ang == 0:
            ax = sel3(is_univ, u_cross, ax)
        rows_n.append(zero3)
        rows_wa.append(ax)
        rows_wb.append(ax)
        rows_rhs.append(torch.where(
            is_hinge, erp_dt * torch.sum(mis * ax, -1),
            torch.where(is_univ & (k_ang == 0), erp_dt * c_perp,
                        erp_dt * torch.sum(rot_err * ax, -1))))
        rows_live.append(is_hinge | rot_locked
                         | (is_univ if k_ang == 0
                            else torch.zeros_like(is_univ)))
        rows_lob.append(-inf_j)
        rows_hib.append(inf_j)

    # motor row. Hinge: angular drive about the axis (impulse within
    # ±fmax·dt). Slider: linear drive along the axis. Fixed: the third
    # rot-lock row (e_z).
    fmax = wide(joints.motor_fmax)
    mot_n = sel3(is_slider, axis_w, zero3)
    ez = basis(2)
    rows_n.append(mot_n)
    rows_wa.append(sel3(is_hinge, axis_w,
                        sel3(is_fixed, ez, cross(arm_a, mot_n))))
    rows_wb.append(sel3(is_hinge, axis_w,
                        sel3(is_fixed, ez, cross(arm_b, mot_n))))
    rows_rhs.append(torch.where(is_fixed, erp_dt * rot_err[..., 2],
                                wide(joints.motor_vel)))
    rows_live.append(((is_hinge | is_slider) & (fmax > 0.0)) | is_fixed)
    rows_lob.append(torch.where(is_fixed, -inf_j, -fmax * dt))
    rows_hib.append(torch.where(is_fixed, inf_j, fmax * dt))

    # limit row: a one-sided stop when the hinge angle or slide position is
    # outside [lo, hi], ERP-driven, restituting with dParamBounce
    lo, hi = wide(joints.lo), wide(joints.hi)
    coord = torch.where(is_slider, slider_position(state, joints),
                        hinge_angle(state, joints))
    below = coord < lo
    above = coord > hi
    stop_target = torch.where(below, erp_dt * (lo - coord),
                              erp_dt * (hi - coord))
    wvel = state.angvel
    axis_rel = (torch.sum(_take(wvel, b) * axis_w, -1)
                - torch.sum(_take(wvel, a) * axis_w, -1))
    lin_rel = (torch.sum(_take(state.linvel, b) * axis_w, -1)
               - torch.sum(_take(state.linvel, a) * axis_w, -1))
    coord_vel = torch.where(is_slider, lin_rel, axis_rel)
    approaching = torch.where(below, coord_vel < 0.0, coord_vel > 0.0)
    bounce = wide(joints.stop_bounce)
    bounce_target = torch.where(
        approaching & (bounce > 0.0)
        & (torch.abs(coord_vel) > config.bounce_vel),
        -bounce * coord_vel, 0.0)
    stop_target = torch.where(below,
                              torch.maximum(stop_target, bounce_target),
                              torch.minimum(stop_target, bounce_target))
    lim_n = sel3(is_slider, axis_w, zero3)
    rows_n.append(lim_n)
    rows_wa.append(sel3(is_hinge, axis_w, cross(arm_a, lim_n)))
    rows_wb.append(sel3(is_hinge, axis_w, cross(arm_b, lim_n)))
    rows_rhs.append(stop_target)
    rows_live.append((is_hinge | is_slider) & (below | above))
    rows_lob.append(torch.where(below, zero_j, -inf_j))
    rows_hib.append(torch.where(below, inf_j, zero_j))

    rpj = ROWS_PER_JOINT
    r = jcap * rpj

    def rows3(xs):
        return torch.stack(xs, 2).reshape(bsz, r, 3)

    def rows1(xs):
        return torch.stack(xs, 2).reshape(bsz, r)

    n, wa, wb = rows3(rows_n), rows3(rows_wa), rows3(rows_wb)
    rhs, live = rows1(rows_rhs), rows1(rows_live)
    lob, hib = rows1(rows_lob), rows1(rows_hib)
    a_r = a.repeat_interleave(rpj, 1)
    b_r = b.repeat_interleave(rpj, 1)

    inv_i = world_inv_inertia(state)                      # (B, N, 3, 3)
    ii_a, ii_b = _take(inv_i, a_r), _take(inv_i, b_r)
    inv_m_a, inv_m_b = _take(state.inv_mass, a_r), _take(state.inv_mass, b_r)
    ang_resp_a = _mv(ii_a, wa)
    ang_resp_b = _mv(ii_b, wb)
    d = (torch.sum(n * n, -1) * (inv_m_a + inv_m_b)
         + torch.sum(wa * ang_resp_a, -1)
         + torch.sum(wb * ang_resp_b, -1))
    cfm_term = config.cfm / dt
    d = d + cfm_term

    # mass-splitting degree for the batched update: the live JOINTS (not
    # rows) touching each body, as the contact κ counts contacts
    cols = torch.arange(state.num_slots, device=dev)
    deg = (((cols == a[..., None]) & live_j[..., None]).sum(1)
           + ((cols == b[..., None]) & live_j[..., None]).sum(1)).to(f)
    split = torch.clamp_min(torch.maximum(_take(deg, a_r), _take(deg, b_r)),
                            1.0)

    return dict(a=a_r, b=b_r, n=n, wa=wa, wb=wb,
                ang_resp_a=ang_resp_a, ang_resp_b=ang_resp_b,
                inv_m_a=inv_m_a, inv_m_b=inv_m_b,
                d=(d - cfm_term) * split + cfm_term, d_seq=d,
                rhs=rhs, live=live, lob=lob, hib=hib)


def _impulse_rows(rows, side: str, dl):
    """(…, 8) velocity change of side ``side`` of each row for impulses
    ``dl``: ∓m⁻¹·n·dl ‖ ∓I⁻¹w·dl ‖ pad."""
    sign = -1.0 if side == "a" else 1.0
    imp = rows["n"] * dl[..., None]
    return torch.cat([sign * rows[f"inv_m_{side}"][..., None] * imp,
                      sign * rows[f"ang_resp_{side}"] * dl[..., None],
                      torch.zeros_like(imp[..., :2])], -1)


def joint_iteration(vel8, rows, lam, omega, cfm_term):
    """One batched (Jacobi, mass-split) pass over all joint rows of every
    world: rows read the velocities of the pass's start. ``vel8``:
    (B, N, 8) packed [linvel ‖ angvel ‖ pad]; ``lam``: (B, R). Gathers and
    the scatter are one-hot ``bmm``s. Returns (vel8', lam')."""
    f = vel8.dtype
    n_slots = vel8.shape[1]
    oh_a = torch.nn.functional.one_hot(rows["a"].to(torch.int64),
                                       n_slots).to(f)     # (B, R, N)
    oh_b = torch.nn.functional.one_hot(rows["b"].to(torch.int64),
                                       n_slots).to(f)
    va = torch.bmm(oh_a, vel8)
    vb = torch.bmm(oh_b, vel8)
    rel = (torch.sum((vb[..., 0:3] - va[..., 0:3]) * rows["n"], -1)
           + torch.sum(vb[..., 3:6] * rows["wb"], -1)
           - torch.sum(va[..., 3:6] * rows["wa"], -1))
    # target velocity +erp/dt·error; equality rows have ±inf bounds,
    # motor and limit rows are clamped
    dl = omega * (rows["rhs"] - rel - cfm_term * lam) / rows["d"]
    new_lam = torch.clamp(lam + dl, rows["lob"], rows["hib"])
    dl = torch.where(rows["live"], new_lam - lam, 0.0)
    lam = lam + dl
    dv = (torch.bmm(oh_a.transpose(1, 2), _impulse_rows(rows, "a", dl))
          + torch.bmm(oh_b.transpose(1, 2), _impulse_rows(rows, "b", dl)))
    return vel8 + dv, lam


def live_joint_rows(rows) -> list:
    """The rows live in some world of the batch, in order: the rows a
    sequential pass must visit (a dead row changes nothing). One host
    read."""
    return torch.nonzero(rows["live"].any(0)).flatten().tolist()


def joint_iteration_seq(vel8, rows, lam, omega, cfm_term, visit=None):
    """One sequential (Gauss-Seidel) SOR pass over the joint rows: each row
    sees the velocities every earlier row wrote, ODE QuickStep's order.
    ``vel8``: (B, N, 8); ``lam``: (B, R); ``visit``: the rows to visit
    (``live_joint_rows(rows)``, read once per solve; taken here when not
    given). A Python loop over rows on (B,) tensors, batched over worlds.
    Returns (vel8', lam'), new tensors."""
    if visit is None:
        visit = live_joint_rows(rows)
    vel8, lam = vel8.clone(), lam.clone()
    ar = torch.arange(vel8.shape[0], device=vel8.device)
    a_r, b_r = rows["a"].to(torch.int64), rows["b"].to(torch.int64)
    for i in visit:
        a, b = a_r[:, i], b_r[:, i]
        va, vb = vel8[ar, a], vel8[ar, b]
        rel = (torch.sum((vb[:, 0:3] - va[:, 0:3]) * rows["n"][:, i], -1)
               + torch.sum(vb[:, 3:6] * rows["wb"][:, i], -1)
               - torch.sum(va[:, 3:6] * rows["wa"][:, i], -1))
        dl = (omega * (rows["rhs"][:, i] - rel - cfm_term * lam[:, i])
              / rows["d_seq"][:, i])
        new = torch.clamp(lam[:, i] + dl, rows["lob"][:, i],
                          rows["hib"][:, i])
        dl = torch.where(rows["live"][:, i], new - lam[:, i], 0.0)
        lam[:, i] += dl
        row = {k: rows[k][:, i] for k in ("n", "inv_m_a", "inv_m_b",
                                          "ang_resp_a", "ang_resp_b")}
        vel8[ar, a] += _impulse_rows(row, "a", dl)
        vel8[ar, b] += _impulse_rows(row, "b", dl)
    return vel8, lam


def feedback(rows, lam, dt: float):
    """dJointGetFeedback: each joint's constraint force and torque on its
    two bodies from the solved row impulses ``lam`` (B, R): a dict of
    (B, J, 3) world-frame tensors (impulse / dt)."""
    bsz, r = lam.shape
    jcap = r // ROWS_PER_JOINT
    lam_c = lam[..., None]

    def per_joint(x):
        return (x * lam_c).reshape(bsz, jcap, ROWS_PER_JOINT, 3).sum(2) / dt

    f_b = per_joint(rows["n"])
    t_b = per_joint(rows["wb"])
    t_a = -per_joint(rows["wa"])
    return dict(force_a=-f_b, torque_a=t_a, force_b=f_b, torque_b=t_b)
