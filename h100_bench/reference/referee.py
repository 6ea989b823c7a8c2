"""Independent float64 NumPy QuickStep referee, frozen for the benchmark.

A copy of the port's ``testing/referee.py`` as it stood when the
benchmark was defined, less its mesh, joint and direct-solve paths (no
cell runs them), kept here so that a later change to the program cannot
move the yardstick. It imports nothing of either package.

A second, from-spec implementation of the ODE QuickStep pipeline the
engine re-derives (the reference's main loop: ``src/main.c:212-214`` —
``dSpaceCollide; dWorldStep; dJointGroupEmpty`` — with the NearCallback
surface parameters of ``src/main.c:684-687``). The engine runs
vectorized, masked, fixed-shape tensor programs; this referee is scalar
Python loops over plain float64 NumPy — a maximally different execution
path for the *same documented contract*:

* broadphase: all pairs (i < j), AABB overlap, ODE's
  ``(cat1 & col2) || (cat2 & col1)`` filter, at-least-one-movable;
* narrowphase: the primitive pair kernels (sphere/box/capsule/plane) with
  the engine's documented deterministic manifold conventions (canonical
  type ordering, ODE dBoxBox SAT with the 1.05 face-preference fudge and
  Sutherland-Hodgman reference-face clipping, fixed corner enumeration
  order) — these conventions are part of the engine spec, so both
  implementations produce identical row sets in identical order;
* contact rows: ERP/CFM-regularized, bounce-velocity restitution,
  infinite-mu friction (``src/main.c:684-687``);
* solve: projected Gauss-Seidel (SOR) sweeps in buffer row order —
  QuickStep semantics with the deterministic row order the engine
  documents (``ops/solver.py:solve_pgs``);
* integrate: semi-implicit Euler with the gyroscopic Euler term and the
  infinitesimal quaternion update.

Everything here is intentionally simple and slow: correctness oracle, not
a throughput path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_EPS = 1e-9


@dataclasses.dataclass
class RefereeConfig:
    dt: float = 1.0 / 120.0
    gravity: tuple = (0.0, -9.8, 0.0)
    solver_iterations: int = 20
    sor_omega: float = 1.3
    erp: float = 0.2
    cfm: float = 1e-5
    max_correcting_vel: float = 1e30
    bounce: float = 0.2
    bounce_vel: float = 0.1
    mu: float = math.inf
    friction: bool = True
    max_contacts_per_pair: int = 8


# --- body type codes (mirrors core.state.BodyType) -------------------------
NULL, SPHERE, BOX, CAPSULE, PLANE, TRIMESH = 0, 1, 2, 3, 4, 5


# ---------------------------------------------------------------------------
# small math
# ---------------------------------------------------------------------------

def quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], np.float64)


def tangent_basis(n):
    """Engine-spec deterministic tangent frame (ops/solver.py:_tangent_basis):
    e = world axis least aligned with n, t1 = cross(n, e) normalized."""
    ax = int(np.argmin(np.abs(n)))
    e = np.zeros(3)
    e[ax] = 1.0
    t1 = np.cross(n, e)
    t1 = t1 / max(np.linalg.norm(t1), _EPS)
    t2 = np.cross(n, t1)
    return t1, t2


def world_inv_inertia(q, inv_inertia_diag):
    r = quat_to_matrix(q)
    return r @ np.diag(inv_inertia_diag) @ r.T


# ---------------------------------------------------------------------------
# narrowphase pair kernels (scalar; engine-spec manifold conventions)
# Each returns a list of (point, normal a->b, depth) with depth > 0.
# ---------------------------------------------------------------------------

def _sphere_sphere(pa, qa, sa, pb, qb, sb):
    ra, rb = sa[0], sb[0]
    d = pb - pa
    dist = np.linalg.norm(d)
    n = d / dist if dist > _EPS else np.array([0.0, 1.0, 0.0])
    depth = ra + rb - dist
    if depth > 0.0:
        return [(pa + n * (ra - 0.5 * depth), n, depth)]
    return []


def _sphere_box_point(center, radius, pb, rb, half):
    """Sphere (or probe sphere) vs oriented box; engine-spec inside/outside
    handling (ops/narrowphase.py:_sphere_box_core)."""
    p_local = rb.T @ (center - pb)
    clamped = np.clip(p_local, -half, half)
    delta = p_local - clamped
    dist = np.linalg.norm(delta)
    if dist > _EPS:
        n_local = -delta / dist
        depth = radius - dist
        surf_local = clamped
    else:
        face_dist = half - np.abs(p_local)
        ax = int(np.argmin(face_dist))
        sign = 1.0 if p_local[ax] >= 0.0 else -1.0
        n_local = np.zeros(3)
        n_local[ax] = sign
        depth = radius + face_dist[ax]
        surf_local = p_local + n_local * face_dist[ax]
    point = pb + rb @ surf_local
    return point, rb @ n_local, depth


def _sphere_box(pa, qa, sa, pb, qb, sb):
    point, n, depth = _sphere_box_point(pa, sa[0], pb, quat_to_matrix(qb),
                                        0.5 * sb)
    return [(point, n, depth)] if depth > 0.0 else []


def _plane_params(p, q):
    n = quat_to_matrix(q)[:, 2]
    return n, float(n @ p)


def _sphere_plane(pa, qa, sa, pb, qb, sb):
    n_p, d_p = _plane_params(pb, qb)
    h = float(n_p @ pa) - d_p
    depth = sa[0] - h
    if depth > 0.0:
        return [(pa - n_p * h, -n_p, depth)]
    return []


# corner enumeration order must match the engine's _BOX_CORNERS
_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)], np.float64)


def _box_plane(pa, qa, sa, pb, qb, sb):
    n_p, d_p = _plane_params(pb, qb)
    ra = quat_to_matrix(qa)
    out = []
    for corner in _BOX_CORNERS:
        c = pa + ra @ (corner * (0.5 * sa))
        depth = d_p - float(c @ n_p)
        if depth > 0.0:
            out.append((c, -n_p, depth))
    return out


def _segment_endpoints(p, q, length):
    axis = quat_to_matrix(q)[:, 2]
    h = 0.5 * length
    return p - axis * h, p + axis * h, axis


def _closest_on_segment(a0, a1, p):
    d = a1 - a0
    t = float((p - a0) @ d) / max(float(d @ d), _EPS)
    return a0 + np.clip(t, 0.0, 1.0) * d


def _segment_segment(p0, p1, q0, q1):
    d1, d2, r = p1 - p0, q1 - q0, p0 - q0
    a, e = float(d1 @ d1), float(d2 @ d2)
    f, c, b = float(d2 @ r), float(d1 @ r), float(d1 @ d2)
    denom = a * e - b * b
    s = np.clip((b * f - c * e) / max(denom, _EPS), 0.0, 1.0) if denom > _EPS else 0.0
    t = (b * s + f) / max(e, _EPS)
    t_cl = np.clip(t, 0.0, 1.0)
    s = np.clip((b * t_cl - c) / max(a, _EPS), 0.0, 1.0)
    return p0 + s * d1, q0 + t_cl * d2


def _sphere_capsule(pa, qa, sa, pb, qb, sb):
    b0, b1, _ = _segment_endpoints(pb, qb, sb[1])
    closest = _closest_on_segment(b0, b1, pa)
    return _sphere_sphere(pa, qa, sa, closest, qb, sb)


def _capsule_capsule(pa, qa, sa, pb, qb, sb):
    a0, a1, ax_a = _segment_endpoints(pa, qa, sa[1])
    b0, b1, ax_b = _segment_endpoints(pb, qb, sb[1])
    ca, cb = _segment_segment(a0, a1, b0, b1)
    out = _sphere_sphere(ca, qa, sa, cb, qb, sb)

    if abs(float(ax_a @ ax_b)) > 0.999:        # near-parallel: second support
        far_a = a0 if float((ca - a0) @ (ca - a0)) > float((ca - a1) @ (ca - a1)) else a1
        cb2 = _closest_on_segment(b0, b1, far_a)
        ca2 = _closest_on_segment(a0, a1, cb2)
        if float((ca2 - ca) @ (ca2 - ca)) > 1e-8:
            out += _sphere_sphere(ca2, qa, sa, cb2, qb, sb)
    return out


def _capsule_plane(pa, qa, sa, pb, qb, sb):
    n_p, d_p = _plane_params(pb, qb)
    a0, a1, _ = _segment_endpoints(pa, qa, sa[1])
    r = sa[0]
    out = []
    for e in (a0, a1):
        h = float(n_p @ e) - d_p
        depth = r - h
        if depth > 0.0:
            out.append((e - n_p * h, -n_p, depth))
    return out


def _capsule_box(pa, qa, sa, pb, qb, sb):
    """Engine-spec probe decomposition: both cap endpoints plus the segment
    point closest to the box center, mid dropped when it coincides with an
    endpoint (ops/narrowphase.py:_capsule_box)."""
    rb = quat_to_matrix(qb)
    half = 0.5 * sb
    r = sa[0]
    a0, a1, _ = _segment_endpoints(pa, qa, sa[1])
    mid = _closest_on_segment(a0, a1, pb)
    dup = (np.linalg.norm(mid - a0) < 1e-6) or (np.linalg.norm(mid - a1) < 1e-6)

    out = []
    for idx, probe in enumerate((a0, a1, mid)):
        point, n, depth = _sphere_box_point(probe, r, pb, rb, half)
        if depth > 0.0 and not (idx == 2 and dup):
            out.append((point, n, depth))
    return out


def _clip_quad_to_rect(quad, hx, hy):
    """Sutherland-Hodgman clip of a quad against |x|<=hx, |y|<=hy, in the
    engine's traversal order (planes +x, -x, +y, -y; per edge: emit the
    inside current vertex, then the crossing point)."""
    planes = [(np.array([1.0, 0.0]), hx), (np.array([-1.0, 0.0]), hx),
              (np.array([0.0, 1.0]), hy), (np.array([0.0, -1.0]), hy)]
    verts = [np.asarray(v, np.float64) for v in quad]
    for ab, lim in planes:
        out = []
        m = len(verts)
        for i in range(m):
            cur, nxt = verts[i], verts[(i + 1) % m]
            in_cur = float(ab @ cur) <= lim
            in_nxt = float(ab @ nxt) <= lim
            if in_cur:
                out.append(cur)
            denom = float(ab @ (nxt - cur))
            if in_cur != in_nxt and abs(denom) > _EPS:
                t = np.clip((lim - float(ab @ cur)) / denom, 0.0, 1.0)
                out.append(cur + t * (nxt - cur))
            if len(out) >= 8:        # engine static capacity
                out = out[:8]
        verts = out
    return verts[:8]


def _box_box(pa, qa, sa, pb, qb, sb):
    """ODE dBoxBox structure: SAT over 15 axes with the 1.05 face-preference
    fudge, reference-face Sutherland-Hodgman clipping / edge-edge closest
    points (engine spec: ops/narrowphase.py:_box_box with exact_clip)."""
    ra, rb = quat_to_matrix(qa), quat_to_matrix(qb)
    ha, hb = 0.5 * sa, 0.5 * sb

    t_world = pb - pa
    t = ra.T @ t_world
    c = ra.T @ rb
    absc = np.abs(c) + 1e-6

    sep_a = np.abs(t) - (ha + absc @ hb)
    t_b = c.T @ t
    sep_b = np.abs(t_b) - (hb + absc.T @ ha)

    eye = np.eye(3)
    cols = c.T
    u_all = np.cross(eye[:, None, :], cols[None, :, :]).reshape(9, 3)
    norms = np.linalg.norm(u_all, axis=-1)
    edge_oks = norms > 1e-6
    edge_units = u_all / np.maximum(norms, _EPS)[:, None]
    proj_a = np.sum(np.abs(edge_units) * ha[None, :], axis=1)
    un_in_b = np.einsum("ki,ij->kj", edge_units, c)
    proj_b = np.sum(np.abs(un_in_b) * hb[None, :], axis=1)
    edge_seps = np.abs(edge_units @ t) - (proj_a + proj_b)

    all_seps = np.concatenate([sep_a, sep_b,
                               np.where(edge_oks, edge_seps, -np.inf)])
    if np.max(all_seps) > 0.0:
        return []

    fudge = 1.05
    faces = np.concatenate([sep_a, sep_b])
    best_face_sep = float(np.max(faces))
    best_face_code = int(np.argmax(faces))
    edge_adj = np.where(
        edge_oks,
        edge_seps * np.where(edge_seps < 0, 1.0 / fudge, fudge), -np.inf)
    best_edge_idx = int(np.argmax(edge_adj))
    use_edge = float(edge_adj[best_edge_idx]) > best_face_sep

    if use_edge:
        u_a = edge_units[best_edge_idx]
        sign_e = 1.0 if float(u_a @ t) >= 0.0 else -1.0
        n_a = u_a * sign_e
        n_world = ra @ n_a
        ei, ej = best_edge_idx // 3, best_edge_idx % 3
        oh_ei = np.zeros(3); oh_ei[ei] = 1.0
        oh_ej = np.zeros(3); oh_ej[ej] = 1.0

        sgn_a = np.where(n_a >= 0.0, 1.0, -1.0) * (1.0 - oh_ei)
        pa_sup = pa + ra @ (sgn_a * ha)
        da = ra @ oh_ei
        a0, a1 = pa_sup - da * ha[ei], pa_sup + da * ha[ei]

        n_b_frame = -(c.T @ n_a)
        sgn_b = np.where(n_b_frame >= 0.0, 1.0, -1.0) * (1.0 - oh_ej)
        pb_sup = pb + rb @ (sgn_b * hb)
        db = rb @ oh_ej
        b0, b1 = pb_sup - db * hb[ej], pb_sup + db * hb[ej]

        ca, cb = _segment_segment(a0, a1, b0, b1)
        depth = -float(edge_seps[best_edge_idx])
        if depth > 0.0:
            return [(0.5 * (ca + cb), n_world, depth)]
        return []

    # face case
    face_is_a = best_face_code < 3
    axis_idx = best_face_code if face_is_a else best_face_code - 3
    r_ref, r_inc = (ra, rb) if face_is_a else (rb, ra)
    p_ref, p_inc = (pa, pb) if face_is_a else (pb, pa)
    h_ref, h_inc = (ha, hb) if face_is_a else (hb, ha)

    axes_ref = r_ref.T
    n_ref_raw = axes_ref[axis_idx]
    sign_f = 1.0 if float(n_ref_raw @ (p_inc - p_ref)) >= 0.0 else -1.0
    n_ref = n_ref_raw * sign_f
    n_world = n_ref if face_is_a else -n_ref

    idx0 = 1 if axis_idx == 0 else 0
    idx1 = 1 if axis_idx == 2 else 2
    u0, u1 = axes_ref[idx0], axes_ref[idx1]
    hu0, hu1 = h_ref[idx0], h_ref[idx1]
    face_center = p_ref + n_ref * h_ref[axis_idx]

    axes_inc = r_inc.T
    align = axes_inc @ n_ref
    inc_axis = int(np.argmax(np.abs(align)))
    inc_sign = -np.sign(align[inc_axis])
    inc_axis_vec = axes_inc[inc_axis]
    inc_center = p_inc + inc_axis_vec * inc_sign * h_inc[inc_axis]
    j0 = 1 if inc_axis == 0 else 0
    j1 = 1 if inc_axis == 2 else 2
    v0 = axes_inc[j0] * h_inc[j0]
    v1 = axes_inc[j1] * h_inc[j1]
    quad_world = [inc_center + v0 + v1, inc_center + v0 - v1,
                  inc_center - v0 - v1, inc_center - v0 + v1]

    quad2d = [np.array([float((qw - face_center) @ u0),
                        float((qw - face_center) @ u1)]) for qw in quad_world]
    verts2d = _clip_quad_to_rect(quad2d, hu0, hu1)

    inc_n = inc_axis_vec * inc_sign
    denom = float(inc_n @ n_ref)
    d_inc = float(inc_n @ inc_center)
    out = []
    for v in verts2d:
        base = face_center + v[0] * u0 + v[1] * u1
        z = (d_inc - float(base @ inc_n)) / (denom if abs(denom) > 1e-6 else 1.0)
        depth = -z
        if depth > 0.0:
            lifted = base + z * n_ref
            out.append((lifted - 0.5 * depth * n_ref, n_world, depth))
    return out


_PAIR_KERNELS = {
    (SPHERE, SPHERE): _sphere_sphere,
    (SPHERE, BOX): _sphere_box,
    (SPHERE, CAPSULE): _sphere_capsule,
    (SPHERE, PLANE): _sphere_plane,
    (BOX, BOX): _box_box,
    (BOX, CAPSULE): lambda pa, qa, sa, pb, qb, sb: [
        (p, -n, d) for (p, n, d) in _capsule_box(pb, qb, sb, pa, qa, sa)],
    (BOX, PLANE): _box_plane,
    (CAPSULE, CAPSULE): _capsule_capsule,
    (CAPSULE, PLANE): _capsule_plane,
}


def collide_pair(pa, qa, ta, sa, pb, qb, tb, sb):
    """Engine-spec canonical dispatch: lower type code is A; normals flipped
    back when swapped."""
    swapped = ta > tb
    if swapped:
        pa, pb, qa, qb, sa, sb, ta, tb = pb, pa, qb, qa, sb, sa, tb, ta
    kernel = _PAIR_KERNELS.get((int(ta), int(tb)))
    if kernel is None:
        return []
    out = kernel(pa, qa, sa, pb, qb, sb)
    if swapped:
        out = [(p, -n, d) for (p, n, d) in out]
    return out


# ---------------------------------------------------------------------------
# AABBs (engine spec: |R|·h bound per type)
# ---------------------------------------------------------------------------

def _aabb(pos, q, t, sz):
    r = np.abs(quat_to_matrix(q))
    if t == SPHERE:
        half = np.full(3, sz[0])
    elif t == BOX:
        half = 0.5 * sz
    elif t == CAPSULE:
        half = np.array([sz[0], sz[0], 0.5 * sz[1] + sz[0]])
    elif t in (PLANE, TRIMESH):
        half = np.full(3, 1e9)
    else:
        return np.full(3, 1.0), np.full(3, -1.0)      # NULL: inverted box
    ext = r @ half
    return pos - ext, pos + ext


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _contacts(w, cfg: RefereeConfig):
    """Rows in the engine's deterministic buffer order: pairs by flattened
    upper-triangular (i*N+j) index, manifold slots in kernel order."""
    n = len(w["body_type"])
    boxes = [_aabb(w["pos"][i], w["quat"][i], int(w["body_type"][i]),
                   w["size"][i]) for i in range(n)]
    cat, col = w["category"], w["collide"]
    movable = w["inv_mass"] > 0
    active = w["body_type"] != NULL

    rows = []
    for i in range(n):
        for j in range(i + 1, n):
            ti, tj = int(w["body_type"][i]), int(w["body_type"][j])
            if not (active[i] and active[j]):
                continue
            if ti == TRIMESH or tj == TRIMESH:
                continue
            if not (movable[i] or movable[j]):
                continue
            if not ((int(cat[i]) & int(col[j])) or (int(cat[j]) & int(col[i]))):
                continue
            lo_i, hi_i = boxes[i]
            lo_j, hi_j = boxes[j]
            if not (np.all(lo_i <= hi_j) and np.all(lo_j <= hi_i)):
                continue
            manifold = collide_pair(
                w["pos"][i], w["quat"][i], ti, w["size"][i],
                w["pos"][j], w["quat"][j], tj, w["size"][j],
            )
            for (p, nrm, d) in manifold[:cfg.max_contacts_per_pair]:
                rows.append((i, j, p, nrm, d))
    return rows


def referee_step(w: dict, cfg: RefereeConfig) -> dict:
    """One 120 Hz substep: collide -> external forces -> PGS -> integrate
    (the engine's documented pipeline order, core/world.py:step)."""
    w = {k: np.copy(v) for k, v in w.items()}
    n = len(w["body_type"])
    dt = cfg.dt

    rows = _contacts(w, cfg)

    # external forces: gravity on dynamic non-kinematic; gyroscopic term
    g = np.asarray(cfg.gravity, np.float64)
    inv_i_world = [world_inv_inertia(w["quat"][i], w["inv_inertia"][i])
                   for i in range(n)]
    for i in range(n):
        dyn = (w["body_type"][i] != NULL and not w["is_static"][i]
               and not w["is_kinematic"][i])
        if dyn:
            w["linvel"][i] = w["linvel"][i] + dt * g
        inv_diag = w["inv_inertia"][i]
        i_body = np.where(inv_diag > 0, 1.0 / np.maximum(inv_diag, 1e-30), 0.0)
        r = quat_to_matrix(w["quat"][i])
        i_world = r @ np.diag(i_body) @ r.T
        gyro = np.cross(w["angvel"][i], i_world @ w["angvel"][i])
        w["angvel"][i] = w["angvel"][i] + dt * (inv_i_world[i] @ (-gyro))

    # row data (engine spec: ops/solver.py:_row_data)
    cfm_term = cfg.cfm / dt
    rowdata = []
    for (a, b, p, nrm, depth) in rows:
        r_a = p - w["pos"][a]
        r_b = p - w["pos"][b]
        t1, t2 = tangent_basis(nrm)

        def eff(axis):
            rxn_a, rxn_b = np.cross(r_a, axis), np.cross(r_b, axis)
            return (w["inv_mass"][a] + w["inv_mass"][b]
                    + float(rxn_a @ (inv_i_world[a] @ rxn_a))
                    + float(rxn_b @ (inv_i_world[b] @ rxn_b)))

        d_n, d_t1, d_t2 = eff(nrm) + cfm_term, eff(t1) + cfm_term, eff(t2) + cfm_term
        va0 = w["linvel"][a] + np.cross(w["angvel"][a], r_a)
        vb0 = w["linvel"][b] + np.cross(w["angvel"][b], r_b)
        v_n0 = float((vb0 - va0) @ nrm)
        bias = min(cfg.erp * depth / dt, cfg.max_correcting_vel)
        bounce = -cfg.bounce * v_n0 if -v_n0 > cfg.bounce_vel else 0.0
        target = max(bias, bounce)
        rowdata.append(dict(a=a, b=b, r_a=r_a, r_b=r_b, n=nrm, t1=t1, t2=t2,
                            d_n=d_n, d_t1=d_t1, d_t2=d_t2, target=target))

    _solve_pgs(w, rowdata, inv_i_world, cfg)

    # integrate positions (engine spec: ops/integrator.py)
    for i in range(n):
        if w["body_type"][i] == NULL or w["is_static"][i]:
            continue
        w["pos"][i] = w["pos"][i] + dt * w["linvel"][i]
        omega_q = np.array([0.0, *w["angvel"][i]])
        q = w["quat"][i] + dt * 0.5 * quat_mul(omega_q, w["quat"][i])
        w["quat"][i] = q / max(np.linalg.norm(q), 1e-12)
    return w


def _solve_pgs(w, rowdata, inv_i_world, cfg: RefereeConfig):
    """QuickStep SOR sweeps (engine spec: ops/solver.py:solve_pgs — buffer
    row order, normal then t1 then t2 per row, SOR omega, CFM softening,
    lambda accumulation)."""
    cfm_term = cfg.cfm / cfg.dt
    omega = cfg.sor_omega
    mu_inf = math.isinf(cfg.mu)
    lam_n = np.zeros(len(rowdata))
    lam_1 = np.zeros(len(rowdata))
    lam_2 = np.zeros(len(rowdata))

    def rel_v(rd, axis):
        a, b = rd["a"], rd["b"]
        va = w["linvel"][a] + np.cross(w["angvel"][a], rd["r_a"])
        vb = w["linvel"][b] + np.cross(w["angvel"][b], rd["r_b"])
        return float((vb - va) @ axis)

    def apply(rd, axis, dlam):
        a, b = rd["a"], rd["b"]
        imp = axis * dlam
        w["linvel"][a] = w["linvel"][a] - w["inv_mass"][a] * imp
        w["angvel"][a] = w["angvel"][a] - inv_i_world[a] @ np.cross(rd["r_a"], imp)
        w["linvel"][b] = w["linvel"][b] + w["inv_mass"][b] * imp
        w["angvel"][b] = w["angvel"][b] + inv_i_world[b] @ np.cross(rd["r_b"], imp)

    for _ in range(cfg.solver_iterations):
        for k in range(len(rowdata)):
            rd = rowdata[k]
            # residual includes ODE's CFM softening −cfm/h·λ (QuickStep
            # converges to (A + cfm/h·I)λ = rhs — engine spec ops/solver.py)
            dlam = omega * (rd["target"] - rel_v(rd, rd["n"])
                            - cfm_term * lam_n[k]) / rd["d_n"]
            new = max(lam_n[k] + dlam, 0.0)
            dlam = new - lam_n[k]
            lam_n[k] = new
            apply(rd, rd["n"], dlam)

            if cfg.friction:
                bound = math.inf if mu_inf else cfg.mu * lam_n[k]
                dls = omega * (0.0 - rel_v(rd, rd["t1"])
                               - cfm_term * lam_1[k]) / rd["d_t1"]
                new = np.clip(lam_1[k] + dls, -bound, bound)
                dls = new - lam_1[k]
                lam_1[k] = new
                apply(rd, rd["t1"], dls)

                dls = omega * (0.0 - rel_v(rd, rd["t2"])
                               - cfm_term * lam_2[k]) / rd["d_t2"]
                new = np.clip(lam_2[k] + dls, -bound, bound)
                dls = new - lam_2[k]
                lam_2[k] = new
                apply(rd, rd["t2"], dls)
