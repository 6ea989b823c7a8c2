"""The row-major pair kernels: each type pair's contact manifold, and
``collide_pair``, which runs a table of them on body pairs of any type.

The pair kernels of ``rl_ode_physics_tpu/ops/narrowphase.py``. Every pair
kernel returns a fixed-capacity manifold of K slots (point, normal, depth,
valid), so a caller is branch-free: per-pair type dispatch is a selection,
not control flow. A kernel takes tensors with any leading axes (pairs,
worlds by pairs, the (N, N) grid of the dense pipeline) in place of the
JAX package's ``vmap``.

Conventions: the contact normal points from body a toward body b;
``depth > 0`` is penetration; capsules lie along their local Z axis with
``size`` (radius, cylinder length, -); a plane's world normal is its local
Z axis.

The pipelines in ``ops/narrowphase.py`` and ``ops/dense.py`` call them;
``ops/collide_kernel.py`` holds the classic narrowphase's hand kernel to
them (``csrc/collide_pairs.cu`` computes each pair kernel as written
here).
"""

from __future__ import annotations

import functools

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.ops.compaction import top_k_indices
from rl_ode_physics_tpu_torch.utils import graphs
from rl_ode_physics_tpu_torch.utils import quat as quat_m

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Small helpers on (..., 3) vectors and (..., 3, 3) matrices
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _mv(m, v):
    """m (..., 3, 3) @ v (..., 3)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _mtv(m, v):
    """m.T @ v for m (..., 3, 3), v (..., 3)."""
    return torch.sum(m * v[..., :, None], dim=-2)


def _mtm(a, b):
    """a.T @ b for a, b (..., 3, 3)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def _sel(v, idx):
    """v (..., k) at idx (...) → (...)."""
    return torch.gather(v, -1, idx[..., None])[..., 0]


def _sel_row(m, idx):
    """m (..., k, d) at row idx (...) → (..., d)."""
    idx = idx[..., None, None].expand(idx.shape + (1, m.shape[-1]))
    return torch.gather(m, -2, idx)[..., 0, :]


def _onehot(idx, k, dtype):
    return torch.nn.functional.one_hot(idx, k).to(dtype)


def _sign(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def _pad_manifold(points, normals, depths, valid, k: int):
    """Pad an (..., m, ·) manifold to k slots."""
    m = points.shape[-2]
    if m == k:
        return points, normals, depths, valid
    if m > k:
        raise ValueError(f"a {m}-slot manifold does not fit in K={k}")
    pad = k - m
    lead = points.shape[:-2]

    def z(x, *tail):
        return torch.zeros(lead + (pad,) + tail, dtype=x.dtype,
                           device=x.device)

    return (torch.cat([points, z(points, 3)], -2),
            torch.cat([normals, z(normals, 3)], -2),
            torch.cat([depths, z(depths)], -1),
            torch.cat([valid, z(valid)], -1))


def _one_slot(point, n, depth, k):
    return _pad_manifold(point[..., None, :], n[..., None, :],
                         depth[..., None], (depth > 0.0)[..., None], k)


# ---------------------------------------------------------------------------
# Primitive pair kernels: (points (..., k, 3), normals, depths (..., k),
# valid (..., k))
# ---------------------------------------------------------------------------

def _sphere_sphere(pa, qa, sa, pb, qb, sb, k):
    ra, rb = sa[..., 0], sb[..., 0]
    d = pb - pa
    dist = _norm(d)
    n = d / torch.clamp_min(dist, _EPS)[..., None]
    # coincident centres: a deterministic up normal
    up = graphs.constant((0.0, 1.0, 0.0), d.dtype, d.device)
    n = torch.where((dist > _EPS)[..., None], n, up)
    depth = ra + rb - dist
    point = pa + n * (ra - 0.5 * depth)[..., None]
    return _one_slot(point, n, depth, k)


def _sphere_box_core(center, radius, pb, rb_mat, half):
    """Sphere against an oriented box: (point, normal a→b, depth)."""
    p_local = _mtv(rb_mat, center - pb)
    clamped = torch.minimum(torch.maximum(p_local, -half), half)
    delta = p_local - clamped
    dist = _norm(delta)
    outside = dist > _EPS

    n_local_out = -delta / torch.clamp_min(dist, _EPS)[..., None]
    depth_out = radius - dist

    # centre inside the box: push out along the closest face
    face_dist = half - torch.abs(p_local)
    oh = _onehot(torch.argmin(face_dist, dim=-1), 3, p_local.dtype)
    p_ax = torch.sum(p_local * oh, dim=-1)
    fd_ax = torch.sum(face_dist * oh, dim=-1)
    n_local_in = oh * _sign(p_ax)[..., None]
    depth_in = radius + fd_ax

    out3 = outside[..., None]
    n_local = torch.where(out3, n_local_out, n_local_in)
    depth = torch.where(outside, depth_out, depth_in)
    surf_local = torch.where(out3, clamped,
                             p_local + n_local_in * fd_ax[..., None])
    point = pb + _mv(rb_mat, surf_local)
    return point, _mv(rb_mat, n_local), depth


def _sphere_box(pa, qa, sa, pb, qb, sb, k):
    point, n, depth = _sphere_box_core(pa, sa[..., 0], pb,
                                       quat_m.to_matrix(qb), 0.5 * sb)
    return _one_slot(point, n, depth, k)


def _plane_params(p, q):
    """Plane world normal (local +Z) and offset d with n·x = d."""
    n = quat_m.to_matrix(q)[..., :, 2]
    return n, _dot(n, p)


def _sphere_plane(pa, qa, sa, pb, qb, sb, k):
    n_p, d_p = _plane_params(pb, qb)
    h = _dot(n_p, pa) - d_p
    depth = sa[..., 0] - h
    point = pa - n_p * h[..., None]
    return _one_slot(point, -n_p, depth, k)


_BOX_CORNERS = tuple((sx, sy, sz) for sx in (-1.0, 1.0)
                     for sy in (-1.0, 1.0) for sz in (-1.0, 1.0))   # (8, 3)


def _box_plane(pa, qa, sa, pb, qb, sb, k):
    n_p, d_p = _plane_params(pb, qb)
    ra = quat_m.to_matrix(qa)
    signs = graphs.constant(_BOX_CORNERS, pa.dtype, pa.device)
    corners = pa[..., None, :] + _mv(ra[..., None, :, :],
                                     signs * (0.5 * sa)[..., None, :])
    depths = d_p[..., None] - torch.sum(corners * n_p[..., None, :], -1)
    valid = depths > 0.0
    normals = (-n_p)[..., None, :].expand(corners.shape)
    if k == 4:
        return _fold_manifold(corners, normals, depths, valid,
                              [7, 6, 5, 4])     # antipodal corners
    if k < 8:
        return _topk_manifold(corners, normals, depths, valid, k)
    return _pad_manifold(corners, normals, depths, valid, k)


def _fold_manifold(points, normals, depths, valid, pairing):
    """8-slot manifold → 4 slots: slot i against slot ``pairing[i]``, the
    valid one, or the deeper of two valid ones, survives."""
    lo = graphs.constant(tuple(range(4)), torch.int64, points.device)
    hi = graphs.constant(tuple(pairing), torch.int64, points.device)
    p_lo, p_hi = points[..., lo, :], points[..., hi, :]
    n_lo, n_hi = normals[..., lo, :], normals[..., hi, :]
    d_lo, d_hi = depths[..., lo], depths[..., hi]
    v_lo, v_hi = valid[..., lo], valid[..., hi]
    take_hi = (v_hi & ~v_lo) | (v_hi & v_lo & (d_hi > d_lo))
    t3 = take_hi[..., None]
    return (torch.where(t3, p_hi, p_lo), torch.where(t3, n_hi, n_lo),
            torch.where(take_hi, d_hi, d_lo), torch.where(take_hi, v_hi, v_lo))


def _topk_manifold(points, normals, depths, valid, k):
    """The k deepest valid slots of an 8-slot manifold (the lower slot
    first among equal keys, as ``jax.lax.top_k``)."""
    top = top_k_indices(torch.where(valid, depths, -torch.inf), k)
    top3 = top[..., None].expand(top.shape + (3,))
    return (torch.gather(points, -2, top3), torch.gather(normals, -2, top3),
            torch.gather(depths, -1, top), torch.gather(valid, -1, top))


def _segment_endpoints(p, q, length):
    """World endpoints of a capsule's core segment (local Z axis)."""
    axis = quat_m.to_matrix(q)[..., :, 2]
    h = (0.5 * length)[..., None]
    return p - axis * h, p + axis * h, axis


def _closest_on_segment(a0, a1, p):
    d = a1 - a0
    t = _dot(p - a0, d) / torch.clamp_min(_dot(d, d), _EPS)
    return a0 + torch.clamp(t, 0.0, 1.0)[..., None] * d


def _segment_segment(p0, p1, q0, q1):
    """Closest points between segments [p0, p1] and [q0, q1]."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > _EPS,
                    torch.clamp((b * f - c * e) / torch.clamp_min(denom, _EPS),
                                0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp_min(e, _EPS)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp_min(a, _EPS), 0.0, 1.0)
    return p0 + s[..., None] * d1, q0 + t_cl[..., None] * d2


def _sphere_capsule(pa, qa, sa, pb, qb, sb, k):
    b0, b1, _ = _segment_endpoints(pb, qb, sb[..., 1])
    closest = _closest_on_segment(b0, b1, pa)
    return _sphere_sphere(pa, qa, sa, closest, qb, sb, k)


def _capsule_capsule(pa, qa, sa, pb, qb, sb, k):
    """Closest-point contact, plus a second one when the capsules lie
    near-parallel side by side (ODE's dCollideCapsuleCapsule does the
    same)."""
    a0, a1, ax_a = _segment_endpoints(pa, qa, sa[..., 1])
    b0, b1, ax_b = _segment_endpoints(pb, qb, sb[..., 1])
    ca, cb = _segment_segment(a0, a1, b0, b1)
    p0, n0, d0, v0 = _sphere_sphere(ca, qa, sa, cb, qb, sb, 1)

    # parallel case: probe from the other end of capsule A's overlap range
    parallel = torch.abs(_dot(ax_a, ax_b)) > 0.999
    far = (torch.sum((ca - a0) ** 2, -1) > torch.sum((ca - a1) ** 2, -1))
    far_a = torch.where(far[..., None], a0, a1)
    cb2 = _closest_on_segment(b0, b1, far_a)
    ca2 = _closest_on_segment(a0, a1, cb2)
    p1, n1, d1, v1 = _sphere_sphere(ca2, qa, sa, cb2, qb, sb, 1)
    distinct = torch.sum((ca2 - ca) ** 2, -1) > 1e-8
    v1 = v1 & (parallel & distinct)[..., None]
    return _pad_manifold(torch.cat([p0, p1], -2), torch.cat([n0, n1], -2),
                         torch.cat([d0, d1], -1), torch.cat([v0, v1], -1), k)


def _capsule_plane(pa, qa, sa, pb, qb, sb, k):
    """Both cap spheres against the plane: up to 2 contacts."""
    n_p, d_p = _plane_params(pb, qb)
    a0, a1, _ = _segment_endpoints(pa, qa, sa[..., 1])
    r = sa[..., 0]
    pts, deps = [], []
    for e in (a0, a1):
        h = _dot(n_p, e) - d_p
        deps.append(r - h)
        pts.append(e - n_p * h[..., None])
    depths = torch.stack(deps, -1)
    return _pad_manifold(torch.stack(pts, -2),
                         (-n_p)[..., None, :].expand(n_p.shape[:-1] + (2, 3)),
                         depths, depths > 0.0, k)


def _capsule_box(pa, qa, sa, pb, qb, sb, k):
    """Capsule against a box: cap spheres at both endpoints and the segment
    point closest to the box centre (dropped when it is an endpoint)."""
    rb = quat_m.to_matrix(qb)
    half = 0.5 * sb
    r = sa[..., 0]
    a0, a1, _ = _segment_endpoints(pa, qa, sa[..., 1])
    mid = _closest_on_segment(a0, a1, pb)
    probes = [_sphere_box_core(probe, r, pb, rb, half)
              for probe in (a0, a1, mid)]
    pts = torch.stack([p[0] for p in probes], -2)
    nrms = torch.stack([p[1] for p in probes], -2)
    deps = torch.stack([p[2] for p in probes], -1)
    dup = (_norm(mid - a0) < 1e-6) | (_norm(mid - a1) < 1e-6)
    keep = torch.stack([torch.ones_like(dup), torch.ones_like(dup), ~dup], -1)
    return _pad_manifold(pts, nrms, deps, (deps > 0.0) & keep, k)


# ---------------------------------------------------------------------------
# Box-box: SAT + reference-face clipping (ODE dBoxBox structure)
# ---------------------------------------------------------------------------

# the four clip planes (a, b) of a rectangle: inside iff a·x + b·y <= limit
_CLIP_PLANES = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


def _clip_quad_to_rect(quad, hx, hy):
    """Exact Sutherland–Hodgman clip of 2-D quads (..., 4, 2) against
    |x| <= hx, |y| <= hy (ODE dBoxBox's face clipping): (verts (..., 8, 2),
    valid (..., 8)), at most 8 vertices kept in emission order.

    One plane at a time. Each vertex i < count emits itself if it is inside
    and the crossing point to vertex i+1 (i+1 wrapping to 0 at count) if
    the edge crosses the plane; what vertex i emits does not depend on
    what the others did, so all 8 are computed at once and the emitted
    points are compacted in order (cur_0, cross_0, cur_1, …) into 8 slots,
    unwritten slots zero, as the JAX scan writes them one by one.
    """
    cap = 8
    lead = quad.shape[:-2]
    verts = torch.cat([quad, torch.zeros(lead + (4, 2), dtype=quad.dtype,
                                         device=quad.device)], -2)
    count = torch.full(lead, 4, dtype=torch.int64, device=quad.device)
    i = torch.arange(cap, device=quad.device)
    for (a, b), lim in zip(_CLIP_PLANES, (hx, hx, hy, hy)):
        lim = lim[..., None]
        nxt_i = torch.where(i + 1 >= count[..., None], 0, i + 1)
        nxt = torch.gather(verts, -2,
                           nxt_i[..., None].expand(lead + (cap, 2)))
        x, y = verts[..., 0], verts[..., 1]
        d_cur = a * x + b * y
        in_cur = d_cur <= lim
        in_nxt = a * nxt[..., 0] + b * nxt[..., 1] <= lim
        live = i < count[..., None]
        diff = nxt - verts
        denom = a * diff[..., 0] + b * diff[..., 1]
        crosses = torch.abs(denom) > _EPS
        t = (lim - d_cur) / torch.where(crosses, denom, 1.0)
        # cur + t·(nxt − cur) rounded once (a fused multiply-add), as XLA
        # computes it: on a short edge a second rounding is amplified
        inter = torch.addcmul(verts, torch.clamp(t, 0.0, 1.0)[..., None]
                              .expand_as(diff), diff)
        emit = torch.stack([live & in_cur,
                            live & (in_cur != in_nxt) & crosses], -1)
        emit = emit.reshape(lead + (2 * cap,))
        cand = torch.stack([verts, inter], -2).reshape(lead + (2 * cap, 2))
        pos = torch.cumsum(emit.to(torch.int64), -1) - 1
        dest = torch.where(emit, torch.clamp_max(pos, cap), cap)
        out = torch.zeros(lead + (cap + 1, 2), dtype=quad.dtype,
                          device=quad.device)
        out.scatter_(-2, dest[..., None].expand(lead + (2 * cap, 2)), cand)
        verts = out[..., :cap, :]
        count = torch.clamp_max(torch.sum(emit, -1), cap)
    return verts, i < count[..., None]


def _face_candidates(quad2d, hx, hy):
    """Branch-free face-face manifold candidates in reference-face
    coordinates: the 4 incident-face corners clamped into the reference
    rectangle, and the 4 rectangle corners, valid when inside the incident
    quad. Returns (points (..., 8, 2), valid (..., 8))."""
    h = torch.stack([hx, hy], -1)[..., None, :]
    clamped = torch.minimum(torch.maximum(quad2d, -h), h)
    sx = graphs.constant((-1.0, 1.0, 1.0, -1.0), quad2d.dtype, quad2d.device)
    sy = graphs.constant((-1.0, -1.0, 1.0, 1.0), quad2d.dtype, quad2d.device)
    rect = torch.stack([sx * hx[..., None], sy * hy[..., None]], -1)

    # point in convex quad: one sign for every edge's cross product
    edges = torch.roll(quad2d, -1, dims=-2) - quad2d
    rel = rect[..., :, None, :] - quad2d[..., None, :, :]   # (..., 4, 4, 2)
    cross = (edges[..., None, :, 0] * rel[..., 1]
             - edges[..., None, :, 1] * rel[..., 0])
    inside = (torch.all(cross >= -1e-7, -1) | torch.all(cross <= 1e-7, -1))
    points = torch.cat([clamped, rect], -2)
    return points, torch.cat([torch.ones_like(inside), inside], -1)


def _box_box(pa, qa, sa, pb, qb, sb, k, exact_clip: bool = False):
    """SAT over 15 axes with ODE's axis order and 1.05 face-preference
    fudge, then reference-face clipping (face case) or the edge-edge
    closest point (edge case), the structure of ODE's dBoxBox."""
    dtype = pa.dtype
    ra = quat_m.to_matrix(qa)
    rb = quat_m.to_matrix(qb)
    ha = 0.5 * sa
    hb = 0.5 * sb

    t = _mtv(ra, pb - pa)                  # B centre in A frame
    c = _mtm(ra, rb)                       # B orientation in A frame
    absc = torch.abs(c) + 1e-6
    sep_a = torch.abs(t) - (ha + _mv(absc, hb))
    t_b = _mtv(c, t)
    sep_b = torch.abs(t_b) - (hb + _mtv(absc, ha))

    # edge axes u[i, j] = e_i × C[:, j] (A frame)
    eye = torch.eye(3, dtype=dtype, device=pa.device)
    cols = c.transpose(-1, -2)
    grid = cols.shape[:-2] + (3, 3, 3)
    u_all = torch.linalg.cross(eye[:, None, :].expand(grid),
                               cols[..., None, :, :].expand(grid), dim=-1)
    u_flat = u_all.reshape(u_all.shape[:-3] + (9, 3))
    norms = _norm(u_flat)
    edge_oks = norms > 1e-6
    edge_units = u_flat / torch.clamp_min(norms, _EPS)[..., None]
    proj_a = torch.sum(torch.abs(edge_units) * ha[..., None, :], -1)
    un_in_b = torch.sum(edge_units[..., :, :, None] * c[..., None, :, :], -2)
    proj_b = torch.sum(torch.abs(un_in_b) * hb[..., None, :], -1)
    edge_seps = (torch.abs(torch.sum(edge_units * t[..., None, :], -1))
                 - (proj_a + proj_b))

    separated = torch.amax(torch.cat(
        [sep_a, sep_b, torch.where(edge_oks, edge_seps, -torch.inf)], -1),
        -1) > 0.0

    # ODE's sequential axis choice: the larger separation wins; an edge
    # axis must beat the best face separation by the 1.05 fudge factor
    fudge = 1.05
    face_seps = torch.cat([sep_a, sep_b], -1)
    best_face_sep = torch.amax(face_seps, -1)
    best_face_code = torch.argmax(face_seps, -1)
    edge_adj = torch.where(
        edge_oks, edge_seps * torch.where(edge_seps < 0, 1.0 / fudge, fudge),
        -torch.inf)
    best_edge_idx = torch.argmax(edge_adj, -1)
    use_edge = _sel(edge_adj, best_edge_idx) > best_face_sep

    # --------------------------- edge-edge case ---------------------------
    u_a = _sel_row(edge_units, best_edge_idx)
    n_a = u_a * _sign(_dot(u_a, t))[..., None]       # A frame, A → B
    n_world_edge = _mv(ra, n_a)
    oh_ei = _onehot(best_edge_idx // 3, 3, dtype)     # edge direction on A
    oh_ej = _onehot(best_edge_idx % 3, 3, dtype)      # edge direction on B
    ha_ei = torch.sum(ha * oh_ei, -1)[..., None]
    hb_ej = torch.sum(hb * oh_ej, -1)[..., None]

    # supporting edge on A: corner most along +n_a, direction e_ei
    pa_sup = pa + _mv(ra, _sign(n_a) * (1.0 - oh_ei) * ha)
    da = _mv(ra, oh_ei)
    a0, a1 = pa_sup - da * ha_ei, pa_sup + da * ha_ei
    n_b_frame = -_mtv(c, n_a)                         # B → A in B frame
    pb_sup = pb + _mv(rb, _sign(n_b_frame) * (1.0 - oh_ej) * hb)
    db = _mv(rb, oh_ej)
    b0, b1 = pb_sup - db * hb_ej, pb_sup + db * hb_ej
    ca, cb = _segment_segment(a0, a1, b0, b1)
    edge_point = 0.5 * (ca + cb)
    edge_depth = -_sel(edge_seps, best_edge_idx)

    # --------------------------- face case --------------------------------
    # the reference box R owns the face, the incident box I meets it
    face_is_a = best_face_code < 3
    axis_idx = torch.where(face_is_a, best_face_code, best_face_code - 3)
    fa1, fa2 = face_is_a[..., None], face_is_a[..., None, None]
    r_ref, r_inc = torch.where(fa2, ra, rb), torch.where(fa2, rb, ra)
    p_ref, p_inc = torch.where(fa1, pa, pb), torch.where(fa1, pb, pa)
    h_ref, h_inc = torch.where(fa1, ha, hb), torch.where(fa1, hb, ha)

    # face normal of the reference box toward the incident box
    axes_ref = r_ref.transpose(-1, -2)                # rows: world axes
    n_ref_raw = _sel_row(axes_ref, axis_idx)
    sign_f = _sign(_dot(n_ref_raw, p_inc - p_ref))
    n_ref = n_ref_raw * sign_f[..., None]
    n_world_face = torch.where(fa1, n_ref, -n_ref)    # contact normal A → B

    # the reference face's in-plane basis: the other two axes
    idx0 = torch.where(axis_idx == 0, 1, 0)
    idx1 = torch.where(axis_idx == 2, 1, 2)
    u0, u1 = _sel_row(axes_ref, idx0), _sel_row(axes_ref, idx1)
    hu0, hu1 = _sel(h_ref, idx0), _sel(h_ref, idx1)
    face_center = p_ref + n_ref * _sel(h_ref, axis_idx)[..., None]

    # incident face: the incident axis most anti-parallel to n_ref
    axes_inc = r_inc.transpose(-1, -2)
    align = _mv(axes_inc, n_ref)
    inc_axis = torch.argmax(torch.abs(align), -1)
    inc_sign = -torch.sign(_sel(align, inc_axis))[..., None]
    inc_axis_vec = _sel_row(axes_inc, inc_axis)
    inc_center = (p_inc + inc_axis_vec * inc_sign
                  * _sel(h_inc, inc_axis)[..., None])
    j0 = torch.where(inc_axis == 0, 1, 0)
    j1 = torch.where(inc_axis == 2, 1, 2)
    v0 = _sel_row(axes_inc, j0) * _sel(h_inc, j0)[..., None]
    v1 = _sel_row(axes_inc, j1) * _sel(h_inc, j1)[..., None]
    quad_world = torch.stack([inc_center + v0 + v1, inc_center + v0 - v1,
                              inc_center - v0 - v1, inc_center - v0 + v1], -2)

    # the incident quad in reference-face plane coordinates
    rel = quad_world - face_center[..., None, :]
    quad2d = torch.stack([torch.sum(rel * u0[..., None, :], -1),
                          torch.sum(rel * u1[..., None, :], -1)], -1)
    if exact_clip:
        verts2d, cand_valid = _clip_quad_to_rect(quad2d, hu0, hu1)
    else:
        verts2d, cand_valid = _face_candidates(quad2d, hu0, hu1)

    # lift each candidate onto the incident face plane: its depth is how
    # far that point lies below the reference face
    inc_n = inc_axis_vec * inc_sign
    denom = _dot(inc_n, n_ref)
    d_inc = _dot(inc_n, inc_center)
    base = (face_center[..., None, :] + verts2d[..., 0:1] * u0[..., None, :]
            + verts2d[..., 1:2] * u1[..., None, :])
    z = ((d_inc[..., None] - torch.sum(base * inc_n[..., None, :], -1))
         / torch.where(torch.abs(denom) > 1e-6, denom, 1.0)[..., None])
    lifted = base + z[..., None] * n_ref[..., None, :]
    depths_face = -z
    valid_face = cand_valid & (depths_face > 0.0)
    # ODE places face contacts on the incident face, shifted halfway
    points_face = lifted - 0.5 * depths_face[..., None] * n_ref[..., None, :]

    # --------------------------- combine ----------------------------------
    ue1, ue2 = use_edge[..., None], use_edge[..., None, None]
    points = torch.where(ue2, edge_point[..., None, :], points_face)
    normals = torch.where(ue1, n_world_edge, n_world_face)[..., None, :]
    normals = normals.expand(points.shape)
    zeros7 = torch.zeros(edge_depth.shape + (7,), dtype=dtype,
                         device=pa.device)
    depths = torch.where(ue1, torch.cat([edge_depth[..., None], zeros7], -1),
                         depths_face)
    valid = torch.where(ue1, torch.cat([(edge_depth > 0.0)[..., None],
                                        zeros7 > 0.0], -1), valid_face)
    valid = valid & ~separated[..., None]

    if k == 4:
        return _fold_manifold(points, normals, depths, valid,
                              [4, 5, 6, 7])     # clamped corner i ↔ rect i
    if k < 8:
        return _topk_manifold(points, normals, depths, valid, k)
    return _pad_manifold(points, normals, depths, valid, k)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _flip(manifold):
    points, normals, depths, valid = manifold
    return points, -normals, depths, valid


def _box_capsule(pa, qa, sa, pb, qb, sb, k):
    return _flip(_capsule_box(pb, qb, sb, pa, qa, sa, k))


_SPHERE, _BOX = int(BodyType.SPHERE), int(BodyType.BOX)
_CAPSULE, _PLANE = int(BodyType.CAPSULE), int(BodyType.PLANE)

# (type_a, type_b) → kernel, canonical order type_a <= type_b
_PAIR_KERNELS = {
    (_SPHERE, _SPHERE): _sphere_sphere,
    (_SPHERE, _BOX): _sphere_box,
    (_SPHERE, _CAPSULE): _sphere_capsule,
    (_SPHERE, _PLANE): _sphere_plane,
    (_BOX, _BOX): _box_box,          # exact_clip chosen in _enabled_kernels
    (_BOX, _CAPSULE): _box_capsule,
    (_BOX, _PLANE): _box_plane,
    (_CAPSULE, _CAPSULE): _capsule_capsule,
    (_CAPSULE, _PLANE): _capsule_plane,
}

# slots each kernel can fill; the typed paths give each bucket
# min(this, K) rows per pair
_KERNEL_K = {
    (_SPHERE, _SPHERE): 1,
    (_SPHERE, _BOX): 1,
    (_SPHERE, _CAPSULE): 1,
    (_SPHERE, _PLANE): 1,
    (_BOX, _BOX): 8,
    (_BOX, _CAPSULE): 3,
    (_BOX, _PLANE): 8,
    (_CAPSULE, _CAPSULE): 2,
    (_CAPSULE, _PLANE): 2,
}


# the kernels that reduce their 8 slots to any k (fold or deepest k); every
# other kernel pads its _KERNEL_K slots to k
_REDUCED_TO_K = ((_BOX, _BOX), (_BOX, _PLANE))


def manifolds_fit(kernels, k: int) -> bool:
    """Whether every kernel of ``kernels`` gives its manifold at k slots:
    those of ``_REDUCED_TO_K`` at any k, every other one where its
    ``_KERNEL_K`` slots are at most k (else ``_pad_manifold`` raises)."""
    return all(pair in _REDUCED_TO_K or _KERNEL_K[pair] <= k
               for pair in kernels)


def _enabled_kernels(config: EngineConfig) -> dict:
    """The pair-kernel table in table order, less the capsule and plane
    pairs the config disables, with the exact-clip box-box kernel when
    ``exact_box_clip``."""
    out = {}
    for (t1, t2), kernel in _PAIR_KERNELS.items():
        if not config.enable_capsules and _CAPSULE in (t1, t2):
            continue
        if not config.enable_planes and _PLANE in (t1, t2):
            continue
        if kernel is _box_box and config.exact_box_clip:
            kernel = functools.partial(_box_box, exact_clip=True)
        out[(t1, t2)] = kernel
    return out


def collide_pair(pos_a, quat_a, type_a, size_a, pos_b, quat_b, type_b,
                 size_b, k: int, kernels=None):
    """Contact manifolds of body pairs over any leading axes: (points
    (..., k, 3), normals (..., k, 3), depths (..., k), valid (..., k)).

    The lower type code becomes side A (normals flip back when swapped);
    every kernel of ``kernels`` (default: all) runs and the pair's type
    selects its result.
    """
    swap = type_a > type_b
    s1 = swap[..., None]
    pa, pb = torch.where(s1, pos_b, pos_a), torch.where(s1, pos_a, pos_b)
    qa, qb = torch.where(s1, quat_b, quat_a), torch.where(s1, quat_a, quat_b)
    sa, sb = torch.where(s1, size_b, size_a), torch.where(s1, size_a, size_b)
    ta, tb = torch.where(swap, type_b, type_a), torch.where(swap, type_a,
                                                            type_b)
    lead = pos_a.shape[:-1]
    points = torch.zeros(lead + (k, 3), dtype=pos_a.dtype,
                         device=pos_a.device)
    normals = torch.zeros_like(points)
    depths = torch.zeros(lead + (k,), dtype=pos_a.dtype, device=pos_a.device)
    valid = torch.zeros(lead + (k,), dtype=torch.bool, device=pos_a.device)
    if kernels is None:
        kernels = _PAIR_KERNELS
    for (t1, t2), kernel in kernels.items():
        sel = (ta == t1) & (tb == t2)
        p, n, d, v = kernel(pa, qa, sa, pb, qb, sb, k)
        s1, s2 = sel[..., None], sel[..., None, None]
        points = torch.where(s2, p, points)
        normals = torch.where(s2, n, normals)
        depths = torch.where(s1, d, depths)
        valid = torch.where(s1, v, valid)
    # normals point from the original a toward b
    normals = torch.where(swap[..., None, None], -normals, normals)
    return points, normals, depths, valid


def _gather_rows(table, idx):
    """(B, N, F) rows at (B, P) indices → (B, P, F)."""
    idx = idx.to(torch.int64)[..., None].expand(idx.shape + table.shape[-1:])
    return torch.gather(table, 1, idx)


def _collide_rows(fa, fb, k, kernels):
    """``collide_pair`` on (…, 11) feature rows of both sides."""
    return collide_pair(fa[..., 0:3], fa[..., 3:7], fa[..., 10].to(torch.int32),
                        fa[..., 7:10], fb[..., 0:3], fb[..., 3:7],
                        fb[..., 10].to(torch.int32), fb[..., 7:10], k,
                        kernels)
