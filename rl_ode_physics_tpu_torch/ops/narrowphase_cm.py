"""Component-major typed-bucket narrowphase.

The port of ``rl_ode_physics_tpu/ops/narrowphase_cm.py`` for the sphere and
box buckets (``:53-198``, ``:327-630``, ``:779-1014``). A "vec" is a tuple
``(x, y, z)`` of same-shape tensors; here every plane is ``(B, P)``: worlds
by pairs. The pair kernels are the JAX package's formulas written in the
same order, so on the CPU they agree with it to the last bit wherever the
two libraries' elementwise operations do.

The pipeline per substep: pair eligibility, one compacted candidate list
per pair type, the type's pair kernel at its manifold size (box-box folds
8 slots to 4), slot-major emission into a ``(B, 10, M)`` payload, and the
contact compaction into ``(B, 10, C)`` rows. On a CUDA tensor the
compaction is the hand-written kernel (``ops/compaction_kernel.py``),
whatever ``pallas_compaction`` says; on a CPU tensor it is its plain
version (``ops/compaction.py``).
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, jnp_dtype_is_bf16
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel
from rl_ode_physics_tpu_torch.ops.narrowphase import (
    Contacts, _KERNEL_K, _enabled_kernels, _pair_eligibility)

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Component-plane helpers
# ---------------------------------------------------------------------------

def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vmul(a, b):
    """Elementwise (Hadamard) product of two vecs."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vnormsq(a):
    return vdot(a, a)


def vnorm(a):
    return torch.sqrt(vnormsq(a))


def vwhere(c, a, b):
    return (torch.where(c, a[0], b[0]),
            torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def quat_cols(qw, qx, qy, qz):
    """Rotation-matrix columns (world images of the body axes) from unit
    quaternion components: the matrix of ``utils.quat.to_matrix``."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    c0 = (1.0 - 2.0 * (yy + zz), 2.0 * (xy + wz), 2.0 * (xz - wy))
    c1 = (2.0 * (xy - wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz + wx))
    c2 = (2.0 * (xz + wy), 2.0 * (yz - wx), 1.0 - 2.0 * (xx + yy))
    return c0, c1, c2


def rot_apply(cols, v):
    """R @ v (body → world): v0·c0 + v1·c1 + v2·c2."""
    c0, c1, c2 = cols
    return vadd(vadd(vscale(c0, v[0]), vscale(c1, v[1])), vscale(c2, v[2]))


def rot_apply_t(cols, v):
    """R.T @ v (world → body): (c0·v, c1·v, c2·v)."""
    c0, c1, c2 = cols
    return (vdot(c0, v), vdot(c1, v), vdot(c2, v))


def _sgn(v):
    return torch.where(v >= 0.0, 1.0, -1.0)


# ---------------------------------------------------------------------------
# Pair kernels: pa/pb vecs, qa/qb 4-tuples, sa/sb vecs of planes in; a list
# of manifold slots (point vec, normal vec a→b, depth, valid) out.
# ---------------------------------------------------------------------------

def _up_vec(x):
    z = torch.zeros_like(x)
    return (z, torch.ones_like(x), z)


def cm_sphere_sphere(pa, qa, sa, pb, qb, sb):
    ra, rb = sa[0], sb[0]
    d = vsub(pb, pa)
    dist = vnorm(d)
    inv = 1.0 / torch.clamp_min(dist, _EPS)
    n = vwhere(dist > _EPS, vscale(d, inv), _up_vec(dist))
    depth = ra + rb - dist
    point = vadd(pa, vscale(n, ra - 0.5 * depth))
    return [(point, n, depth, depth > 0.0)]


def _argmin3(f0, f1, f2):
    """First-minimum masks over three planes (ties → lowest index)."""
    is0 = (f0 <= f1) & (f0 <= f2)
    is1 = ~is0 & (f1 <= f2)
    is2 = ~is0 & ~is1
    return is0, is1, is2


def cm_sphere_box_core(center, radius, pb, cols_b, half):
    """Sphere against an oriented box: (point, normal a→b, depth)."""
    p_local = rot_apply_t(cols_b, vsub(center, pb))
    clamped = (torch.clamp(p_local[0], -half[0], half[0]),
               torch.clamp(p_local[1], -half[1], half[1]),
               torch.clamp(p_local[2], -half[2], half[2]))
    delta = vsub(p_local, clamped)
    dist = vnorm(delta)
    outside = dist > _EPS

    inv = 1.0 / torch.clamp_min(dist, _EPS)
    n_local_out = vscale(delta, -inv)
    depth_out = radius - dist

    fd = (half[0] - torch.abs(p_local[0]),
          half[1] - torch.abs(p_local[1]),
          half[2] - torch.abs(p_local[2]))
    is0, is1, is2 = _argmin3(*fd)
    dt = p_local[0].dtype
    f0, f1, f2 = is0.to(dt), is1.to(dt), is2.to(dt)
    p_ax = p_local[0] * f0 + p_local[1] * f1 + p_local[2] * f2
    fd_ax = fd[0] * f0 + fd[1] * f1 + fd[2] * f2
    sign = _sgn(p_ax)
    n_local_in = (f0 * sign, f1 * sign, f2 * sign)
    depth_in = radius + fd_ax

    n_local = vwhere(outside, n_local_out, n_local_in)
    depth = torch.where(outside, depth_out, depth_in)
    surf_local = vwhere(outside, clamped,
                        vadd(p_local, vscale(n_local_in, fd_ax)))
    point = vadd(pb, rot_apply(cols_b, surf_local))
    n_world = rot_apply(cols_b, n_local)
    return point, n_world, depth


def cm_sphere_box(pa, qa, sa, pb, qb, sb):
    cols_b = quat_cols(*qb)
    half = vscale(sb, 0.5)
    point, n, depth = cm_sphere_box_core(pa, sa[0], pb, cols_b, half)
    return [(point, n, depth, depth > 0.0)]


def _segment_segment(p0, p1, q0, q1):
    """Branch-free closest points of two segments."""
    d1 = vsub(p1, p0)
    d2 = vsub(q1, q0)
    r = vsub(p0, q0)
    a = vdot(d1, d1)
    e = vdot(d2, d2)
    f = vdot(d2, r)
    c = vdot(d1, r)
    b = vdot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > _EPS,
                    torch.clamp((b * f - c * e) / torch.clamp_min(denom, _EPS),
                                0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp_min(e, _EPS)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp_min(a, _EPS), 0.0, 1.0)
    return vadd(p0, vscale(d1, s)), vadd(q0, vscale(d2, t_cl))


def cm_box_box(pa, qa, sa, pb, qb, sb):
    """SAT over 15 axes with ODE's sequential first-max axis choice and 1.05
    face-preference fudge, then the branch-free 8-candidate manifold: 4
    clamped incident corners and 4 reference-rectangle corners (face case)
    or one edge-edge point."""
    f = pa[0].dtype
    cols_a = quat_cols(*qa)
    cols_b = quat_cols(*qb)
    ha = vscale(sa, 0.5)
    hb = vscale(sb, 0.5)

    t_world = vsub(pb, pa)
    t = rot_apply_t(cols_a, t_world)            # B center in A frame
    # c[i][j] = A_i · B_j (B orientation in A frame)
    c = [[vdot(cols_a[i], cols_b[j]) for j in range(3)] for i in range(3)]
    absc = [[torch.abs(c[i][j]) + 1e-6 for j in range(3)] for i in range(3)]

    sep_a = [torch.abs(t[i]) - (ha[i] + absc[i][0] * hb[0]
                                + absc[i][1] * hb[1] + absc[i][2] * hb[2])
             for i in range(3)]
    t_b = [c[0][j] * t[0] + c[1][j] * t[1] + c[2][j] * t[2]
           for j in range(3)]
    sep_b = [torch.abs(t_b[j]) - (hb[j] + absc[0][j] * ha[0]
                                  + absc[1][j] * ha[1] + absc[2][j] * ha[2])
             for j in range(3)]

    # --- edge axes u = e_i × C_col_j (A frame), 9 static combos ----------
    def e_cross(i, col):
        if i == 0:
            return (torch.zeros_like(col[0]), -col[2], col[1])
        if i == 1:
            return (col[2], torch.zeros_like(col[0]), -col[0])
        return (-col[1], col[0], torch.zeros_like(col[0]))

    neg_inf = torch.tensor(-torch.inf, dtype=f, device=pa[0].device)
    fudge = 1.05

    max_all = None
    best_face_sep, best_face_code = None, None
    # edge tracking: adjusted sep (selection), raw sep (depth), unit axis,
    # one-hot masks of (i, j)
    be_adj = be_raw = None
    be_unit = None
    be_i = [None] * 3
    be_j = [None] * 3

    for j in range(3):
        col = (c[0][j], c[1][j], c[2][j])
        for i in range(3):
            u = e_cross(i, col)
            norm = vnorm(u)
            ok = norm > 1e-6
            inv = 1.0 / torch.clamp_min(norm, _EPS)
            unit = vscale(u, inv)
            proj_a = (torch.abs(unit[0]) * ha[0] + torch.abs(unit[1]) * ha[1]
                      + torch.abs(unit[2]) * ha[2])
            # |unit expressed in B| · hb
            proj_b = sum(
                torch.abs(c[0][jj] * unit[0] + c[1][jj] * unit[1]
                          + c[2][jj] * unit[2]) * hb[jj]
                for jj in range(3))
            sep = torch.abs(vdot(unit, t)) - (proj_a + proj_b)
            sep_m = torch.where(ok, sep, neg_inf)
            max_all = (sep_m if max_all is None
                       else torch.maximum(max_all, sep_m))
            adj = torch.where(
                ok, sep * torch.where(sep < 0, 1.0 / fudge, fudge), neg_inf)
            if be_adj is None:
                be_adj, be_raw, be_unit = adj, sep, unit
                for k in range(3):
                    be_i[k] = torch.full_like(adj, 1.0 if k == i else 0.0)
                    be_j[k] = torch.full_like(adj, 1.0 if k == j else 0.0)
            else:
                take = adj > be_adj                  # strict >: first max
                be_adj = torch.where(take, adj, be_adj)
                be_raw = torch.where(take, sep, be_raw)
                be_unit = vwhere(take, unit, be_unit)
                for k in range(3):
                    be_i[k] = torch.where(take, 1.0 if k == i else 0.0,
                                          be_i[k])
                    be_j[k] = torch.where(take, 1.0 if k == j else 0.0,
                                          be_j[k])

    face_seps = sep_a + sep_b                        # codes 0..5
    for code, s in enumerate(face_seps):
        max_all = torch.maximum(max_all, s)
        if code == 0:
            best_face_sep = s
            best_face_code = torch.zeros_like(s, dtype=torch.int32)
        else:
            take = s > best_face_sep                 # strict >: first max
            best_face_sep = torch.where(take, s, best_face_sep)
            best_face_code = torch.where(take, code, best_face_code)
    separated = max_all > 0.0
    use_edge = be_adj > best_face_sep

    # --------------------------- edge-edge case ---------------------------
    sign_e = torch.where(vdot(be_unit, t) >= 0.0, 1.0, 0.0) * 2.0 - 1.0
    n_a = vscale(be_unit, sign_e)                    # A frame, a→b
    n_world_edge = rot_apply(cols_a, n_a)
    oh_ei = tuple(be_i)
    oh_ej = tuple(be_j)
    ha_ei = ha[0] * oh_ei[0] + ha[1] * oh_ei[1] + ha[2] * oh_ei[2]
    hb_ej = hb[0] * oh_ej[0] + hb[1] * oh_ej[1] + hb[2] * oh_ej[2]

    sgn_a = (_sgn(n_a[0]) * (1.0 - oh_ei[0]),
             _sgn(n_a[1]) * (1.0 - oh_ei[1]),
             _sgn(n_a[2]) * (1.0 - oh_ei[2]))
    pa_sup = vadd(pa, rot_apply(cols_a, vmul(sgn_a, ha)))
    da = rot_apply(cols_a, oh_ei)
    a0 = vsub(pa_sup, vscale(da, ha_ei))
    a1 = vadd(pa_sup, vscale(da, ha_ei))

    # -C.T @ n_a (B frame, b→a)
    n_bf = tuple(-(c[0][j] * n_a[0] + c[1][j] * n_a[1] + c[2][j] * n_a[2])
                 for j in range(3))
    sgn_b = (_sgn(n_bf[0]) * (1.0 - oh_ej[0]),
             _sgn(n_bf[1]) * (1.0 - oh_ej[1]),
             _sgn(n_bf[2]) * (1.0 - oh_ej[2]))
    pb_sup = vadd(pb, rot_apply(cols_b, vmul(sgn_b, hb)))
    db = rot_apply(cols_b, oh_ej)
    b0 = vsub(pb_sup, vscale(db, hb_ej))
    b1 = vadd(pb_sup, vscale(db, hb_ej))

    ca, cb = _segment_segment(a0, a1, b0, b1)
    edge_point = vscale(vadd(ca, cb), 0.5)
    edge_depth = -be_raw

    # --------------------------- face case --------------------------------
    face_is_a = best_face_code < 3
    # axis one-hots: ax_k = (code == k) | (code == k + 3)
    axf = [((best_face_code == k) | (best_face_code == k + 3)).to(f)
           for k in range(3)]

    ref_cols = tuple(vwhere(face_is_a, cols_a[k], cols_b[k])
                     for k in range(3))
    inc_cols = tuple(vwhere(face_is_a, cols_b[k], cols_a[k])
                     for k in range(3))
    p_ref = vwhere(face_is_a, pa, pb)
    p_inc = vwhere(face_is_a, pb, pa)
    h_ref = vwhere(face_is_a, ha, hb)
    h_inc = vwhere(face_is_a, hb, ha)

    def sel3(cols, m):
        return vadd(vadd(vscale(cols[0], m[0]), vscale(cols[1], m[1])),
                    vscale(cols[2], m[2]))

    n_ref_raw = sel3(ref_cols, axf)
    to_inc = vsub(p_inc, p_ref)
    sign_f = _sgn(vdot(n_ref_raw, to_inc))
    n_ref = vscale(n_ref_raw, sign_f)
    n_world_face = vwhere(face_is_a, n_ref, vneg(n_ref))

    ax0 = axf[0] > 0.5
    ax2 = axf[2] > 0.5
    u0 = vwhere(ax0, ref_cols[1], ref_cols[0])       # idx0 = ax==0 ? 1 : 0
    u1 = vwhere(ax2, ref_cols[1], ref_cols[2])       # idx1 = ax==2 ? 1 : 2
    hu0 = torch.where(ax0, h_ref[1], h_ref[0])
    hu1 = torch.where(ax2, h_ref[1], h_ref[2])
    h_ax = h_ref[0] * axf[0] + h_ref[1] * axf[1] + h_ref[2] * axf[2]
    face_center = vadd(p_ref, vscale(n_ref, h_ax))

    # incident face: incident axis most anti-parallel to n_ref (first max
    # of |align|)
    align = [vdot(inc_cols[k], n_ref) for k in range(3)]
    best_al = torch.abs(align[0])
    inc_m = [torch.ones_like(best_al), torch.zeros_like(best_al),
             torch.zeros_like(best_al)]
    align_inc = align[0]
    for k in (1, 2):
        take = torch.abs(align[k]) > best_al
        best_al = torch.where(take, torch.abs(align[k]), best_al)
        align_inc = torch.where(take, align[k], align_inc)
        for kk in range(3):
            inc_m[kk] = torch.where(take, 1.0 if kk == k else 0.0, inc_m[kk])
    inc_axis_vec = sel3(inc_cols, inc_m)
    h_inc_ax = h_inc[0] * inc_m[0] + h_inc[1] * inc_m[1] + h_inc[2] * inc_m[2]
    inc_sign = -torch.sign(align_inc)
    inc_center = vadd(p_inc, vscale(inc_axis_vec, inc_sign * h_inc_ax))
    i0 = inc_m[0] > 0.5
    i2 = inc_m[2] > 0.5
    v0 = vscale(vwhere(i0, inc_cols[1], inc_cols[0]),
                torch.where(i0, h_inc[1], h_inc[0]))
    v1 = vscale(vwhere(i2, inc_cols[1], inc_cols[2]),
                torch.where(i2, h_inc[1], h_inc[2]))

    # incident quad corners, projected to reference-face plane coordinates
    quad2d = []
    for (s0, s1) in ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)):
        qc = vadd(inc_center, vadd(vscale(v0, s0), vscale(v1, s1)))
        rel = vsub(qc, face_center)
        quad2d.append((vdot(rel, u0), vdot(rel, u1)))

    # 4 clamped incident corners + 4 reference-rect corners (valid when
    # inside the incident quad)
    cand = []
    for (qx, qy) in quad2d:
        cand.append((torch.clamp(qx, -hu0, hu0), torch.clamp(qy, -hu1, hu1),
                     torch.ones_like(qx, dtype=torch.bool)))
    rect_signs = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))
    for (sx, sy) in rect_signs:
        rx, ry = sx * hu0, sy * hu1
        all_pos = None
        all_neg = None
        for e in range(4):
            x0, y0 = quad2d[e]
            x1, y1 = quad2d[(e + 1) % 4]
            cross = (x1 - x0) * (ry - y0) - (y1 - y0) * (rx - x0)
            pos_e = cross >= -1e-7
            neg_e = cross <= 1e-7
            all_pos = pos_e if all_pos is None else (all_pos & pos_e)
            all_neg = neg_e if all_neg is None else (all_neg & neg_e)
        cand.append((rx, ry, all_pos | all_neg))

    inc_n = vscale(inc_axis_vec, inc_sign)
    denom = vdot(inc_n, n_ref)
    safe_denom = torch.where(torch.abs(denom) > 1e-6, denom, 1.0)
    d_inc = vdot(inc_n, inc_center)

    slots = []
    for si, (cx, cy, cv) in enumerate(cand):
        base = vadd(face_center, vadd(vscale(u0, cx), vscale(u1, cy)))
        z = (d_inc - vdot(base, inc_n)) / safe_denom
        lifted = vadd(base, vscale(n_ref, z))
        depth_f = -z
        valid_f = cv & (depth_f > 0.0)
        point_f = vsub(lifted, vscale(n_ref, 0.5 * depth_f))
        if si == 0:
            point = vwhere(use_edge, edge_point, point_f)
            depth = torch.where(use_edge, edge_depth, depth_f)
            valid = torch.where(use_edge, edge_depth > 0.0, valid_f)
        else:
            point = point_f
            depth = torch.where(use_edge, torch.zeros_like(depth_f), depth_f)
            valid = valid_f & ~use_edge
        normal = vwhere(use_edge, n_world_edge, n_world_face)
        slots.append((point, normal, depth, valid & ~separated))
    return slots


# ---------------------------------------------------------------------------
# Kernel table + manifold folding
# ---------------------------------------------------------------------------

_SPHERE, _BOX = int(BodyType.SPHERE), int(BodyType.BOX)

_CM_KERNELS = {
    (_SPHERE, _SPHERE): cm_sphere_sphere,
    (_SPHERE, _BOX): cm_sphere_box,
    (_BOX, _BOX): cm_box_box,
}

# 8-slot manifolds fold to 4 with these pairings
_FOLD_PAIRING = {
    (_BOX, _BOX): [4, 5, 6, 7],
}


def _fold_slots(slots, pairing):
    """8 slots → 4 by keep-the-better merge: prefer valid; among equal
    validity prefer deeper."""
    out = []
    for lo in range(4):
        p_lo, n_lo, d_lo, v_lo = slots[lo]
        p_hi, n_hi, d_hi, v_hi = slots[pairing[lo]]
        take_hi = (v_hi & ~v_lo) | (v_hi & v_lo & (d_hi > d_lo))
        out.append((vwhere(take_hi, p_hi, p_lo),
                    vwhere(take_hi, n_hi, n_lo),
                    torch.where(take_hi, d_hi, d_lo),
                    torch.where(take_hi, v_hi, v_lo)))
    return out


def supports_cm(config: EngineConfig) -> bool:
    """True when every enabled typed bucket has a component-major kernel at
    its configured manifold size."""
    if config.exact_box_clip:
        return False
    k_glob = config.max_contacts_per_pair
    for pair in _enabled_kernels(config):
        intrinsic = _KERNEL_K[pair]
        k_b = min(intrinsic, k_glob)
        if k_b == intrinsic:
            continue
        if intrinsic == 8 and k_b == 4 and pair in _FOLD_PAIRING:
            continue
        return False
    return True


# ---------------------------------------------------------------------------
# The component-major typed-bucket narrowphase
# ---------------------------------------------------------------------------

def _bucket_pairs(mask: torch.Tensor, cap: int):
    """The first ``cap`` set entries of each world's (N, N) pair mask in
    row-major order, as (ia, ib, bvalid, total): the pairs the JAX package's
    closed-form bucket compaction selects, found by a rank-scatter of the
    flat pair index."""
    b, n, _ = mask.shape
    flat = mask.reshape(b, n * n)
    csum = torch.cumsum(flat.to(torch.int32), dim=1, dtype=torch.int32)
    total = csum[:, -1]
    dest = torch.where(flat & (csum <= cap), csum - 1, cap).to(torch.int64)
    src = torch.arange(n * n, device=mask.device).expand(b, n * n)
    idx = torch.zeros((b, cap + 1), dtype=torch.int64, device=mask.device)
    idx.scatter_(1, dest, src)
    idx = idx[:, :cap]
    bvalid = (torch.arange(cap, device=mask.device)[None, :]
              < torch.clamp_max(total, cap)[:, None])
    ia = torch.where(bvalid, idx // n, 0)
    ib = torch.where(bvalid, idx % n, 0)
    return ia, ib, bvalid, total


def _gather_cols(feats_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, F, N) feature columns at (B, P) slot ids → (B, F, P)."""
    f = feats_t.shape[1]
    return torch.gather(feats_t, 2,
                        idx[:, None, :].expand(-1, f, -1))


def narrowphase_typed_cm(state: WorldState, config: EngineConfig,
                         extra=None, exclude=None):
    """Contacts of every world, and the number of pairs tested per world.

    The port runs the dense pair phase only (``sap_window=0``) and takes no
    mesh rows (``extra``) and no joint exclusions (``exclude``).
    """
    if config.sap_window:
        raise NotImplementedError("sap_window is not ported (dense pairs only)")
    if extra is not None:
        raise NotImplementedError("mesh contact rows (extra) are not ported")
    if exclude is not None:
        raise NotImplementedError("joint pair exclusion is not ported")
    if not supports_cm(config):
        raise NotImplementedError(
            "this config needs the row-major narrowphase, which is not ported")

    n = state.num_slots
    nw = state.num_worlds
    dev = state.device
    ccap = config.max_contacts
    k_glob = config.max_contacts_per_pair
    f = state.pos.dtype

    if n * n * k_glob >= 2 ** 24:
        raise ValueError(
            f"contact-key space {n * n * k_glob} (max_bodies={n}, "
            f"K={k_glob}) exceeds the f32 exact-integer range 2^24")
    sel_bf16 = jnp_dtype_is_bf16(config.selector_dtype)
    if not sel_bf16 and config.selector_dtype != "float32":
        raise NotImplementedError(
            f"selector_dtype={config.selector_dtype!r}: the port takes "
            f"float32 or bfloat16")
    if sel_bf16 and n > 256:
        raise ValueError("selector_dtype='bfloat16' requires max_bodies <= 256")

    # component-major feature table (B, 12, N): pos ‖ quat ‖ size ‖ type ‖
    # slot id. With bf16 selectors the JAX package rounds it to bf16 before
    # its one-hot gather matmuls; the gathers by index here are exact, so
    # the rounding is the whole difference, reproduced explicitly.
    cols = torch.arange(n, device=dev, dtype=f).expand(nw, n)
    feats_t = torch.cat([
        state.pos.transpose(1, 2), state.quat.transpose(1, 2),
        state.size.transpose(1, 2),
        state.body_type.to(f)[:, None, :], cols[:, None, :],
    ], dim=1)
    if sel_bf16:
        feats_t = compaction.round_to(feats_t, torch.bfloat16)

    hit, tmin, tmax = _pair_eligibility(state)

    row_parts = [[] for _ in range(10)]   # px py pz nx ny nz depth a b slot
    valid_parts = []
    total_pairs = torch.zeros((nw,), dtype=torch.int32, device=dev)
    pair_overflow = torch.zeros((nw,), dtype=torch.int32, device=dev)
    for (t1, t2) in _enabled_kernels(config):
        kernel = _CM_KERNELS[(t1, t2)]
        cp_b = config.bucket_capacity(t1, t2)
        k_b = min(_KERNEL_K[(t1, t2)], k_glob)
        mask = hit & (tmin == t1) & (tmax == t2)
        ia, ib, bvalid, total = _bucket_pairs(mask, cp_b)
        total_pairs = total_pairs + torch.clamp_max(total, cp_b)
        pair_overflow = pair_overflow + torch.clamp_min(total - cp_b, 0)
        fa = _gather_cols(feats_t, ia)               # (B, 12, cp_b)
        fb = _gather_cols(feats_t, ib)

        pa_r = (fa[:, 0], fa[:, 1], fa[:, 2])
        qa_r = (fa[:, 3], fa[:, 4], fa[:, 5], fa[:, 6])
        sa_r = (fa[:, 7], fa[:, 8], fa[:, 9])
        pb_r = (fb[:, 0], fb[:, 1], fb[:, 2])
        qb_r = (fb[:, 3], fb[:, 4], fb[:, 5], fb[:, 6])
        sb_r = (fb[:, 7], fb[:, 8], fb[:, 9])
        if t1 != t2:
            # canonicalize: the kernel's A side is the lower type code; fa
            # is the lower-slot body, whose type varies per pair. Normals
            # flip back below so they always point ia → ib.
            sw = fa[:, 10] != float(t1)
            pa_k = vwhere(sw, pb_r, pa_r)
            pb_k = vwhere(sw, pa_r, pb_r)
            qa_k = tuple(torch.where(sw, b_, a_) for a_, b_ in zip(qa_r, qb_r))
            qb_k = tuple(torch.where(sw, a_, b_) for a_, b_ in zip(qa_r, qb_r))
            sa_k = vwhere(sw, sb_r, sa_r)
            sb_k = vwhere(sw, sa_r, sb_r)
        else:
            sw = None
            pa_k, qa_k, sa_k = pa_r, qa_r, sa_r
            pb_k, qb_k, sb_k = pb_r, qb_r, sb_r

        slots = kernel(pa_k, qa_k, sa_k, pb_k, qb_k, sb_k)
        if sw is not None:
            slots = [(p, vwhere(sw, vneg(nrm), nrm), d, v)
                     for (p, nrm, d, v) in slots]
        if len(slots) == 8 and k_b == 4:
            slots = _fold_slots(slots, _FOLD_PAIRING[(t1, t2)])
        assert len(slots) == k_b, (t1, t2, len(slots), k_b)

        ia_f = ia.to(f)
        ib_f = ib.to(f)
        # slot-major emission: slot s of every pair is contiguous
        for s, (point, normal, depth, valid) in enumerate(slots):
            for comp in range(3):
                row_parts[comp].append(point[comp])
                row_parts[3 + comp].append(normal[comp])
            row_parts[6].append(depth)
            row_parts[7].append(ia_f)
            row_parts[8].append(ib_f)
            row_parts[9].append(torch.full_like(depth, float(s)))
            valid_parts.append(valid & bvalid)

    packed_t = torch.stack([torch.cat(parts, dim=1) for parts in row_parts],
                           dim=1)                             # (B, 10, M)
    flat_valid = torch.cat(valid_parts, dim=1)                # (B, M)

    c_sel = torch.bfloat16 if sel_bf16 else None
    rows_t, cvalid, count, overflow = compaction_kernel.compact_rows_t(
        flat_valid, packed_t, ccap, sel_dtype=c_sel)
    a_out = rows_t[:, 7].to(torch.int32)
    b_out = rows_t[:, 8].to(torch.int32)
    slot_out = torch.round(rows_t[:, 9]).to(torch.int32)
    key = torch.where(cvalid & (slot_out >= 0),
                      (a_out * n + b_out) * k_glob + slot_out, -1)
    return Contacts(
        point=rows_t[:, 0:3].transpose(1, 2).contiguous(),
        normal=rows_t[:, 3:6].transpose(1, 2).contiguous(),
        depth=rows_t[:, 6].contiguous(),
        a=a_out,
        b=b_out,
        valid=cvalid,
        count=count,
        overflow=overflow + pair_overflow,
        key=key,
    ), total_pairs
