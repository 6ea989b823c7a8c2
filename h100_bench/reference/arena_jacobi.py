"""Plain reference of the ``arena64-hb8`` configuration: the throughput
policy's substep written world by world and pair by pair, in float32.

It is written from the semantics the configuration states, not from the
program's code: scalar NumPy ``float32`` arithmetic, one pair at a time
with plain branches, and a Jacobi loop over each world's contact rows
with index gathers and scatter-adds (the program runs component-major
tensor code over the whole batch, with one-hot selector products). A
substep:

* broadphase: all pairs i < j, AABB overlap on the state as it is (the
  |R|·h box of each slot), ODE's category/collide filter, both slots
  active, at least one with mass;
* typed buckets in table order (sphere-sphere, sphere-box, box-box), each
  the first ``cap`` pairs in row-major (i, j) order; the pairs past the
  cap are dropped and counted in ``overflow``;
* the pair kernels read each body's position, quaternion and size rounded
  to bfloat16 (``selector_dtype``): sphere-sphere and sphere-box one
  contact, the sphere as side a; box-box ODE's 15-axis SAT (first maximum,
  the 1.05 face fudge) and then either the edge-edge point or the face
  manifold of 4 clamped incident corners and 4 reference-rectangle
  corners, kept to K = 4 by pairing candidate k with candidate k + 4 and
  keeping the valid one, or the deeper of two valid ones;
* rows emitted bucket by bucket, each bucket slot by slot, each slot pair
  by pair; the first ``max_contacts`` valid rows are kept (the rest are
  dropped and counted), with point, normal and depth rounded to bfloat16;
* gravity and ODE's gyroscopic term; heavy-ball projected Jacobi, cold
  started, ``solver_iterations`` sweeps with ``jacobi_omega`` and
  ``jacobi_beta``, each row's effective mass split by the larger contact
  count of its two bodies, CFM, ERP bias and bounce above ``bounce_vel``,
  infinite friction;
* semi-implicit Euler, the quaternion by ODE's infinitesimal update.

Rounding to bfloat16 makes the substep a step function of its inputs.
The first substep of a call starts from the program's own state, so both
sides round the same numbers; the later substeps start from states that
differ in the last float32 bits (the solver's sums run in another
order), and a position or quaternion component within ``TIE_ULPS``
float32 steps of a bfloat16 tie may round either way. Both roundings
are the configuration's answer there: the reference takes each (at most
``MAX_BRANCHES`` a world-call) and judges the program against the
nearest. Components far below 1 can differ by more steps (cancellation)
but move a contact by less than a micrometre when they round the other
way.

It runs on the sampled worlds alone, from the state the program held
before the sampled call, and judges the program's state after the call.
``precision="tf32"`` rounds every gathered and scattered operand of the
solver's body-row products to TF32: the control.

Numbers (each the largest over the sampled world-calls and every dynamic
body, velocities in m/s and rad/s, poses in m and quaternion units):

* ``vel_gap``: the largest |dv| or |dw|;
* ``pose_gap``: the largest |dx| or |dq|;
* ``overflow_gap``: the largest difference of the dropped-row counters.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

F = np.float32
ZERO, ONE, TWO, HALF = F(0.0), F(1.0), F(2.0), F(0.5)
EPS = F(1e-9)
NULL, SPHERE, BOX, CAPSULE, PLANE, TRIMESH = 0, 1, 2, 3, 4, 5
BUCKETS = ((SPHERE, SPHERE), (SPHERE, BOX), (BOX, BOX))
FIELDS = ("pos", "quat", "linvel", "angvel")
# a pose component this many float32 steps from a bfloat16 tie rounds
# either way in a call's later substeps
TIE_ULPS = 16
MAX_BRANCHES = 16


# --- rounding ------------------------------------------------------------

def bf16(x):
    """float32 → bfloat16 (round to nearest, ties to even) → float32."""
    a = np.asarray(x, F)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(F).reshape(a.shape)


def bf16_other(x):
    """For each float32 value within ``TIE_ULPS`` float32 steps of a
    bfloat16 tie, the bfloat16 value on the tie's other side; NaN where
    the value is not near a tie."""
    a = np.asarray(x, F)
    bits = a.view(np.uint32).astype(np.int64)
    low = bits & 0xFFFF
    near = np.abs(low - 0x8000) <= TIE_ULPS
    down = (bits & ~0xFFFF).astype(np.uint32).view(F)
    up = ((bits & ~0xFFFF) + 0x10000).astype(np.uint32).view(F)
    rounded = bf16(a)
    other = np.where(rounded == down, up, down)
    return np.where(near, other, F(np.nan)).astype(F)


def tf32(x):
    """float32 → TF32 (10 fraction bits, to nearest) → float32."""
    a = np.asarray(x, F)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(F).reshape(a.shape)


# --- scalar vector algebra (tuples of np.float32) ------------------------

def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def neg(a):
    return (-a[0], -a[1], -a[2])


def sgn(x):
    return ONE if x >= ZERO else -ONE


def clamp(x, lo, hi):
    return min(max(x, lo), hi)


def axes(q):
    """The rotation's columns (world images of the body axes) of the
    quaternion (w, x, y, z), as ODE's dRfromQ makes them."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((ONE - TWO * (yy + zz), TWO * (xy + wz), TWO * (xz - wy)),
            (TWO * (xy - wz), ONE - TWO * (xx + zz), TWO * (yz + wx)),
            (TWO * (xz + wy), TWO * (yz - wx), ONE - TWO * (xx + yy)))


def to_world(cols, v):
    return add(add(scale(cols[0], v[0]), scale(cols[1], v[1])),
               scale(cols[2], v[2]))


def to_body(cols, v):
    return (dot(cols[0], v), dot(cols[1], v), dot(cols[2], v))


# --- pair kernels: lists of (point, normal a→b, depth, valid) ------------

def sphere_sphere(pa, ra, pb, rb):
    d = sub(pb, pa)
    dist = np.sqrt(dot(d, d))
    if dist > EPS:
        n = scale(d, ONE / dist)
    else:
        n = (ZERO, ONE, ZERO)
    depth = (ra + rb) - dist
    return [(add(pa, scale(n, ra - HALF * depth)), n, depth, depth > ZERO)]


def sphere_box(center, radius, pb, qb, sb):
    cols = axes(qb)
    half = scale(sb, HALF)
    p = to_body(cols, sub(center, pb))
    cl = tuple(clamp(p[k], -half[k], half[k]) for k in range(3))
    delta = sub(p, cl)
    dist = np.sqrt(dot(delta, delta))
    if dist > EPS:
        n_local = scale(delta, -(ONE / dist))
        depth = radius - dist
        surf = cl
    else:
        # inside: out through the nearest face (the first on ties)
        fd = tuple(half[k] - abs(p[k]) for k in range(3))
        k = 0 if fd[0] <= fd[1] and fd[0] <= fd[2] else (
            1 if fd[1] <= fd[2] else 2)
        s = sgn(p[k])
        n_local = tuple(s if m == k else ZERO for m in range(3))
        depth = radius + fd[k]
        surf = tuple(p[m] + s * fd[k] if m == k else p[m] for m in range(3))
    return [(add(pb, to_world(cols, surf)), to_world(cols, n_local), depth,
             depth > ZERO)]


def _closest_segments(p0, p1, q0, q1):
    d1, d2, r = sub(p1, p0), sub(q1, q0), sub(p0, q0)
    a, e, f = dot(d1, d1), dot(d2, d2), dot(d2, r)
    c, b = dot(d1, r), dot(d1, d2)
    denom = a * e - b * b
    s = clamp((b * f - c * e) / max(denom, EPS), ZERO, ONE) \
        if denom > EPS else ZERO
    t = clamp((b * s + f) / max(e, EPS), ZERO, ONE)
    s = clamp((b * t - c) / max(a, EPS), ZERO, ONE)
    return add(p0, scale(d1, s)), add(q0, scale(d2, t))


def _edge_axis(i, col):
    """e_i × col, in a's frame."""
    if i == 0:
        return (ZERO, -col[2], col[1])
    if i == 1:
        return (col[2], ZERO, -col[0])
    return (-col[1], col[0], ZERO)


def box_box(pa, qa, sa, pb, qb, sb):
    """8 candidates (point, normal a→b, depth, valid)."""
    ca, cb = axes(qa), axes(qb)
    ha, hb = scale(sa, HALF), scale(sb, HALF)
    t = to_body(ca, sub(pb, pa))
    c = [[dot(ca[i], cb[j]) for j in range(3)] for i in range(3)]
    ac = [[abs(c[i][j]) + F(1e-6) for j in range(3)] for i in range(3)]

    # edge axes, columns of b outer, axes of a inner; first maximum of the
    # fudged separation
    worst = -F(np.inf)
    edge = None                      # (adjusted, raw, unit, i, j)
    for j in range(3):
        col = (c[0][j], c[1][j], c[2][j])
        for i in range(3):
            u = _edge_axis(i, col)
            norm = np.sqrt(dot(u, u))
            unit = scale(u, ONE / max(norm, EPS))
            proj_a = (abs(unit[0]) * ha[0] + abs(unit[1]) * ha[1]
                      + abs(unit[2]) * ha[2])
            proj_b = ZERO
            for m in range(3):
                proj_b = proj_b + abs(c[0][m] * unit[0] + c[1][m] * unit[1]
                                      + c[2][m] * unit[2]) * hb[m]
            sep = abs(dot(unit, t)) - (proj_a + proj_b)
            if norm > F(1e-6):
                worst = max(worst, sep)
                adj = sep * (F(1.0 / 1.05) if sep < ZERO else F(1.05))
            else:
                adj = -F(np.inf)
            if edge is None or adj > edge[0]:
                edge = (adj, sep, unit, i, j)
    faces = []
    for i in range(3):
        faces.append(abs(t[i]) - (((ha[i] + ac[i][0] * hb[0])
                                   + ac[i][1] * hb[1]) + ac[i][2] * hb[2]))
    for j in range(3):
        tb = (c[0][j] * t[0] + c[1][j] * t[1]) + c[2][j] * t[2]
        faces.append(abs(tb) - (((hb[j] + ac[0][j] * ha[0])
                                 + ac[1][j] * ha[1]) + ac[2][j] * ha[2]))
    code = 0
    for k in range(1, 6):
        if faces[k] > faces[code]:
            code = k
    for s in faces:
        worst = max(worst, s)
    separated = worst > ZERO
    use_edge = edge[0] > faces[code]

    if use_edge:
        _, raw, unit, i, j = edge
        n_a = scale(unit, sgn(dot(unit, t)))
        normal = to_world(ca, n_a)
        sup_a = tuple(ZERO if k == i else sgn(n_a[k]) * ha[k]
                      for k in range(3))
        mid_a = add(pa, to_world(ca, sup_a))
        a0, a1 = sub(mid_a, scale(ca[i], ha[i])), add(mid_a,
                                                      scale(ca[i], ha[i]))
        n_b = tuple(-((c[0][m] * n_a[0] + c[1][m] * n_a[1])
                      + c[2][m] * n_a[2]) for m in range(3))
        sup_b = tuple(ZERO if k == j else sgn(n_b[k]) * hb[k]
                      for k in range(3))
        mid_b = add(pb, to_world(cb, sup_b))
        b0, b1 = sub(mid_b, scale(cb[j], hb[j])), add(mid_b,
                                                      scale(cb[j], hb[j]))
        x, y = _closest_segments(a0, a1, b0, b1)
        depth = -raw
        out = [(scale(add(x, y), HALF), normal, depth,
                bool(depth > ZERO) and not separated)]
        nothing = ((ZERO, ZERO, ZERO), normal, ZERO, False)
        return out + [nothing] * 7

    # face case: the reference face is a's (codes 0-2) or b's (3-5)
    k = code % 3
    ref_cols, inc_cols = (ca, cb) if code < 3 else (cb, ca)
    p_ref, p_inc = (pa, pb) if code < 3 else (pb, pa)
    h_ref, h_inc = (ha, hb) if code < 3 else (hb, ha)
    n_ref = ref_cols[k]
    n_ref = scale(n_ref, sgn(dot(n_ref, sub(p_inc, p_ref))))
    normal = n_ref if code < 3 else neg(n_ref)
    k0, k1 = (1 if k == 0 else 0), (1 if k == 2 else 2)
    u0, u1 = ref_cols[k0], ref_cols[k1]
    hu0, hu1 = h_ref[k0], h_ref[k1]
    center = add(p_ref, scale(n_ref, h_ref[k]))
    # incident face: the incident axis most anti-parallel to n_ref
    align = [dot(inc_cols[m], n_ref) for m in range(3)]
    m = 0
    for mm in (1, 2):
        if abs(align[mm]) > abs(align[m]):
            m = mm
    inc_sign = -F(np.sign(align[m]))
    inc_center = add(p_inc, scale(inc_cols[m], inc_sign * h_inc[m]))
    m0, m1 = (1 if m == 0 else 0), (1 if m == 2 else 2)
    v0 = scale(inc_cols[m0], h_inc[m0])
    v1 = scale(inc_cols[m1], h_inc[m1])
    quad = []
    for s0, s1 in ((ONE, ONE), (ONE, -ONE), (-ONE, -ONE), (-ONE, ONE)):
        rel = sub(add(inc_center, add(scale(v0, s0), scale(v1, s1))), center)
        quad.append((dot(rel, u0), dot(rel, u1)))
    cands = [(clamp(x, -hu0, hu0), clamp(y, -hu1, hu1), True)
             for x, y in quad]
    for sx, sy in ((-ONE, -ONE), (ONE, -ONE), (ONE, ONE), (-ONE, ONE)):
        rx, ry = sx * hu0, sy * hu1
        side = []
        for e in range(4):
            (x0, y0), (x1, y1) = quad[e], quad[(e + 1) % 4]
            side.append((x1 - x0) * (ry - y0) - (y1 - y0) * (rx - x0))
        inside = (all(s >= F(-1e-7) for s in side)
                  or all(s <= F(1e-7) for s in side))
        cands.append((rx, ry, inside))
    inc_n = scale(inc_cols[m], inc_sign)
    denom = dot(inc_n, n_ref)
    if not abs(denom) > F(1e-6):
        denom = ONE
    d_inc = dot(inc_n, inc_center)
    out = []
    for x, y, inside in cands:
        base = add(center, add(scale(u0, x), scale(u1, y)))
        z = (d_inc - dot(base, inc_n)) / denom
        depth = -z
        point = sub(add(base, scale(n_ref, z)), scale(n_ref, HALF * depth))
        out.append((point, normal, depth,
                    inside and bool(depth > ZERO) and not separated))
    return out


def fold(cands):
    """8 box-box candidates → 4: candidate k against k + 4, the valid one,
    or the deeper of two valid ones (k on a tie)."""
    out = []
    for k in range(4):
        lo, hi = cands[k], cands[k + 4]
        if hi[3] and (not lo[3] or hi[2] > lo[2]):
            out.append(hi)
        else:
            out.append(lo)
    return out


# --- one world's substep -------------------------------------------------

def aabbs(w):
    """(N, 2, 3) min and max of each slot's box on the state as it is."""
    n = len(w["body_type"])
    out = np.zeros((n, 2, 3), F)
    for i in range(n):
        t = int(w["body_type"][i])
        s = w["size"][i]
        if t == NULL:
            out[i, 0], out[i, 1] = ONE, -ONE
            continue
        if t == SPHERE:
            half = (s[0], s[0], s[0])
        elif t == BOX:
            half = (s[0] * HALF, s[1] * HALF, s[2] * HALF)
        elif t == CAPSULE:
            half = (s[0], s[0], HALF * s[1] + s[0])
        else:
            half = (F(1e9),) * 3
        cols = axes(tuple(w["quat"][i]))
        for r in range(3):
            ext = (abs(cols[0][r]) * half[0] + abs(cols[1][r]) * half[1]
                   + abs(cols[2][r]) * half[2])
            out[i, 0, r] = w["pos"][i][r] - ext
            out[i, 1, r] = w["pos"][i][r] + ext
    return out


def buckets(w, caps):
    """{(t1, t2): (pairs kept, dropped)}: each type pair's candidates in
    row-major order."""
    box = aabbs(w)
    types = np.asarray(w["body_type"], np.int64)
    n = len(types)
    live = (types != NULL) & (types != TRIMESH)
    mass = w["inv_mass"] > 0
    cat = np.asarray(w["category"], np.int64)
    col = np.asarray(w["collide"], np.int64)
    hit = (np.triu(np.ones((n, n), bool), 1)
           & live[:, None] & live[None, :]
           & (mass[:, None] | mass[None, :])
           & (((cat[:, None] & col[None, :]) != 0)
              | ((cat[None, :] & col[:, None]) != 0))
           & np.all(box[:, None, 0] <= box[None, :, 1], -1)
           & np.all(box[None, :, 0] <= box[:, None, 1], -1))
    found = {b: [] for b in BUCKETS}
    for i, j in np.argwhere(hit):
        key = (min(types[i], types[j]), max(types[i], types[j]))
        if key in found:
            found[key].append((int(i), int(j)))
    return {b: (p[:caps[b]], max(0, len(p) - caps[b]))
            for b, p in found.items()}


def contacts(w, e, feats):
    """The emitted rows of a world: a list of (a, b, point, normal,
    depth) before rounding, in emission order, and the dropped pairs."""
    caps = {b: int(e["max_pair_candidates"]) for b in BUCKETS}
    caps.update({(int(t1), int(t2)): int(c)
                 for t1, t2, c in e["bucket_caps"]})
    rows, dropped = [], 0
    pos, quat, size = feats
    for (t1, t2), (pairs, over) in buckets(w, caps).items():
        dropped += over
        slots = 1 if t2 == SPHERE or t1 != t2 else 4
        per_pair = []
        for i, j in pairs:
            if (t1, t2) == (SPHERE, SPHERE):
                got = sphere_sphere(pos[i], size[i][0], pos[j], size[j][0])
            elif (t1, t2) == (SPHERE, BOX):
                s, b = (i, j) if int(w["body_type"][i]) == SPHERE else (j, i)
                got = sphere_box(pos[s], size[s][0], pos[b], quat[b], size[b])
                if s != i:
                    got = [(p, neg(n), d, v) for p, n, d, v in got]
            else:
                got = fold(box_box(pos[i], quat[i], size[i],
                                   pos[j], quat[j], size[j]))
            per_pair.append((i, j, got))
        for k in range(slots):
            for i, j, got in per_pair:
                p, n, d, v = got[k]
                if v:
                    rows.append((i, j, p, n, d))
    return rows, dropped


def _rows(w, e, feats):
    """Kept rows as arrays (a, b, point, normal, depth), rounded to
    bfloat16, and the dropped pairs and rows."""
    rows, dropped = contacts(w, e, feats)
    kept = rows[:int(e["max_contacts"])]
    dropped += len(rows) - len(kept)
    a = np.array([r[0] for r in kept], np.int64)
    b = np.array([r[1] for r in kept], np.int64)
    point = np.array([r[2] for r in kept], F).reshape(-1, 3)
    normal = np.array([r[3] for r in kept], F).reshape(-1, 3)
    depth = np.array([r[4] for r in kept], F)
    return a, b, bf16(point), bf16(normal), bf16(depth), dropped


def cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def rotation(q):
    """(N, 3, 3) rotation matrices of unit quaternions (N, 4)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.empty((len(q), 3, 3), F)
    r[:, 0, 0] = ONE - TWO * (y * y + z * z)
    r[:, 0, 1] = TWO * (x * y - w * z)
    r[:, 0, 2] = TWO * (x * z + w * y)
    r[:, 1, 0] = TWO * (x * y + w * z)
    r[:, 1, 1] = ONE - TWO * (x * x + z * z)
    r[:, 1, 2] = TWO * (y * z - w * x)
    r[:, 2, 0] = TWO * (x * z - w * y)
    r[:, 2, 1] = TWO * (y * z + w * x)
    r[:, 2, 2] = ONE - TWO * (x * x + y * y)
    return r


def matvec(m, v):
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


def solve(w, e, rows, tf):
    """Gravity, the gyroscopic term and the heavy-ball Jacobi solve of the
    rows, in place on ``w``'s velocities; ``tf`` rounds the solver's
    gathered and scattered operands (the control)."""
    dt = F(e["dt"])
    a, b, point, normal, depth = rows
    n = len(w["body_type"])
    rot = rotation(w["quat"])
    inv_i = np.einsum("nij,nj,nkj->nik", rot, w["inv_inertia"], rot,
                      dtype=F, casting="same_kind")
    i_body = np.where(w["inv_inertia"] > 0,
                      ONE / np.maximum(w["inv_inertia"], F(1e-30)), ZERO)
    i_world = np.einsum("nij,nj,nkj->nik", rot, i_body, rot, dtype=F,
                        casting="same_kind")
    dyn = ((w["body_type"] != NULL) & ~w["is_static"]
           & ~w["is_kinematic"])[:, None]
    g = np.asarray(e["gravity"], F)
    w["linvel"] = w["linvel"] + dt * (np.where(dyn, g, ZERO)
                                      + w["inv_mass"][:, None] * w["force"])
    gyro = cross(w["angvel"], matvec(i_world, w["angvel"]))
    w["angvel"] = w["angvel"] + dt * matvec(inv_i, w["torque"] - gyro)
    if len(a) == 0:
        return
    g_ = tf if tf is not None else (lambda x: x)
    count = np.bincount(np.concatenate([a, b]), minlength=n).astype(F)
    count = np.maximum(count, ONE)
    split = np.maximum(g_(count[a]), g_(count[b]))
    inv_m = w["inv_mass"].astype(F)
    m_a, m_b = g_(inv_m[a]), g_(inv_m[b])
    ii_a, ii_b = g_(inv_i[a]), g_(inv_i[b])
    r_a = point - g_(w["pos"][a])
    r_b = point - g_(w["pos"][b])
    # tangents: n × e, e the axis of n's smallest component (the first)
    e_ax = np.eye(3, dtype=F)[np.argmin(np.abs(normal), axis=1)]
    t1 = cross(normal, e_ax)
    t1 = t1 / np.maximum(np.sqrt(np.sum(t1 * t1, -1, keepdims=True)), EPS)
    t2 = cross(normal, t1)
    cfm = F(e["cfm"]) / dt
    ax = [normal, t1, t2]
    arm_a = [cross(r_a, u) for u in ax]
    arm_b = [cross(r_b, u) for u in ax]
    # impulse → velocity of each side: ∓ inv_m u and ∓ invI (r × u)
    dw_a = [matvec(ii_a, x) for x in arm_a]
    dw_b = [matvec(ii_b, x) for x in arm_b]
    d = [(m_a + m_b + np.sum(arm_a[k] * dw_a[k], -1)
          + np.sum(arm_b[k] * dw_b[k], -1)) * split + cfm for k in range(3)]
    v = np.concatenate([w["linvel"], w["angvel"]], -1)

    def rel(vel, k):
        va, vb = g_(vel[a]), g_(vel[b])
        return (np.sum(ax[k] * vb[:, :3], -1) + np.sum(arm_b[k] * vb[:, 3:], -1)
                - np.sum(ax[k] * va[:, :3], -1)
                - np.sum(arm_a[k] * va[:, 3:], -1))

    v_n0 = rel(v, 0)
    bias = np.minimum(F(e["erp"]) * depth / dt, F(e["max_correcting_vel"]))
    bounce = np.where(-v_n0 > F(e["bounce_vel"]), -F(e["bounce"]) * v_n0,
                      ZERO)
    target = [np.maximum(bias, bounce), np.zeros_like(bias),
              np.zeros_like(bias)]
    omega, beta = F(e["jacobi_omega"]), F(e["jacobi_beta"])
    lam = [np.zeros_like(bias) for _ in range(3)]
    prev = [np.zeros_like(bias) for _ in range(3)]
    for _ in range(int(e["solver_iterations"])):
        step = []
        for k in range(3):
            dl = (omega * (target[k] - rel(v, k) - cfm * lam[k]) / d[k]
                  + beta * (lam[k] - prev[k]))
            new = np.maximum(lam[k] + dl, ZERO) if k == 0 else lam[k] + dl
            step.append(new - lam[k])
            prev[k] = lam[k]
            lam[k] = lam[k] + step[k]
        dv = np.zeros((n, 6), F)
        for k in range(3):
            lin = ax[k] * step[k][:, None]
            np.add.at(dv, a, g_(np.concatenate(
                [-m_a[:, None] * lin, -dw_a[k] * step[k][:, None]], -1)))
            np.add.at(dv, b, g_(np.concatenate(
                [m_b[:, None] * lin, dw_b[k] * step[k][:, None]], -1)))
        v = v + dv
    w["linvel"], w["angvel"] = v[:, :3].copy(), v[:, 3:].copy()


def integrate(w, e):
    dt = F(e["dt"])
    moving = (w["body_type"] != NULL) & ~w["is_static"]
    wv, q = w["angvel"], w["quat"]
    ox, oy, oz = wv[:, 0], wv[:, 1], wv[:, 2]
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    dq = HALF * np.stack([-ox * qx - oy * qy - oz * qz,
                          ox * qw + oy * qz - oz * qy,
                          -ox * qz + oy * qw + oz * qx,
                          ox * qy - oy * qx + oz * qw], -1)
    qn = q + dt * dq
    qn = qn / np.maximum(np.sqrt(np.sum(qn * qn, -1, keepdims=True)),
                         F(1e-12))
    w["pos"] = np.where(moving[:, None], w["pos"] + dt * w["linvel"],
                        w["pos"])
    w["quat"] = np.where(moving[:, None], qn, q)
    w["force"] = np.zeros_like(w["force"])
    w["torque"] = np.zeros_like(w["torque"])


def features(w, pose_choice=()):
    """Each body's position, quaternion and size rounded to bfloat16, as
    tuples of scalars; ``pose_choice``: (body, component) of the pose
    (0-2 position, 3-6 quaternion) that round the other way."""
    pose = np.concatenate([w["pos"], w["quat"]], -1)
    rounded = bf16(pose)
    for i, k in pose_choice:
        rounded[i, k] = bf16_other(pose[i, k])
    size = bf16(w["size"])
    return ([tuple(r[:3]) for r in rounded], [tuple(r[3:]) for r in rounded],
            [tuple(s) for s in size])


def pose_ties(w):
    """(body, component) of the moving bodies' pose components (0-2
    position, 3-6 quaternion) within ``TIE_ULPS`` of a bfloat16 tie."""
    moving = (w["body_type"] != NULL) & ~w["is_static"]
    pose = np.concatenate([w["pos"], w["quat"]], -1)
    near = ~np.isnan(bf16_other(pose)) & moving[:, None]
    return [(int(i), int(k)) for i, k in np.argwhere(near)]


def substep(w, e, tf=None, pose_choice=()):
    """One substep of world ``w`` (a dict of float32 arrays), a new dict."""
    w = {k: np.array(v, copy=True) for k, v in w.items()}
    a, b, point, normal, depth, dropped = _rows(w, e,
                                                features(w, pose_choice))
    w["overflow"] = w["overflow"] + dropped
    solve(w, e, (a, b, point, normal, depth), tf)
    integrate(w, e)
    return w


def call_answers(w, e, substeps: int):
    """The states after a call of ``substeps`` that the configuration
    allows: the first substep from the program's own state, each later
    one with every subset of its pose ties rounded the other way, the
    smallest subsets first, at most ``MAX_BRANCHES`` answers."""
    states = [substep(w, e)]
    for _ in range(substeps - 1):
        nxt = []
        for st in states:
            found = pose_ties(st)
            for r in range(len(found) + 1):
                for choice in itertools.combinations(found, r):
                    if len(nxt) < MAX_BRANCHES:
                        nxt.append(substep(st, e, None, choice))
        states = nxt
    return states


# --- the harness's interface ---------------------------------------------

WORLD_FIELDS = ("pos", "quat", "linvel", "angvel", "force", "torque",
                "inv_mass", "inv_inertia", "body_type", "size", "category",
                "collide", "is_static", "is_kinematic", "overflow")


def world(side: dict, j: int) -> dict:
    """World ``j`` of a sample's side: float32 arrays, the rest as is."""
    out = {}
    for name in WORLD_FIELDS:
        v = np.asarray(side[name][j])
        out[name] = v.astype(F) if v.dtype.kind == "f" else v.copy()
    out["is_static"] = out["is_static"].astype(bool)
    out["is_kinematic"] = out["is_kinematic"].astype(bool)
    out["overflow"] = out["overflow"].astype(np.int64)
    return out


def check_engine(e: dict) -> None:
    if (e["solver"] != "jacobi" or not e["typed_buckets"]
            or e["enable_capsules"] or e["enable_planes"]
            or e["exact_box_clip"] or e["sap_window"]
            or e["per_body_surface"] or e["max_contacts_per_pair"] != 4
            or e["dtype"] != "float32" or e["selector_dtype"] != "bfloat16"
            or e["solver_matmul_dtype"] != "float32"
            or not math.isinf(float(e["mu"])) or not e["friction"]):
        raise ValueError("this reference holds the throughput policy on "
                         "spheres and boxes, float32 with bfloat16 "
                         "selectors and infinite friction")


def _gaps(after: dict, ref: dict, moving) -> dict:
    d = {k: np.abs(np.asarray(after[k], np.float64)
                   - np.asarray(ref[k], np.float64)).max(-1) for k in FIELDS}
    return dict(
        vel_gap=float(np.where(moving, np.maximum(d["linvel"], d["angvel"]),
                               0.0).max()),
        pose_gap=float(np.where(moving, np.maximum(d["pos"], d["quat"]),
                                0.0).max()),
        overflow_gap=float(abs(int(after["overflow"])
                               - int(ref["overflow"]))))


def answers(before: dict, j: int, cfg: dict, traffic: dict) -> list:
    """The states after the call of world ``j`` of ``before`` that the
    configuration allows."""
    e = cfg["engine"]
    check_engine(e)
    return call_answers(world(before, j), e,
                        int(traffic["substeps_per_call"]))


def gaps(after: dict, allowed: list, before: dict) -> dict:
    """One world-call's numbers: ``after`` against the nearest allowed
    state (by the dropped rows, then the larger of its gaps)."""
    moving = (np.asarray(before["body_type"]) != NULL) & ~np.asarray(
        before["is_static"], bool)
    best = None
    for ref in allowed:
        g = _gaps(after, ref, moving)
        key = (g["overflow_gap"], max(g["vel_gap"], g["pose_gap"]))
        if best is None or key < best[0]:
            best = (key, g)
    return best[1]


def advance(before: dict, j: int, cfg: dict, traffic: dict,
            precision=None) -> dict:
    """World ``j`` of ``before`` after one call, each rounding to the
    nearest: arrays of ``FIELDS`` and ``overflow``. ``precision="tf32"``:
    the control."""
    if precision not in (None, "tf32"):
        raise ValueError(f"precision {precision!r}")
    e = cfg["engine"]
    check_engine(e)
    tf = tf32 if precision == "tf32" else None
    w = world(before, j)
    for _ in range(int(traffic["substeps_per_call"])):
        w = substep(w, e, tf)
    return {k: w[k] for k in FIELDS + ("overflow",)}
