"""Batched ray queries against world primitives and trimeshes.

The port of ``rl_ode_physics_tpu/ops/raycast.py``: the ray geom of ODE
(``dCreateRay``), which RL workloads use as lidar and height probes.
Everything is branch-free and shaped (B worlds × R rays × N slots): the
leading world axis stands where the JAX package vmaps over worlds.

The query is component-major, as in the reference: positions, directions
and the rotation matrix are separate scalar planes ((B, R, N) or (B, N)),
never (..., 3) or (..., 3, 3) minors, so the sweep is some 40 elementwise
operations on full planes. It runs in two phases: the dense sweep computes
entry distances only (``ray_distances``, all a lidar needs; the reference
leaves it to XLA to drop the rest); the per-ray winner is an ``argmin``
whose parameters are gathered by index where the reference sums one-hot
planes (the same values: a one-hot sum selects exactly), and the normal
and face selection run once per ray on the winner. ``torch.argmin``, like
``jnp.argmin``, returns the first of tied minima, so a ray that misses
everything picks slot 0 and is reported as body −1.

API:
  raycast(state, origins, dirs, config, max_dist)   → RayHits vs primitives
  raycast_mesh(origins, dirs, mesh, max_dist)       → RayHits vs a TriMesh

Hits report the nearest entry point along the ray (t in [0, max_dist]),
its surface normal (facing the ray origin) and the body slot (−1 = miss).
A ray that starts inside a volume misses that volume (entry-only, like
ODE's default ray behaviour).
"""

from __future__ import annotations

import dataclasses

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh

_EPS = 1e-9
_BIG = 1e30


@dataclasses.dataclass
class RayHits:
    """``raycast``: a leading world axis (B, R, …); ``raycast_mesh``:
    (R, …)."""

    t: torch.Tensor        # (..., R) distance along the (unit) direction
    point: torch.Tensor    # (..., R, 3) hit point
    normal: torch.Tensor   # (..., R, 3) surface normal, facing the origin
    body: torch.Tensor     # (..., R) int32 slot (-1 = miss)
    hit: torch.Tensor      # (..., R) bool


def _rot_planes(q):
    """Unit quaternion (..., 4) → nine rotation-matrix component planes
    ``r[i][j]``, the values of ``quat.to_matrix``'s [..., i, j]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(w)
    return (
        (one - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), one - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), one - 2.0 * (xx + yy)),
    )


# ---------------------------------------------------------------------------
# Entry distances on component planes
# ---------------------------------------------------------------------------

def _sphere_t_planes(m, d, radius):
    """Entry t against spheres; ``m`` = origin − centre planes, ``d`` the
    direction planes."""
    b = m[0] * d[0] + m[1] * d[1] + m[2] * d[2]
    c = m[0] * m[0] + m[1] * m[1] + m[2] * m[2] - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where(ok & (t >= 0.0), t, _BIG)


def _slab_axis(olj, dlj, halfj):
    """One axis' slab interval (t0_j, t1_j) of the box test; a parallel ray
    inside the slab contributes (−BIG, +BIG), outside (+BIG, −BIG)."""
    big = torch.abs(dlj) > _EPS
    d_safe = torch.where(big, dlj, 1.0)
    lo = (-halfj - olj) / d_safe
    hi = (halfj - olj) / d_safe
    inside = torch.abs(olj) <= halfj
    t0 = torch.where(big, torch.minimum(lo, hi),
                     torch.where(inside, -_BIG, _BIG))
    t1 = torch.where(big, torch.maximum(lo, hi),
                     torch.where(inside, _BIG, -_BIG))
    return t0, t1


def _box_locals(r, m, d):
    """World → box-local components: ol_j = Σ_i r[i][j]·m_i (Rᵀ·m), and the
    same for the direction. ``r``: 3×3 tuple of planes."""
    ol = tuple(r[0][j] * m[0] + r[1][j] * m[1] + r[2][j] * m[2]
               for j in range(3))
    dl = tuple(r[0][j] * d[0] + r[1][j] * d[1] + r[2][j] * d[2]
               for j in range(3))
    return ol, dl


def _box_t_planes(ol, dl, half):
    """Entry t against boxes in local components; returns (t, (t0_0, t0_1,
    t0_2)) so that the winner pass recovers the entry face from the same
    arithmetic."""
    t0s, t1s = [], []
    for j in range(3):
        t0j, t1j = _slab_axis(ol[j], dl[j], half[j])
        t0s.append(t0j)
        t1s.append(t1j)
    t0 = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t1 = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    ok = (t0 <= t1) & (t0 >= 0.0)
    return torch.where(ok, t0, _BIG), tuple(t0s)


def _capsule_t_planes(m0, d, a, radius, half_len):
    """Entry t against capsules; ``m0`` = origin − p0 planes (p0 the bottom
    cap's centre), ``a`` the world axis planes."""
    d_ax = d[0] * a[0] + d[1] * a[1] + d[2] * a[2]
    m_ax = m0[0] * a[0] + m0[1] * a[1] + m0[2] * a[2]
    dp = tuple(d[i] - a[i] * d_ax for i in range(3))
    mp = tuple(m0[i] - a[i] * m_ax for i in range(3))
    qa = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]
    qb = mp[0] * dp[0] + mp[1] * dp[1] + mp[2] * dp[2]
    qc = mp[0] * mp[0] + mp[1] * mp[1] + mp[2] * mp[2] - radius * radius
    disc = qb * qb - qa * qc
    ok_c = (disc >= 0.0) & (qa > _EPS)
    t_cyl = (-qb - torch.sqrt(torch.clamp_min(disc, 0.0))) / torch.where(
        qa > _EPS, qa, 1.0)
    s = m_ax + t_cyl * d_ax                                # axial coordinate
    ok_c = ok_c & (t_cyl >= 0.0) & (s >= 0.0) & (s <= 2.0 * half_len)
    t_cyl = torch.where(ok_c, t_cyl, _BIG)

    t_c0 = _sphere_t_planes(m0, d, radius)
    m1 = tuple(m0[i] - a[i] * 2.0 * half_len for i in range(3))
    t_c1 = _sphere_t_planes(m1, d, radius)
    return torch.minimum(t_cyl, torch.minimum(t_c0, t_c1))


def _plane_t_planes(m, d, n_p):
    """Entry t against planes; ``n_p`` the plane normal planes, ``m`` =
    origin − position."""
    denom = n_p[0] * d[0] + n_p[1] * d[1] + n_p[2] * d[2]
    num = -(n_p[0] * m[0] + n_p[1] * m[1] + n_p[2] * m[2])
    t = num / torch.where(torch.abs(denom) > _EPS, denom, 1.0)
    ok = (torch.abs(denom) > _EPS) & (t >= 0.0)
    return torch.where(ok, t, _BIG)


# ---------------------------------------------------------------------------
# The winner's normal (one slot per ray, (B, R) planes)
# ---------------------------------------------------------------------------

def _winner_normal(o, d, t, w, config):
    """Surface normal components at ``o + t·d`` on the winner primitive.

    ``o``/``d``: 3-tuples of (B, R) ray components; ``w``: the winner's
    gathered parameters (position, rotation, size and type planes). Only
    the face and axis selection that the dense sweep skipped is recomputed;
    t comes from the sweep (the same arithmetic, the same value).
    """
    p = tuple(o[i] + t * d[i] for i in range(3))
    radius = torch.clamp_min(w["s0"], _EPS)
    pos = (w["px"], w["py"], w["pz"])
    r = w["r"]
    bt = w["bt"]

    rel = tuple(p[i] - pos[i] for i in range(3))
    n_sph = tuple(rel[i] / radius for i in range(3))

    # box: the entry face is the slab axis that attains t0; the first of
    # tied maxima, as argmax takes
    m = tuple(o[i] - pos[i] for i in range(3))
    ol, dl = _box_locals(r, m, d)
    half = (0.5 * w["s0"], 0.5 * w["s1"], 0.5 * w["s2"])
    _, t0s = _box_t_planes(ol, dl, half)
    sel0 = (t0s[0] >= t0s[1]) & (t0s[0] >= t0s[2])
    sel1 = ~sel0 & (t0s[1] >= t0s[2])
    sel2 = ~(sel0 | sel1)
    sgn = []
    for j, selj in enumerate((sel0, sel1, sel2)):
        s = -torch.sign(dl[j])
        s = torch.where(s == 0.0, 1.0, s)
        sgn.append(torch.where(selj, s, 0.0))
    n_box = tuple(r[i][0] * sgn[0] + r[i][1] * sgn[1] + r[i][2] * sgn[2]
                  for i in range(3))

    is_sph = bt == int(BodyType.SPHERE)
    n = tuple(torch.where(is_sph, n_sph[i], n_box[i]) for i in range(3))

    if config.enable_capsules:
        a = (r[0][2], r[1][2], r[2][2])                    # local z in world
        half_len = 0.5 * w["s1"]
        p0 = tuple(pos[i] - a[i] * half_len for i in range(3))
        rp = tuple(p[i] - p0[i] for i in range(3))
        s_ax = torch.clamp(rp[0] * a[0] + rp[1] * a[1] + rp[2] * a[2],
                           min=torch.zeros_like(half_len),
                           max=2.0 * half_len)
        n_cap = tuple((rp[i] - a[i] * s_ax) / radius for i in range(3))
        is_cap = bt == int(BodyType.CAPSULE)
        n = tuple(torch.where(is_cap, n_cap[i], n[i]) for i in range(3))
    if config.enable_planes:
        a = (r[0][2], r[1][2], r[2][2])
        d_dot = a[0] * d[0] + a[1] * d[1] + a[2] * d[2]
        flip = -torch.sign(d_dot)
        n_pl = tuple(a[i] * flip for i in range(3))
        is_pl = bt == int(BodyType.PLANE)
        n = tuple(torch.where(is_pl, n_pl[i], n[i]) for i in range(3))
    return n


# ---------------------------------------------------------------------------
# Rays against the primitives of every world
# ---------------------------------------------------------------------------

def _rays(state: WorldState, origins, dirs):
    """(B, R, 3) origins and unit directions on the state's device; (R, 3)
    rays are shared by every world."""
    f, dev = state.pos.dtype, state.device
    o_in = torch.as_tensor(origins, dtype=f, device=dev)
    d_in = torch.as_tensor(dirs, dtype=f, device=dev)
    d_in = d_in / torch.clamp_min(
        torch.linalg.vector_norm(d_in, dim=-1, keepdim=True), _EPS)
    shape = (state.num_worlds,) + tuple(o_in.shape[-2:])
    return o_in.expand(shape), d_in.expand(shape)


def _slot_planes(state: WorldState) -> dict:
    """Each slot's parameters as (B, N) planes."""
    return {
        "px": state.pos[..., 0], "py": state.pos[..., 1],
        "pz": state.pos[..., 2],
        "s0": state.size[..., 0], "s1": state.size[..., 1],
        "s2": state.size[..., 2],
        "r": _rot_planes(state.quat),
        "bt": state.body_type,
    }


def _sweep(state: WorldState, slots: dict, o_in, d_in, config: EngineConfig,
           max_dist: float) -> torch.Tensor:
    """(B, R, N) entry distances, ``_BIG`` where a ray misses a slot."""
    # ray components (B, R, 1) against slot planes (B, 1, N) → (B, R, N)
    o = tuple(o_in[..., i, None] for i in range(3))
    d = tuple(d_in[..., i, None] for i in range(3))
    px, py, pz, s0, s1, s2 = (slots[k][:, None, :] for k in
                              ("px", "py", "pz", "s0", "s1", "s2"))
    r = tuple(tuple(plane[:, None, :] for plane in row) for row in slots["r"])
    radius = s0
    half = (0.5 * s0, 0.5 * s1, 0.5 * s2)
    bt = state.body_type[:, None, :]

    m = (o[0] - px, o[1] - py, o[2] - pz)

    t_s = _sphere_t_planes(m, d, radius)
    ol, dl = _box_locals(r, m, d)
    t_b, _ = _box_t_planes(ol, dl, half)
    t_all = torch.where(bt == int(BodyType.SPHERE), t_s,
                        torch.where(bt == int(BodyType.BOX), t_b, _BIG))
    if config.enable_capsules:
        a = (r[0][2], r[1][2], r[2][2])                    # capsule world axis
        half_len = 0.5 * s1
        m0 = tuple(m[i] + a[i] * half_len for i in range(3))
        t_c = _capsule_t_planes(m0, d, a, radius, half_len)
        t_all = torch.where(bt == int(BodyType.CAPSULE), t_c, t_all)
    if config.enable_planes:
        n_p = (r[0][2], r[1][2], r[2][2])
        t_p = _plane_t_planes(m, d, n_p)
        t_all = torch.where(bt == int(BodyType.PLANE), t_p, t_all)

    return torch.where(state.active[:, None, :] & (t_all <= max_dist),
                       t_all, _BIG)


def ray_distances(state: WorldState, origins, dirs, config: EngineConfig,
                  max_dist: float = 1e6) -> torch.Tensor:
    """(B, R) distance of each ray's nearest hit, ``max_dist`` for a miss:
    ``raycast(...).t`` without the winner pass, which is all a lidar
    reads."""
    o_in, d_in = _rays(state, origins, dirs)
    t = _sweep(state, _slot_planes(state), o_in, d_in, config,
               max_dist).amin(-1)
    return torch.where(t < _BIG, t, max_dist)


def raycast(state: WorldState, origins, dirs, config: EngineConfig,
            max_dist: float = 1e6) -> RayHits:
    """Nearest hit of R rays against every active primitive slot, in every
    world of the batch.

    ``origins``/``dirs``: (B, R, 3), or (R, 3) for rays shared by every
    world; directions are normalized here. All (R, N) ray-slot pairs are
    evaluated branch-free as component planes (distances only); the winner
    of each ray is the ``argmin`` over slots, and its normal is computed
    once per ray.
    """
    o_in, d_in = _rays(state, origins, dirs)
    slots = _slot_planes(state)
    t_all = _sweep(state, slots, o_in, d_in, config, max_dist)

    best = torch.argmin(t_all, dim=-1)                     # (B, R)
    t = torch.gather(t_all, -1, best[..., None])[..., 0]
    hit = t < _BIG

    def sel(plane):                                        # (B, N) → (B, R)
        return torch.gather(plane, 1, best)

    winner = {k: sel(slots[k]) for k in ("px", "py", "pz", "s0", "s1", "s2",
                                         "bt")}
    winner["r"] = tuple(tuple(sel(plane) for plane in row)
                        for row in slots["r"])
    o_r = tuple(o_in[..., i] for i in range(3))
    d_r = tuple(d_in[..., i] for i in range(3))
    n = _winner_normal(o_r, d_r, torch.where(hit, t, 0.0), winner, config)
    normal = torch.stack(n, dim=-1)                        # (B, R, 3)

    t = torch.where(hit, t, max_dist)
    return RayHits(
        t=t,
        point=o_in + t[..., None] * d_in,
        normal=torch.where(hit[..., None], normal, 0.0),
        body=torch.where(hit, best.to(torch.int32), -1),
        hit=hit,
    )


# ---------------------------------------------------------------------------
# Rays against a static mesh
# ---------------------------------------------------------------------------

def raycast_mesh(origins, dirs, mesh: TriMesh, max_dist: float = 1e6,
                 chunk: int = 2048) -> RayHits:
    """Nearest hit of R rays against a static TriMesh (Möller–Trumbore over
    all triangles; the padded degenerate triangles never hit). Rays go
    ``chunk`` at a time, so the (chunk, T) planes bound the memory."""
    f, dev = mesh.v0.dtype, mesh.device
    o = torch.as_tensor(origins, dtype=f, device=dev)
    d = torch.as_tensor(dirs, dtype=f, device=dev)
    d = d / torch.clamp_min(
        torch.linalg.vector_norm(d, dim=-1, keepdim=True), _EPS)

    v0, e1, e2 = (tuple(x[None, :, i] for i in range(3))
                  for x in (mesh.v0, mesh.e1, mesh.e2))    # (1, T) planes

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    ts, ns = [], []
    for start in range(0, o.shape[0], chunk):
        oc = tuple(o[start:start + chunk, i, None] for i in range(3))
        dc = tuple(d[start:start + chunk, i, None] for i in range(3))
        h = cross(dc, e2)
        det = dot(e1, h)
        ok = torch.abs(det) > _EPS
        inv = 1.0 / torch.where(ok, det, 1.0)
        s = tuple(oc[i] - v0[i] for i in range(3))
        u = dot(s, h) * inv
        q = cross(s, e1)
        v = dot(dc, q) * inv
        t = dot(e2, q) * inv
        ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t >= 0.0)
        t = torch.where(ok, t, _BIG)
        best = torch.argmin(t, dim=-1)                     # (chunk,)
        ts.append(torch.gather(t, -1, best[:, None])[:, 0])
        n = mesh.normal[best]                              # (chunk, 3)
        # the normal faces the origin side
        facing = torch.sum(n * d[start:start + chunk], -1, keepdim=True)
        ns.append(n * -torch.sign(facing + _EPS))
    t = torch.cat(ts)
    n = torch.cat(ns)
    hit = (t < min(_BIG, max_dist + 1.0)) & (t <= max_dist)
    t_out = torch.where(hit, t, max_dist)
    return RayHits(
        t=t_out,
        point=o + t_out[:, None] * d,
        normal=torch.where(hit[:, None], n, 0.0),
        body=torch.where(hit, mesh.slot, -1).to(torch.int32),
        hit=hit,
    )
