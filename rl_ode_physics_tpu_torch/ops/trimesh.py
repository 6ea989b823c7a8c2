"""Static-trimesh narrowphase.

The port of ``rl_ode_physics_tpu/ops/trimesh.py``. The mesh is static scene
geometry, baked once on the host and shared by every world of a batch.
Per dynamic body, phase 1 sweeps all triangles with the body's probes and
keeps the nearest tiles, then the nearest triangles; phase 2 computes the
exact contacts of each body type with those candidate triangles (spheres by
closest point, boxes by the dCollideBoxTriangle feature classes, capsules
by segment-triangle closest features) and keeps a deduplicated deepest-k
manifold per body.

Functions take tensors with any leading axes: the JAX package's ``vmap``
over worlds and bodies is written out as broadcasting. Its one-hot
selection matmuls become index gathers, which are exact, and its
``top_k``, which puts the lower index first among ties, a stable sort.

Phase 1's sweep is ``ops/mesh_kernels.sphere_mesh_d2_tiles``, a
hand-written CUDA kernel on CUDA tensors; its plain version here
(``sphere_mesh_d2_tiles_plain``) follows the Pallas kernel's operation
order, as does the one-probe sweep of ``sphere_mesh_contacts``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType, WorldState
from rl_ode_physics_tpu_torch.ops.narrowphase_cm import (
    vadd, vdot, vnormsq, vscale, vsub)
from rl_ode_physics_tpu_torch.utils import quat as quat_m

_EPS = 1e-9
MESH_TILE = 128
CAND_TILES = 8      # phase 1: nearest mesh tiles per body (×128 triangles)
CAND_TRIS = 16      # phase 1b: exact narrowphase triangles per body


@dataclasses.dataclass
class TriMesh:
    """Precomputed triangle soup in the world frame, shared by all worlds."""

    v0: torch.Tensor       # (T, 3)
    e1: torch.Tensor       # (T, 3) v1 - v0
    e2: torch.Tensor       # (T, 3) v2 - v0
    normal: torch.Tensor   # (T, 3) unit
    slot: int              # the world body slot this mesh belongs to

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "TriMesh":
        return TriMesh(v0=self.v0.to(device), e1=self.e1.to(device),
                       e2=self.e2.to(device), normal=self.normal.to(device),
                       slot=self.slot)

    def transposed(self):
        """(v0t, e1t, e2t): the (3, T) component-major planes the distance
        kernels read."""
        return tuple(x.t().contiguous() for x in (self.v0, self.e1, self.e2))


def build_trimesh(vertices, triangles, slot: int = 0, dtype=torch.float32,
                  pad_to_multiple: int = 1024, device="cuda") -> TriMesh:
    """Host-side mesh bake in f64: edges, normals, padding to a tile
    multiple with degenerate triangles far away (they never produce
    contacts)."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    v0 = v[t[:, 0]]
    e1 = v[t[:, 1]] - v0
    e2 = v[t[:, 2]] - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-30)

    tcount = v0.shape[0]
    pad = (-tcount) % pad_to_multiple
    if pad:
        zeros = np.zeros((pad, 3))
        far = np.full((pad, 3), 1e9)          # degenerate, far away
        v0 = np.concatenate([v0, far])
        e1 = np.concatenate([e1, zeros])
        e2 = np.concatenate([e2, zeros])
        n = np.concatenate([n, np.tile([[0.0, 1.0, 0.0]], (pad, 1))])

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return TriMesh(v0=tensor(v0), e1=tensor(e1), e2=tensor(e2),
                   normal=tensor(n), slot=int(slot))


# ---------------------------------------------------------------------------
# Closest point on a triangle (Ericson)
# ---------------------------------------------------------------------------

def _comps(x: torch.Tensor):
    return (x[..., 0], x[..., 1], x[..., 2])


def _stack(v) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*v), dim=-1)


def _stack_rows(vecs) -> torch.Tensor:
    """Component tuples → (..., len(vecs), 3), broadcast together."""
    return torch.stack(torch.broadcast_tensors(*[_stack(v) for v in vecs]),
                       dim=-2)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def _tri_vw(d1, d2, d3, d4, d5, d6):
    """Barycentric (v, w) of the closest point from Ericson's edge/vertex
    region dot products, the regions checked in Ericson's order (the first
    match wins)."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_ab = d1 - d3
    ok_ab = torch.abs(denom_ab) > _EPS
    v_ab = torch.where(ok_ab, d1 / torch.where(ok_ab, denom_ab, 1.0), 0.0)
    denom_ac = d2 - d6
    ok_ac = torch.abs(denom_ac) > _EPS
    w_ac = torch.where(ok_ac, d2 / torch.where(ok_ac, denom_ac, 1.0), 0.0)
    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = (d4 - d3) / torch.where(torch.abs(denom_bc) > _EPS, denom_bc, 1.0)

    denom_in = va + vb + vc
    safe_in = torch.where(torch.abs(denom_in) > _EPS, denom_in, 1.0)
    v_in = vb / safe_in
    w_in = vc / safe_in

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    w_bc_c = _clip01(w_bc)
    v = torch.where(on_bc, 1.0 - w_bc_c, v_in)
    w = torch.where(on_bc, w_bc_c, w_in)
    v = torch.where(on_ac, 0.0, v)
    w = torch.where(on_ac, _clip01(w_ac), w)
    v = torch.where(on_ab, _clip01(v_ab), v)
    w = torch.where(on_ab, 0.0, w)
    v = torch.where(in_c, 0.0, v)
    w = torch.where(in_c, 1.0, w)
    v = torch.where(in_b, 1.0, v)
    w = torch.where(in_b, 0.0, w)
    v = torch.where(in_a, 0.0, v)
    w = torch.where(in_a, 0.0, w)
    return v, w


def _closest_cm(p, v0, e1, e2):
    """``closest_point_triangle`` on component tuples (x, y, z)."""
    ap = vsub(p, v0)
    d1 = vdot(e1, ap)
    d2 = vdot(e2, ap)
    bp = vsub(p, vadd(v0, e1))
    d3 = vdot(e1, bp)
    d4 = vdot(e2, bp)
    cp_ = vsub(p, vadd(v0, e2))
    d5 = vdot(e1, cp_)
    d6 = vdot(e2, cp_)
    v, w = _tri_vw(d1, d2, d3, d4, d5, d6)
    return vadd(vadd(v0, vscale(e1, v)), vscale(e2, w))


def closest_point_triangle(p, v0, e1, e2) -> torch.Tensor:
    """Closest point on triangle(s) (v0, v0 + e1, v0 + e2) to point(s) p,
    all (..., 3) and broadcast against each other; branch-free."""
    return _stack(_closest_cm(_comps(p), _comps(v0), _comps(e1), _comps(e2)))


# ---------------------------------------------------------------------------
# Plain versions of the distance kernels (ops/mesh_kernels.py)
# ---------------------------------------------------------------------------

def _d2_pallas_order(p, v0, e1, e2):
    """Squared distance from p to its closest point on the triangle, in the
    Pallas kernels' operation order (``pallas_kernels.py:47-64``): the
    offsets come from ``ap`` (``ap - e1``, ``ap - v·e1 - w·e2``) where
    ``closest_point_triangle`` works from ``p`` and ``v0``."""
    apx, apy, apz = vsub(p, v0)
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    d1 = e1x * apx + e1y * apy + e1z * apz
    d2 = e2x * apx + e2y * apy + e2z * apz
    bpx, bpy, bpz = apx - e1x, apy - e1y, apz - e1z
    d3 = e1x * bpx + e1y * bpy + e1z * bpz
    d4 = e2x * bpx + e2y * bpy + e2z * bpz
    cpx, cpy, cpz = apx - e2x, apy - e2y, apz - e2z
    d5 = e1x * cpx + e1y * cpy + e1z * cpz
    d6 = e2x * cpx + e2y * cpy + e2z * cpz
    v, w = _tri_vw(d1, d2, d3, d4, d5, d6)
    dx = apx - v * e1x - w * e2x
    dy = apy - v * e1y - w * e2y
    dz = apz - v * e1z - w * e2z
    return dx * dx + dy * dy + dz * dz


def _d2_kernel_order(p, v0, e1, e2):
    """The same squared distance in the operation order of
    ``csrc/sphere_mesh_d2.cu``, for the tests, which hold it to
    ``_d2_pallas_order`` at rtol 1e-5, atol 1e-6.

    The kernel works from what belongs to the triangle alone: ``a = e1·e1``,
    ``b = e1·e2``, ``c = e2·e2``. With ``s = d1`` and ``t = d2``:
    ``d3 = s − a``, ``d4 = t − b``, ``d5 = s − b``, ``d6 = t − c``,
    ``vb = c·s − b·t``, ``vc = a·t − b·s``, and every denominator of
    ``_tri_vw`` is a constant of the triangle (``d1 − d3 = a``,
    ``d2 − d6 = c``, ``(d4 − d3) + (d5 − d6) = (a − b) + (c − b)``,
    ``va + vb + vc = a·c − b² = det``), so its guarded reciprocal is taken
    once per triangle and a pair divides nowhere. The interior's
    ``v = vb/det`` and ``w = vc/det`` come straight from ``a/det``,
    ``b/det``, ``c/det``; they carry the signs of ``vb`` and ``vc``, and
    ``va <= 0`` is ``v + w >= 1`` (``>= det`` where the guard replaced
    ``1/det`` by 1). A vertex region's (v, w) is what the clipped formula
    of an edge through that vertex gives, so the six regions fold into
    three selections, in ``_tri_vw``'s priority; what is left outside the
    triangle after the two edges through A is the region of edge BC, so
    ``va <= 0`` alone selects it."""
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    a = e1x * e1x + e1y * e1y + e1z * e1z
    b = e1x * e2x + e1y * e2y + e1z * e2z
    c = e2x * e2x + e2y * e2y + e2z * e2z

    def guarded_reciprocal(x, otherwise):
        ok = torch.abs(x) > _EPS
        return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), otherwise)

    inv_a = guarded_reciprocal(a, 0.0)
    inv_c = guarded_reciprocal(c, 0.0)
    inv_bc = guarded_reciprocal((a - b) + (c - b), 1.0)
    det = a * c - b * b
    inv_det = guarded_reciprocal(det, 1.0)
    an, bn, cn, one = a * inv_det, b * inv_det, c * inv_det, det * inv_det

    apx, apy, apz = vsub(p, v0)
    s = e1x * apx + e1y * apy + e1z * apz
    t = e2x * apx + e2y * apy + e2z * apz
    d3, d4, d5, d6 = s - a, t - b, s - b, t - c
    d43 = d4 - d3
    v_in = cn * s - bn * t
    w_in = an * t - bn * s

    in_a = (s <= 0) & (t <= 0)
    in_b = (d3 >= 0) & (d43 <= 0)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (w_in <= 0) & (s >= 0) & (d3 <= 0)
    on_ac = (v_in <= 0) & (t >= 0) & (d6 <= 0)
    on_bc = (v_in + w_in) >= one
    use_ab = in_a | in_b | (on_ab & ~in_c)
    use_ac = in_c | on_ac

    u = _clip01(d43 * inv_bc)
    v = torch.where(on_bc, 1.0 - u, v_in)
    w = torch.where(on_bc, u, w_in)
    v = torch.where(use_ac, 0.0, v)
    w = torch.where(use_ac, _clip01(t * inv_c), w)
    v = torch.where(use_ab, _clip01(s * inv_a), v)
    w = torch.where(use_ab, 0.0, w)
    dx = apx - v * e1x - w * e2x
    dy = apy - v * e1y - w * e2y
    dz = apz - v * e1z - w * e2z
    return dx * dx + dy * dy + dz * dz


def sphere_mesh_d2_tiles_plain(probes, v0t, e1t, e2t, chunk: int = 2048):
    """The plain version of ``mesh_kernels.sphere_mesh_d2_tiles``: (P, 3)
    probes against (3, T) triangle planes → (P, T/128) per-tile minimum
    squared distances. Probes go ``chunk`` at a time, so the (chunk, T)
    intermediate planes bound the memory."""
    t = v0t.shape[1]
    nt = t // MESH_TILE
    tris = [tuple(x[c][None, :] for c in range(3)) for x in (v0t, e1t, e2t)]
    out = []
    for s in range(0, probes.shape[0], chunk):
        pc = probes[s:s + chunk]
        p = tuple(pc[:, c:c + 1] for c in range(3))
        dd = _d2_pallas_order(p, *tris)                       # (chunk, T)
        out.append(dd.reshape(-1, nt, MESH_TILE).amin(-1))
    return torch.cat(out)


def sphere_mesh_d2_plain(center, v0t, e1t, e2t):
    """The plain version of ``mesh_kernels.sphere_mesh_d2``: (3,) center
    against (3, T) triangle planes → (T/128, 128) squared distances."""
    t = v0t.shape[1]
    p = (center[0], center[1], center[2])
    dd = _d2_pallas_order(p, tuple(v0t), tuple(e1t), tuple(e2t))
    return dd.reshape(t // MESH_TILE, MESH_TILE)


def _top_k_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, the lower
    index first among ties: ``jax.lax.top_k(-x, k)``."""
    return torch.sort(-x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, C) at idx (..., J) along M → (..., J, C)."""
    idx = idx[..., None].expand(idx.shape + x.shape[-1:])
    return torch.gather(x, -2, idx)


# ---------------------------------------------------------------------------
# Sphere contacts (one probe sphere against the whole mesh)
# ---------------------------------------------------------------------------

def sphere_mesh_contacts(center: torch.Tensor, radius, mesh: TriMesh, k: int):
    """Deepest-k contacts of one probe sphere against the whole mesh.

    1. squared distance to every triangle, tiled (T/128, 128): the
       ``sphere_mesh_d2`` kernel on a CUDA tensor, its plain version on a
       CPU tensor;
    2. per-tile minimum → the k deepest tiles;
    3. exact contact points recomputed for those k tiles only.

    Returns (points (k, 3), normals (k, 3) sphere → mesh, depths (k,),
    valid (k,)). Ties go to the lower tile and triangle index.
    """
    from rl_ode_physics_tpu_torch.ops import mesh_kernels

    nt = mesh.num_tris // MESH_TILE
    d2_t = mesh_kernels.sphere_mesh_d2(center, *mesh.transposed())
    tile_d2 = d2_t.amin(1)                                       # (nt,)
    depth = radius - torch.sqrt(torch.clamp_min(tile_d2, 0.0))
    keys = torch.where(depth > 0, depth, -torch.inf)
    if k > nt:  # tiny meshes: fewer tiles than requested contacts
        keys = torch.cat([keys, keys.new_full((k - nt,), -torch.inf)])
    top_d, top_i = torch.sort(keys, descending=True, stable=True)
    top_d, top_i = top_d[:k], top_i[:k]

    # the k winning tiles' triangles; a padding key selects a zero triangle
    real = top_i < nt
    idx = torch.clamp_max(top_i, nt - 1)

    def tiles(x):
        got = x.reshape(nt, MESH_TILE, 3)[idx]                  # (k, 128, 3)
        return torch.where(real[:, None, None], got, 0.0)

    closest_k = closest_point_triangle(center, tiles(mesh.v0),
                                       tiles(mesh.e1), tiles(mesh.e2))
    d2_k = vnormsq(_comps(closest_k - center))                  # (k, 128)
    best = torch.argmin(d2_k, dim=1)
    pts = _take(closest_k, best[:, None])[:, 0]                 # (k, 3)

    n_dir = pts - center                                        # sphere → mesh
    n_len = torch.sqrt(vnormsq(_comps(n_dir)))[:, None]
    up = torch.tensor([0.0, 1.0, 0.0], dtype=center.dtype,
                      device=center.device)
    # center exactly on a surface point: deterministic up fallback
    n_out = torch.where(n_len > 1e-6, n_dir / torch.clamp_min(n_len, _EPS),
                        -up)
    valid = torch.isfinite(top_d) & (top_d > 0)
    return pts, n_out, torch.where(valid, top_d, 0.0), valid


# ---------------------------------------------------------------------------
# Box and capsule contacts against one triangle
# ---------------------------------------------------------------------------

def _bary_uw(d, e1, e2, a11, a12, a22, det):
    """Barycentric (u along e1, w along e2) of the in-plane part of the
    offset ``d`` from v0 (component tuples). Valid when |det| > eps."""
    b1 = vdot(e1, d)
    b2 = vdot(e2, d)
    ok = torch.abs(det) > _EPS
    safe = torch.where(ok, det, 1.0)
    u = (a22 * b1 - a12 * b2) / safe
    w = (a11 * b2 - a12 * b1) / safe
    return u, w, ok


def _mat_vec(r, v):
    """R @ v with R as rows r[i][j]."""
    return tuple(r[i][0] * v[0] + r[i][1] * v[1] + r[i][2] * v[2]
                 for i in range(3))


def _vec_mat(v, r):
    """v @ R (= Rᵀ v), world → box-local."""
    return tuple(v[0] * r[0][j] + v[1] * r[1][j] + v[2] * r[2][j]
                 for j in range(3))


def _min_face_exit(q, half, r):
    """For a box-local point q (assumed inside): the depth to the nearest
    face and that face's outward normal in the world frame."""
    slack = tuple(half[i] - torch.abs(q[i]) for i in range(3))
    # first minimum, as jnp.argmin
    is0 = (slack[0] <= slack[1]) & (slack[0] <= slack[2])
    is1 = ~is0 & (slack[1] <= slack[2])
    depth = torch.minimum(torch.minimum(slack[0], slack[1]), slack[2])

    def pick(x0, x1, x2):
        return torch.where(is0, x0, torch.where(is1, x1, x2))

    sign = torch.sign(pick(*q))
    sign = torch.where(sign == 0.0, 1.0, sign)
    n_world = tuple(pick(r[i][0], r[i][1], r[i][2]) * sign for i in range(3))
    return depth, n_world


_CORNERS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
            for sz in (-1.0, 1.0)]


def box_tri_candidates(pos, r_mat, half, v0, e1, e2, n_tri):
    """Exact box-against-triangle contact candidates (17 rows):

      0..7   box corners below the triangle plane whose projection lies
             inside the triangle (face contact);
      8..10  triangle vertices inside the box (depth and normal of the
             nearest box face exit);
      11..16 triangle edges clipped to the box slabs: the two clipped
             endpoints per edge where clipping occurred.

    Vectors are (..., 3), ``r_mat`` (..., 3, 3), all broadcast together.
    Normals point box → mesh. Returns (pts (..., 17, 3), nrm (..., 17, 3),
    dep (..., 17), valid (..., 17)); rows that are not valid may hold ±inf
    or NaN.
    """
    p, h = _comps(pos), _comps(half)
    v0, e1, e2, n_tri = _comps(v0), _comps(e1), _comps(e2), _comps(n_tri)
    r = [[r_mat[..., i, j] for j in range(3)] for i in range(3)]
    eps = 1e-6
    a11 = vdot(e1, e1)
    a12 = vdot(e1, e2)
    a22 = vdot(e2, e2)
    det = a11 * a22 - a12 * a12

    # double-sided mesh: orient the face normal toward the box center
    s_face = torch.sign(vdot(vsub(p, v0), n_tri))
    s_face = torch.where(s_face == 0.0, 1.0, s_face)
    n_f = vscale(n_tri, s_face)

    pts, nrm, dep, val = [], [], [], []

    # ---- corners below the triangle plane -------------------------------
    for unit in _CORNERS:
        local = tuple(unit[i] * h[i] for i in range(3))
        corner = vadd(p, _mat_vec(r, local))
        rel = vsub(corner, v0)
        h_c = vdot(rel, n_f)
        u, w, ok = _bary_uw(rel, e1, e2, a11, a12, a22, det)
        inside_tri = ok & (u >= -eps) & (w >= -eps) & (u + w <= 1.0 + eps)
        dep_c = -h_c
        pts.append(corner)
        nrm.append(tuple(-x for x in n_f))
        dep.append(dep_c)
        val.append((dep_c > 0.0) & inside_tri)

    # ---- triangle vertices inside the box -------------------------------
    tri_v = [v0, vadd(v0, e1), vadd(v0, e2)]
    for tv in tri_v:
        q = _vec_mat(vsub(tv, p), r)
        inside_box = ((torch.abs(q[0]) <= h[0] + eps)
                      & (torch.abs(q[1]) <= h[1] + eps)
                      & (torch.abs(q[2]) <= h[2] + eps))
        dep_v, nrm_v = _min_face_exit(q, h, r)
        pts.append(tv)
        nrm.append(nrm_v)
        dep.append(dep_v)
        val.append(inside_box & (dep_v > 0.0))

    # ---- triangle edges clipped to the box ------------------------------
    e_dirs = [e1, vsub(e2, e1), tuple(-x for x in e2)]
    for p_a, d in zip(tri_v, e_dirs):
        a = _vec_mat(vsub(p_a, p), r)
        dl = _vec_mat(d, r)
        t0i, t1i = [], []
        for i in range(3):
            big = torch.abs(dl[i]) > _EPS
            d_safe = torch.where(big, dl[i], 1.0)
            lo = (-h[i] - a[i]) / d_safe
            hi = (h[i] - a[i]) / d_safe
            inside = torch.abs(a[i]) <= h[i]
            t0i.append(torch.where(big, torch.minimum(lo, hi),
                                   torch.where(inside, 0.0, torch.inf)))
            t1i.append(torch.where(big, torch.maximum(lo, hi),
                                   torch.where(inside, 1.0, -torch.inf)))
        t0 = torch.clamp_min(
            torch.maximum(torch.maximum(t0i[0], t0i[1]), t0i[2]), 0.0)
        t1 = torch.clamp_max(
            torch.minimum(torch.minimum(t1i[0], t1i[1]), t1i[2]), 1.0)
        nonempty = t0 < t1
        for t, was_clipped in ((t0, t0 > eps), (t1, t1 < 1.0 - eps)):
            q = vadd(a, vscale(dl, t))
            dep_e, nrm_e = _min_face_exit(q, h, r)
            pts.append(vadd(p_a, vscale(d, t)))
            nrm.append(nrm_e)
            dep.append(dep_e)
            val.append(nonempty & was_clipped & (dep_e > 0.0))

    def planes(xs):
        return torch.stack(torch.broadcast_tensors(*xs), dim=-1)

    return _stack_rows(pts), _stack_rows(nrm), planes(dep), planes(val)


def _seg_seg_closest(p1, q1, p2, q2):
    """Closest points between segments [p1, q1] and [p2, q2] (Ericson
    5.1.9, branch-free) on component tuples. Returns (c1, c2, d2)."""
    d1 = vsub(q1, p1)
    d2_ = vsub(q2, p2)
    r = vsub(p1, p2)
    a = vdot(d1, d1)
    e = vdot(d2_, d2_)
    fdot = vdot(d2_, r)
    c = vdot(d1, r)
    b = vdot(d1, d2_)
    denom = a * e - b * b
    ok = torch.abs(denom) > _EPS
    s = torch.where(
        ok, _clip01((b * fdot - c * e) / torch.where(ok, denom, 1.0)), 0.0)
    e_safe = torch.where(torch.abs(e) > _EPS, e, 1.0)
    t = _clip01((b * s + fdot) / e_safe)
    a_safe = torch.where(torch.abs(a) > _EPS, a, 1.0)
    s = _clip01((b * t - c) / a_safe)
    c1 = vadd(p1, vscale(d1, s))
    c2 = vadd(p2, vscale(d2_, t))
    return c1, c2, vnormsq(vsub(c1, c2))


def capsule_tri_candidate(p0, p1, radius, v0, e1, e2, n_tri):
    """Exact capsule core segment [p0, p1] against a triangle: the minimum
    over the closest-feature set (each endpoint against the face, the core
    against each edge) plus the core crossing the face. One candidate per
    triangle; (..., 3) vectors broadcast together. Returns (pt, nrm, dep,
    valid)."""
    a0, a1 = _comps(p0), _comps(p1)
    v0, e1, e2, n_tri = _comps(v0), _comps(e1), _comps(e2), _comps(n_tri)
    cand_tri, cand_core, d2s = [], [], []
    for pe in (a0, a1):
        ct = _closest_cm(pe, v0, e1, e2)
        cand_tri.append(ct)
        cand_core.append(pe)
        d2s.append(vnormsq(vsub(ct, pe)))
    tri_v = [v0, vadd(v0, e1), vadd(v0, e2)]
    for j in range(3):
        c_core, c_edge, d2 = _seg_seg_closest(a0, a1, tri_v[j],
                                              tri_v[(j + 1) % 3])
        cand_core.append(c_core)
        cand_tri.append(c_edge)
        d2s.append(d2)
    d2_all = torch.stack(torch.broadcast_tensors(*d2s), dim=-1)   # (..., 5)
    best = torch.argmin(d2_all, dim=-1)
    pt_tri = _take(_stack_rows(cand_tri), best[..., None])[..., 0, :]
    pt_core = _take(_stack_rows(cand_core), best[..., None])[..., 0, :]
    dist = torch.sqrt(torch.clamp_min(d2_all.amin(-1), 0.0))

    # core crosses the triangle plane inside the triangle → depth = radius
    h0 = vdot(vsub(a0, v0), n_tri)
    h1 = vdot(vsub(a1, v0), n_tri)
    crossing = h0 * h1 < 0.0
    denom = torch.where(torch.abs(h0 - h1) > _EPS, h0 - h1, 1.0)
    tx = _clip01(h0 / denom)
    px = vadd(a0, vscale(vsub(a1, a0), tx))
    a11 = vdot(e1, e1)
    a12 = vdot(e1, e2)
    a22 = vdot(e2, e2)
    det = a11 * a22 - a12 * a12
    u, w, ok = _bary_uw(vsub(px, v0), e1, e2, a11, a12, a22, det)
    cross_in = crossing & ok & (u >= 0) & (w >= 0) & (u + w <= 1.0)

    dist = torch.where(cross_in, 0.0, dist)
    pt_tri = torch.where(cross_in[..., None], _stack(px), pt_tri)
    n_dir = pt_tri - pt_core
    n_len = torch.sqrt(vnormsq(_comps(n_dir)))[..., None]
    n_fallback = -_stack(n_tri) * torch.sign(
        torch.where(torch.abs(h0) > torch.abs(h1), h0, h1))[..., None]
    nrm = torch.where(n_len > 1e-6, n_dir / torch.clamp_min(n_len, _EPS),
                      n_fallback)
    dep = radius - dist
    return pt_tri, nrm, dep, dep > 0.0


def _dedup_deepest_k(pts, nrm, dep, val, k: int, dedup_r):
    """Greedy deepest-first manifold selection with near-duplicate
    suppression over the M candidates of each body: k argmax passes, the
    first index winning ties. pts/nrm (..., M, 3), dep/val (..., M),
    dedup_r (...). Returns (..., k, 3), (..., k, 3), (..., k), (..., k)."""
    keys = torch.where(val, dep, -torch.inf)
    r2 = (dedup_r * dedup_r)[..., None]
    sel_pts, sel_nrm, sel_dep, sel_val = [], [], [], []
    for _ in range(k):
        i = torch.argmax(keys, dim=-1)[..., None]
        p_i = _take(pts, i)                                 # (..., 1, 3)
        ok = keys.amax(-1) > -torch.inf
        sel_pts.append(p_i[..., 0, :])
        sel_nrm.append(_take(nrm, i)[..., 0, :])
        sel_dep.append(torch.where(ok, torch.gather(dep, -1, i)[..., 0], 0.0))
        sel_val.append(ok)
        near = vnormsq(_comps(pts - p_i)) < r2
        keys = torch.where(near, -torch.inf, keys)
    return (torch.stack(sel_pts, -2), torch.stack(sel_nrm, -2),
            torch.stack(sel_dep, -1), torch.stack(sel_val, -1))


# ---------------------------------------------------------------------------
# All bodies of every world against the mesh
# ---------------------------------------------------------------------------

def mesh_probes(state: WorldState, config: EngineConfig,
                r_mat=None) -> torch.Tensor:
    """(B, N, P, 3) phase-1 probes: each body's center and, with
    ``mesh_probes=3``, the two long-axis extremities of boxes (±R·(half ⊙
    onehot(argmax half))) and capsules (±axis·(h + r)); spheres repeat
    their center."""
    if r_mat is None:
        r_mat = quat_m.to_matrix(state.quat)
    centers = state.pos
    if max(1, int(config.mesh_probes)) == 1:
        return centers[:, :, None, :]
    half = 0.5 * state.size
    ax = torch.argmax(half, dim=-1)                              # (B, N)
    col = torch.gather(r_mat, -1, ax[..., None, None].expand(
        ax.shape + (3, 1)))[..., 0]                              # R[:, ax]
    box_off = col * torch.gather(half, -1, ax[..., None])
    cap_off = r_mat[..., :, 2] * (0.5 * state.size[..., 1]
                                  + state.size[..., 0])[..., None]
    btype = state.body_type
    off = torch.where((btype == int(BodyType.BOX))[..., None], box_off,
                      torch.where((btype == int(BodyType.CAPSULE))[..., None],
                                  cap_off, 0.0))
    return torch.stack([centers, centers + off, centers - off], dim=2)


def mesh_narrowphase(state: WorldState, mesh: TriMesh, config: EngineConfig,
                     contacts_per_body: int = 4):
    """All bodies of every world against the static mesh → flat manifold
    rows ready to append to the pair narrowphase's.

    1. cull: ``config.mesh_probes`` probes per body ride the triangle-tile
       sweep (the ``sphere_mesh_d2_tiles`` kernel on CUDA tensors, one
       launch for the whole batch); the ``CAND_TILES`` nearest tiles by the
       minimum over a body's probes → per-triangle distances → the
       ``CAND_TRIS`` nearest candidate triangles per body;
    2. exact contacts per candidate triangle by body type (sphere: closest
       point; box: ``box_tri_candidates``; capsule:
       ``capsule_tri_candidate``), then a deepest-first, duplicate-
       suppressed k-manifold per body.

    Returns (points (B, N·k, 3), normals (B, N·k, 3), depths (B, N·k),
    a (B, N·k) int32, b (B, N·k) int32, valid (B, N·k)): body = a, mesh
    slot = b, normals a → b.
    """
    from rl_ode_physics_tpu_torch.ops import mesh_kernels

    if mesh.device != state.device:
        raise ValueError(f"mesh on {mesh.device}, state on {state.device}")
    k = contacts_per_body
    bsz, n = state.num_worlds, state.num_slots
    dev = state.device
    f = state.pos.dtype
    nt = mesh.num_tris // MESH_TILE
    kt = min(CAND_TILES, nt)
    ke = CAND_TRIS

    r_mat = quat_m.to_matrix(state.quat)                      # (B, N, 3, 3)
    half = 0.5 * state.size
    r_sph = state.size[..., 0]
    btype = state.body_type
    is_sphere = btype == int(BodyType.SPHERE)
    is_box = btype == int(BodyType.BOX)
    is_capsule = btype == int(BodyType.CAPSULE)

    # ---- phase 1: multi-probe tile distances ---------------------------
    probes = mesh_probes(state, config, r_mat)                # (B, N, P, 3)
    p_cnt = probes.shape[2]
    tile_d2 = mesh_kernels.sphere_mesh_d2_tiles(
        probes.reshape(-1, 3), *mesh.transposed())
    tile_d2 = tile_d2.reshape(bsz, n, p_cnt, nt).amin(2)      # (B, N, NT)
    top_tiles = _top_k_smallest(tile_d2, kt)                  # (B, N, kt)

    tri_feat = torch.cat([mesh.v0, mesh.e1, mesh.e2, mesh.normal], -1)
    feat_k = tri_feat.reshape(nt, MESH_TILE * 12)[top_tiles].reshape(
        bsz, n, kt * MESH_TILE, 12)                           # (B, N, kt·128, 12)

    # per-triangle minimum-over-probes distance on the candidate tiles →
    # the CAND_TRIS nearest (both ends of a long body keep candidates)
    pc = tuple(probes[..., None, c] for c in range(3))        # (B, N, P, 1)
    fk = [tuple(feat_k[:, :, None, :, 3 * j + c] for c in range(3))
          for j in range(3)]                                  # (B, N, 1, kt·128)
    cl = _closest_cm(pc, *fk)
    d2_tri = vnormsq(vsub(cl, pc)).amin(2)                    # (B, N, kt·128)
    del cl, fk
    top_tri = _top_k_smallest(d2_tri, ke)                     # (B, N, ke)
    feat_e = _take(feat_k, top_tri)                           # (B, N, ke, 12)
    del feat_k
    v0_e, e1_e = feat_e[..., 0:3], feat_e[..., 3:6]
    e2_e, n_e = feat_e[..., 6:9], feat_e[..., 9:12]

    # ---- phase 2: exact contacts per body type -------------------------
    centers = state.pos[:, :, None, :]                        # (B, N, 1, 3)
    parts_p, parts_n, parts_d, parts_v = [], [], [], []

    # sphere: exact closest point per candidate triangle
    cl_e = closest_point_triangle(centers, v0_e, e1_e, e2_e)  # (B, N, ke, 3)
    nd = cl_e - centers
    nl = torch.sqrt(vnormsq(_comps(nd)))[..., None]
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f, device=dev)
    nrm_s = torch.where(nl > 1e-6, nd / torch.clamp_min(nl, _EPS), -up)
    dep_s = r_sph[..., None] - nl[..., 0]
    parts_p.append(cl_e)
    parts_n.append(nrm_s)
    parts_d.append(dep_s)
    parts_v.append((dep_s > 0.0) & is_sphere[..., None])

    # box: 17 candidates per triangle, flattened class-major (the corners
    # of all triangles first, then vertices, then edge clips), so that in
    # the deepest-first selection face-support corners win ties by index
    bp, bn, bd, bv = box_tri_candidates(
        centers, r_mat[:, :, None], half[:, :, None], v0_e, e1_e, e2_e, n_e)
    parts_p.append(bp.transpose(2, 3).reshape(bsz, n, ke * 17, 3))
    parts_n.append(bn.transpose(2, 3).reshape(bsz, n, ke * 17, 3))
    parts_d.append(bd.transpose(2, 3).reshape(bsz, n, ke * 17))
    parts_v.append(bv.transpose(2, 3).reshape(bsz, n, ke * 17)
                   & is_box[..., None])

    # capsule: one exact candidate per triangle
    if config.enable_capsules:
        axis_z = r_mat[..., :, 2]
        h_cap = (0.5 * state.size[..., 1])[..., None]
        cap_p0 = state.pos - axis_z * h_cap
        cap_p1 = state.pos + axis_z * h_cap
        cp, cn, cd, cv = capsule_tri_candidate(
            cap_p0[:, :, None], cap_p1[:, :, None], r_sph[..., None],
            v0_e, e1_e, e2_e, n_e)
        parts_p.append(cp)
        parts_n.append(cn)
        parts_d.append(cd)
        parts_v.append(cv & is_capsule[..., None])

    all_p = torch.cat(parts_p, dim=2)
    all_n = torch.cat(parts_n, dim=2)
    all_d = torch.cat(parts_d, dim=2)
    all_v = torch.cat(parts_v, dim=2)
    # sanitize: rows that are not valid may carry ±inf or NaN (slab clips,
    # padded triangles)
    all_v = (all_v & torch.isfinite(all_d)
             & torch.isfinite(all_p).all(-1) & torch.isfinite(all_n).all(-1))
    all_d = torch.where(all_v, all_d, 0.0)
    all_p = torch.where(all_v[..., None], all_p, 0.0)
    all_n = torch.where(all_v[..., None], all_n, 0.0)

    # per-body duplicate-suppressed deepest-k manifold; the dedup radius
    # scales with body size (shared mesh features repeat across triangles)
    char = torch.where(is_sphere | is_capsule, r_sph, half.amin(-1))
    dedup_r = torch.clamp_min(0.25 * char, 1e-4)
    pts_f, nrm_f, dep_f, val_f = _dedup_deepest_k(
        all_p, all_n, all_d, all_v, k, dedup_r)

    eligible = (state.active & ~state.is_static
                & (state.inv_mass > 0))[..., None]
    val_f = val_f & eligible

    a = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        k).expand(bsz, n * k)
    b = torch.full((bsz, n * k), mesh.slot, dtype=torch.int32, device=dev)
    return (pts_f.reshape(bsz, n * k, 3), nrm_f.reshape(bsz, n * k, 3),
            dep_f.reshape(bsz, n * k), a, b, val_f.reshape(bsz, n * k))
