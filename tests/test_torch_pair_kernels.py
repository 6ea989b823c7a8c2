"""The port's pair kernels against the JAX package's, on random pairs.

Every new component-major kernel (capsule and plane pairs), ``collide_pair``
for all nine type pairs at K = 8, 4 and 2 (box-box with and without the
exact clip), the full dispatch table, and the box-box clipping helpers.
Inputs: 256 pairs a type pair, from numpy with a seed; half the pairs of
mixed types come in the swapped order, so that canonicalization and the
normal flip are exercised. Tolerances: point, normal and depth within
rtol 1e-5, atol 1e-5 on valid slots; validity exact except where
|depth| < 1e-6 (a grazing slot, whose sign roundoff decides); clipped
vertices within 1e-6 and their validity exact.

One input class is ill-conditioned by nature: two near-parallel capsule
segments have their closest points anywhere along their common range, so
where the points fall along the axis amplifies the last bit of every
input (XLA fuses multiply-adds on the CPU, PyTorch rounds each operation)
by about 1/sin² of their angle. Their normal, depth and validity are
held as above; their points are held only where the pair is not
near-parallel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu.ops import narrowphase_cm as jax_cm
from rl_ode_physics_tpu_torch.core.config import EngineConfig as TorchConfig
from rl_ode_physics_tpu_torch.ops import pair_kernels as t_pk
from rl_ode_physics_tpu_torch.ops import narrowphase_cm as t_cm

PAIRS = 256
RTOL = ATOL = 1e-5
GRAZE = 1e-6
TYPES = {"sphere": 1, "box": 2, "capsule": 3, "plane": 4}
KINDS = ["sphere_sphere", "sphere_box", "sphere_capsule", "sphere_plane",
         "box_box", "box_capsule", "box_plane", "capsule_capsule",
         "capsule_plane"]


def _sizes(rng, kind, p):
    if kind == "sphere":
        return np.stack([rng.uniform(0.2, 0.5, p), np.zeros(p), np.zeros(p)])
    if kind == "box":
        return rng.uniform(0.3, 1.0, size=(3, p))
    if kind == "capsule":
        return np.stack([rng.uniform(0.15, 0.35, p), rng.uniform(0.3, 1.2, p),
                         np.zeros(p)])
    return np.zeros((3, p))


def _unit_quats(rng, p):
    q = rng.normal(size=(4, p))
    return q / np.linalg.norm(q, axis=0)


def random_pairs(kind, seed, p=PAIRS):
    """(pa, qa, sa, pb, qb, sb) as (3 or 4, P) float32 planes, body A of
    the kind's first type: overlapping or near pairs in random poses. Half
    of the capsule-capsule pairs are turned 1.5 degrees from each other:
    near-parallel capsules, where the second contact appears (exactly
    parallel segments have no unique closest points, so roundoff would
    pick them)."""
    rng = np.random.default_rng(seed)
    ta, tb = kind.split("_")
    pa = rng.uniform(-1.0, 1.0, size=(3, p))
    pb = pa + rng.uniform(-0.9, 0.9, size=(3, p))
    qa, qb = _unit_quats(rng, p), _unit_quats(rng, p)
    if kind == "capsule_capsule":
        axis = rng.normal(size=(3, p))
        axis /= np.linalg.norm(axis, axis=0)
        half = np.radians(1.5) / 2
        turn = np.concatenate([np.full((1, p), np.cos(half)),
                               np.sin(half) * axis])
        w0, v0 = turn[0], turn[1:]
        w1, v1 = qa[0], qa[1:]
        near = np.concatenate([[w0 * w1 - np.sum(v0 * v1, 0)],
                               w0 * v1 + w1 * v0 + np.cross(v0, v1, axis=0)])
        qb[:, : p // 2] = near[:, : p // 2]
    return [a.astype(np.float32)
            for a in (pa, qa, _sizes(rng, ta, p), pb, qb, _sizes(rng, tb, p))]


def _assert_slots_match(ref, got, point_rows=None):
    """ref, got: (point (P, .., 3), normal, depth, valid) of one manifold
    slot or a stack of them, as numpy; ``point_rows`` (P,) bool: the pairs
    whose points are held (default all)."""
    rp, rn, rd, rv = ref
    gp, gn, gd, gv = got
    graze = np.abs(rd) < GRAZE
    assert np.array_equal(rv | graze, gv | graze), "validity differs"
    both = rv & gv
    held = both.copy()
    if point_rows is not None:
        held &= point_rows.reshape((-1,) + (1,) * (both.ndim - 1))
    for r, g, name, where in ((rp, gp, "point", held),
                              (rn, gn, "normal", both),
                              (rd, gd, "depth", both)):
        np.testing.assert_allclose(g[where], r[where], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    return int(rv.sum())


def _not_near_parallel(kind):
    """The pairs of ``random_pairs(kind)`` whose points are held."""
    rows = np.ones(PAIRS, bool)
    if kind == "capsule_capsule":
        rows[: PAIRS // 2] = False
    return rows


# ---------------------------------------------------------------------------
# Component-major kernels
# ---------------------------------------------------------------------------

CM_KERNELS = {
    "sphere_capsule": "cm_sphere_capsule", "sphere_plane": "cm_sphere_plane",
    "box_capsule": "cm_box_capsule", "box_plane": "cm_box_plane",
    "capsule_capsule": "cm_capsule_capsule",
    "capsule_plane": "cm_capsule_plane",
}


def _cm_slots_numpy(slots, torch_side):
    out = []
    for p, n, d, v in slots:
        conv = ((lambda x: x.numpy()) if torch_side else np.asarray)
        out.append((np.stack([conv(c) for c in p], -1),
                    np.stack([conv(c) for c in n], -1), conv(d), conv(v)))
    return out


@pytest.mark.parametrize("kind", list(CM_KERNELS))
def test_cm_kernel_matches(kind):
    arrays = random_pairs(kind, seed=len(kind))
    j_args = [tuple(jnp.asarray(r) for r in a) for a in arrays]
    t_args = [tuple(torch.from_numpy(r.copy()) for r in a) for a in arrays]
    ref = _cm_slots_numpy(getattr(jax_cm, CM_KERNELS[kind])(*j_args), False)
    got = _cm_slots_numpy(getattr(t_cm, CM_KERNELS[kind])(*t_args), True)
    assert len(ref) == len(got)
    rows = _not_near_parallel(kind)
    n_valid = sum(_assert_slots_match(r, g, rows) for r, g in zip(ref, got))
    assert n_valid > 20
    if kind == "capsule_capsule":                 # the parallel second slot
        assert ref[1][3].sum() > 10


def test_cm_capsule_on_box_matches_swapped():
    """cm_capsule_box with the capsule as side A, the form the box-capsule
    kernel calls swapped."""
    pa, qa, sa, pb, qb, sb = random_pairs("capsule_box", seed=3)
    args = (pa, qa, sa, pb, qb, sb)
    ref = _cm_slots_numpy(jax_cm.cm_capsule_box(
        *[tuple(jnp.asarray(r) for r in a) for a in args]), False)
    got = _cm_slots_numpy(t_cm.cm_capsule_box(
        *[tuple(torch.from_numpy(r.copy()) for r in a) for a in args]), True)
    assert sum(_assert_slots_match(r, g) for r, g in zip(ref, got)) > 20


@pytest.mark.parametrize("pair", [(2, 2), (2, 4)], ids=["box_box", "box_plane"])
def test_cm_fold_matches(pair):
    kind = "box_box" if pair == (2, 2) else "box_plane"
    arrays = random_pairs(kind, seed=11)
    j_args = [tuple(jnp.asarray(r) for r in a) for a in arrays]
    t_args = [tuple(torch.from_numpy(r.copy()) for r in a) for a in arrays]
    j_kernel, t_kernel = jax_cm._CM_KERNELS[pair], t_cm._CM_KERNELS[pair]
    assert t_cm._FOLD_PAIRING[pair] == jax_cm._FOLD_PAIRING[pair]
    ref = _cm_slots_numpy(jax_cm._fold_slots(
        j_kernel(*j_args), jax_cm._FOLD_PAIRING[pair]), False)
    got = _cm_slots_numpy(t_cm._fold_slots(
        t_kernel(*t_args), t_cm._FOLD_PAIRING[pair]), True)
    assert sum(_assert_slots_match(r, g) for r, g in zip(ref, got)) > 20


# ---------------------------------------------------------------------------
# Row-major kernels through collide_pair
# ---------------------------------------------------------------------------

def _row_inputs(kind, seed, swap_half=True):
    """Row-major (P, ·) inputs of collide_pair: positions, quats, type
    codes, sizes of both sides; half of the mixed pairs swapped."""
    pa, qa, sa, pb, qb, sb = [a.T.copy() for a in random_pairs(kind, seed)]
    ta_name, tb_name = kind.split("_")
    ta = np.full(PAIRS, TYPES[ta_name], np.int32)
    tb = np.full(PAIRS, TYPES[tb_name], np.int32)
    if swap_half and ta_name != tb_name:
        s = np.arange(PAIRS) % 2 == 1
        pa[s], pb[s] = pb[s].copy(), pa[s].copy()
        qa[s], qb[s] = qb[s].copy(), qa[s].copy()
        sa[s], sb[s] = sb[s].copy(), sa[s].copy()
        ta[s], tb[s] = tb[s].copy(), ta[s].copy()
    return pa, qa, ta, sa, pb, qb, tb, sb


@functools.lru_cache(maxsize=None)
def _jax_collide(kind, k, exact):
    """A jitted, vmapped JAX collide_pair with one kernel (or, kind None,
    the whole table)."""
    table = jax_np._enabled_kernels(JaxConfig(exact_box_clip=exact))
    kernels = (table if kind is None else
               {key: v for key, v in table.items()
                if key == tuple(TYPES[t] for t in kind.split("_"))})
    return jax.jit(jax.vmap(
        lambda *a: jax_np.collide_pair(*a, k, kernels)))


def _torch_collide(kind, k, exact, inputs):
    table = t_pk._enabled_kernels(TorchConfig(exact_box_clip=exact))
    kernels = (table if kind is None else
               {key: v for key, v in table.items()
                if key == tuple(TYPES[t] for t in kind.split("_"))})
    return t_pk.collide_pair(*[torch.from_numpy(x) for x in inputs], k,
                             kernels)


def _assert_manifolds_match(ref, got, point_rows=None):
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in got]
    assert [x.shape for x in ref] == [x.shape for x in got]
    return _assert_slots_match(ref, got, point_rows)


CASES = ([(kind, k, False) for kind in KINDS for k in (8, 4, 2)]
         + [("box_box", k, True) for k in (8, 4, 2)])


@pytest.mark.parametrize("kind,k,exact", CASES,
                         ids=[f"{c[0]}-K{c[1]}{'-exact' if c[2] else ''}"
                              for c in CASES])
def test_collide_pair_matches(kind, k, exact):
    inputs = _row_inputs(kind, seed=100 + KINDS.index(kind))
    if kind == "box_capsule" and k < 3:
        # three capsule-box slots do not fit in K=2: both packages refuse
        with pytest.raises(Exception):
            _jax_collide(kind, k, exact)(*[jnp.asarray(x) for x in inputs])
        with pytest.raises(ValueError):
            _torch_collide(kind, k, exact, inputs)
        return
    ref = _jax_collide(kind, k, exact)(*[jnp.asarray(x) for x in inputs])
    got = _torch_collide(kind, k, exact, inputs)
    assert _assert_manifolds_match(ref, got, _not_near_parallel(kind)) > 20


@pytest.mark.parametrize("k", [8, 4])
def test_collide_pair_full_table_matches(k):
    """Pairs of every type mixed in one batch through the whole table, as
    the classic narrowphase runs them."""
    parts = [_row_inputs(kind, seed=7 + i) for i, kind in enumerate(KINDS)
             if k >= 3 or kind != "box_capsule"]
    inputs = [np.concatenate(cols) for cols in zip(*parts)]
    rows = np.concatenate([_not_near_parallel(kind) for kind in KINDS
                           if k >= 3 or kind != "box_capsule"])
    ref = _jax_collide(None, k, False)(*[jnp.asarray(x) for x in inputs])
    got = _torch_collide(None, k, False, inputs)
    assert _assert_manifolds_match(ref, got, rows) > 200


def test_enabled_kernels_match_jax():
    for kw in (dict(), dict(enable_capsules=False), dict(enable_planes=False),
               dict(enable_capsules=False, enable_planes=False),
               dict(exact_box_clip=True)):
        ref = jax_np._enabled_kernels(JaxConfig(**kw))
        got = t_pk._enabled_kernels(TorchConfig(**kw))
        assert list(got) == list(ref), kw
        clip = isinstance(got[(2, 2)], functools.partial)
        assert clip == isinstance(ref[(2, 2)], functools.partial), kw
    assert t_pk._KERNEL_K == jax_np._KERNEL_K


# ---------------------------------------------------------------------------
# Box-box clipping helpers
# ---------------------------------------------------------------------------

def _random_quads(seed, p=512):
    """(P, 4, 2) quads and (P,) half-extents: rotated rectangles (the
    incident faces box-box hands over) and arbitrary quads, around and
    across the clip rectangle."""
    rng = np.random.default_rng(seed)
    hx = rng.uniform(0.2, 0.8, p)
    hy = rng.uniform(0.2, 0.8, p)
    ang = rng.uniform(0, 2 * np.pi, p)
    c, s = np.cos(ang), np.sin(ang)
    ex = rng.uniform(0.1, 1.0, p)
    ey = rng.uniform(0.1, 1.0, p)
    centre = rng.uniform(-1.0, 1.0, size=(p, 2))
    corners = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float64)
    local = corners[None] * np.stack([ex, ey], -1)[:, None, :]
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    quads = np.einsum("pij,pkj->pki", rot, local) + centre[:, None, :]
    wild = rng.uniform(-1.2, 1.2, size=(p, 4, 2))
    quads[p // 2:] = wild[p // 2:]
    return (quads.astype(np.float32), hx.astype(np.float32),
            hy.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_quad_to_rect_matches(seed):
    quads, hx, hy = _random_quads(seed)
    ref_v, ref_ok = jax.jit(jax.vmap(jax_np._clip_quad_to_rect))(
        jnp.asarray(quads), jnp.asarray(hx), jnp.asarray(hy))
    got_v, got_ok = t_pk._clip_quad_to_rect(
        torch.from_numpy(quads), torch.from_numpy(hx), torch.from_numpy(hy))
    ref_ok = np.asarray(ref_ok)
    assert np.array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0,
                               atol=1e-6)
    counts = ref_ok.sum(-1)
    # the batch holds clipped polygons of many sizes, none and 8 included
    assert {0, 4, 8} <= set(counts.tolist()) and len(set(counts.tolist())) >= 5


def test_face_candidates_match():
    quads, hx, hy = _random_quads(5)
    ref = jax.jit(jax.vmap(jax_np._face_candidates))(
        jnp.asarray(quads), jnp.asarray(hx), jnp.asarray(hy))
    got = t_pk._face_candidates(torch.from_numpy(quads),
                                torch.from_numpy(hx), torch.from_numpy(hy))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
