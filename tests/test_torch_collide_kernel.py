"""The classic narrowphase's collide kernel (``ops/collide_kernel.py``,
``csrc/collide_pairs.cu``) against its plain version.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card:

    python -m pytest tests/test_torch_collide_kernel.py -m cuda -q

The tests marked ``cuda`` skip where no card is present. The others run
everywhere: the wrapper's CPU route (the plain version, no launch), the
plain version against ``_collide_rows`` & the candidates' validity bit for
bit, and the wrapper's refusals.

Inputs: 256 numpy-seeded pairs of each of the nine type pairs (as
``test_torch_pair_kernels.py`` draws them: overlapping or near pairs in
random poses, half of the capsule pairs near-parallel), half of the mixed
pairs in the swapped order, spread over 4 worlds in a shuffled candidate
order, with invalid candidate slots and pairs of a NULL or TRIMESH body
among them; and BASELINE config 2's worlds (``capsule_stack_world``)
mid-fall and settled through ``narrowphase()``.

Tolerances: on every valid candidate slot the kernel's points, normals,
depths and validity equal the plain version's on the card bit for bit, in
float64 and float32, at k = 8, 4, 2 and 1, with and without the exact
clip. The kernel rounds each operation once in the plain version's order
(``-fmad=false``; ``fma`` where the plain version calls
``torch.addcmul``), and sums each 3-vector in the order PyTorch's CUDA
reduction takes. On an invalid candidate slot, or a pair no enabled kernel
covers, the kernel stores zeros and valid = false; the plain version
leaves what its kernels computed there, valid = false. ``narrowphase()``'s
``Contacts`` are the plain path's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, bench_config
from rl_ode_physics_tpu_torch.ops import broadphase, collide_kernel
from rl_ode_physics_tpu_torch.ops import narrowphase as nph
from rl_ode_physics_tpu_torch.ops import pair_kernels as pk
from rl_ode_physics_tpu_torch.utils import bounds

PAIRS = 256
CPU_PAIRS = 32      # a type pair on the CPU, where the plain version runs
WORLDS = 4
TYPES = {"sphere": 1, "box": 2, "capsule": 3, "plane": 4}
KINDS = ["sphere_sphere", "sphere_box", "sphere_capsule", "sphere_plane",
         "box_box", "box_capsule", "box_plane", "capsule_capsule",
         "capsule_plane"]
DTYPES = {"float64": torch.float64, "float32": torch.float32}
NULL, TRIMESH = 0, 5


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")


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
    """(pa, qa, sa, pb, qb, sb) as (P, 3 or 4) float64 rows, body A of the
    kind's first type; half of the capsule-capsule pairs turned 1.5
    degrees from each other."""
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
    return [a.T.copy() for a in (pa, qa, _sizes(rng, ta, p), pb, qb,
                                 _sizes(rng, tb, p))]


def _rows(pos, quat, size, code):
    return np.concatenate([pos, quat, size,
                           np.full((len(pos), 1), float(code))], 1)


def pair_table(kinds, seed, dtype, worlds=WORLDS, extra=16, p=PAIRS):
    """A (B, N, 11) feature table and its (B, CP) candidate list on the
    CPU: the pairs of ``kinds`` (``random_pairs``), half of the mixed pairs
    with the higher type code first, dealt round-robin to ``worlds``
    worlds; then per world ``extra`` invalid slots on random bodies and
    ``extra`` valid slots that pair a body with a NULL or a TRIMESH body;
    each world's slots shuffled."""
    rng = np.random.default_rng(seed)
    firsts, seconds = [], []
    for i, kind in enumerate(kinds):
        pa, qa, sa, pb, qb, sb = random_pairs(kind, seed + 17 * i, p)
        ta, tb = (TYPES[t] for t in kind.split("_"))
        a, b = _rows(pa, qa, sa, ta), _rows(pb, qb, sb, tb)
        if ta != tb:
            s = np.arange(len(a)) % 2 == 1
            a[s], b[s] = b[s].copy(), a[s].copy()
        firsts.append(a)
        seconds.append(b)
    first, second = np.concatenate(firsts), np.concatenate(seconds)
    per = len(first) // worlds
    bodies = 2 * per + 2
    feats = np.zeros((worlds, bodies, 11))
    cp = per + 2 * extra
    ia = np.zeros((worlds, cp), np.int32)
    ib = np.zeros((worlds, cp), np.int32)
    valid = np.zeros((worlds, cp), bool)
    for w in range(worlds):
        take = np.arange(w, len(first), worlds)[:per]
        feats[w, 0:2 * per:2] = first[take]
        feats[w, 1:2 * per:2] = second[take]
        feats[w, 2 * per] = _rows(np.zeros((1, 3)), [[1.0, 0, 0, 0]],
                                  np.zeros((1, 3)), NULL)[0]
        feats[w, 2 * per + 1] = _rows(np.zeros((1, 3)), [[1.0, 0, 0, 0]],
                                      np.zeros((1, 3)), TRIMESH)[0]
        slots_a = list(range(0, 2 * per, 2))
        slots_b = list(range(1, 2 * per, 2))
        flags = [True] * per
        for j in range(extra):
            slots_a.append(int(rng.integers(2 * per)))
            slots_b.append(int(rng.integers(2 * per)))
            flags.append(False)
            slots_a.append(int(rng.integers(2 * per)))
            slots_b.append(2 * per + j % 2)
            flags.append(True)
        order = rng.permutation(cp)
        ia[w] = np.asarray(slots_a)[order]
        ib[w] = np.asarray(slots_b)[order]
        valid[w] = np.asarray(flags)[order]
    return (torch.from_numpy(feats).to(dtype), torch.from_numpy(ia),
            torch.from_numpy(ib), torch.from_numpy(valid))


def _config(k=8, exact=False, **kw):
    return EngineConfig(max_contacts_per_pair=k, exact_box_clip=exact, **kw)


def _fits(config, k):
    """Whether every enabled kernel's manifold fits in k slots (the plain
    version raises otherwise)."""
    return pk.manifolds_fit(pk._enabled_kernels(config), k)


def on_valid(manifold, valid):
    """The manifold's (points, normals, depths, valid) on the valid
    candidate slots."""
    return [m[valid] for m in manifold]


def assert_same(got, want, valid, what=""):
    """The kernel's manifold equals the plain version's on every valid
    candidate slot, bit for bit (-0 and +0 alike), and is zero and not
    valid on the others."""
    for name, g, w in zip(("points", "normals", "depths", "valid"),
                          on_valid(got, valid), on_valid(want, valid)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if not torch.equal(g, w):
            bad = (g != w) if g.dtype == torch.bool else ~(g == w)
            raise AssertionError(
                f"{what} {name}: {int(bad.sum())} of {g.numel()} differ")
    for m in got:
        assert not m[~valid].any(), (what, "an invalid slot is not zero")


# ---------------------------------------------------------------------------
# CPU: the plain route and the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_tensors_take_plain_version_without_launch(dtype):
    feats, ia, ib, valid = pair_table(KINDS, 3, DTYPES[dtype], p=CPU_PAIRS)
    config = _config(8, exact=True)
    before = collide_kernel.collide_pairs.launches
    got = collide_kernel.collide_pairs(feats, ia, ib, valid, 8, config)
    assert collide_kernel.collide_pairs.launches == before
    want = collide_kernel.collide_pairs_plain(feats, ia, ib, valid, 8, config)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[3].sum()) > 60


CPU_CASES = [(8, False, {}), (8, True, {}), (4, False, {}), (4, True, {}),
             (2, True, dict(enable_capsules=False)),
             (1, False, dict(enable_capsules=False)),
             (8, True, dict(enable_planes=False))]


@pytest.mark.parametrize("k,exact,kw", CPU_CASES,
                         ids=[f"K{k}{'-exact' if e else ''}-{len(kw)}"
                              for k, e, kw in CPU_CASES])
def test_plain_version_is_collide_rows_and_candidate_validity(k, exact, kw):
    """Today's classic collide, ``_collide_rows`` on the gathered rows and
    ``& cand.valid``, bit for bit."""
    feats, ia, ib, valid = pair_table(KINDS, 5, torch.float64, p=CPU_PAIRS)
    config = _config(k, exact, **kw)
    want = pk._collide_rows(pk._gather_rows(feats, ia),
                            pk._gather_rows(feats, ib), k,
                            pk._enabled_kernels(config))
    want = want[:3] + (want[3] & valid[..., None],)
    got = collide_kernel.collide_pairs(feats, ia, ib, valid, k, config)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[3][~valid].any()


def test_enabled_bits_follow_the_pair_table():
    assert collide_kernel.enabled_bits(_config()) == 0b111111111
    no_caps = collide_kernel.enabled_bits(_config(enable_capsules=False))
    assert no_caps == sum(1 << i for i, pair in enumerate(pk._PAIR_KERNELS)
                          if 3 not in pair)
    no_planes = collide_kernel.enabled_bits(_config(enable_planes=False))
    assert no_planes == sum(1 << i for i, pair in enumerate(pk._PAIR_KERNELS)
                            if 4 not in pair)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_manifolds_fit_is_what_the_plain_kernels_accept(k):
    """``manifolds_fit`` says of each enabled kernel alone whether the
    plain version gives its manifold at k slots or raises."""
    feats, ia, ib, valid = pair_table(KINDS, 2, torch.float64, extra=2, p=8)
    for pair, kernel in pk._enabled_kernels(_config(k)).items():
        fits = pk.manifolds_fit({pair: kernel}, k)
        try:
            pk._collide_rows(pk._gather_rows(feats, ia),
                             pk._gather_rows(feats, ib), k, {pair: kernel})
        except ValueError:
            assert not fits, (pair, k)
        else:
            assert fits, (pair, k)


def test_collide_bound_counts_hbm_bytes():
    """At the quickstep-f64 stack's shape: 9 bytes of indices and validity
    and 456 of manifold a slot, and the feature table once."""
    got = bounds.collide_bound(1024, 68, 256, 8, torch.float64)
    hbm = 1024 * 256 * (9 + 456) + 1024 * 68 * 11 * 8
    assert got["bytes"] == hbm and got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(hbm / 3.35e12 * 1e3)
    assert 0.038 < got["bound_ms"] < 0.039
    f32 = bounds.collide_bound(1024, 68, 256, 4, torch.float32)
    assert f32["bytes"] == 1024 * 256 * (9 + 4 * 29) + 1024 * 68 * 11 * 4


def _bad_inputs(case):
    feats, ia, ib, valid = pair_table(["box_box"], 1, torch.float64, extra=2,
                                      p=8)
    k, config = 8, _config()
    if case == "mixed_device":
        ia = torch.empty(ia.shape, dtype=ia.dtype, device="meta")
    elif case == "feats_dtype":
        feats = feats.half()
    elif case == "index_dtype":
        ib = ib.long()
    elif case == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif case == "feats_width":
        feats = feats[..., :10].contiguous()
    elif case == "batch":
        feats = feats[:2]
    elif case == "candidate_shape":
        ib = ib[:, :-1].contiguous()
    elif case == "non_contiguous":
        feats = feats.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "non_contiguous_index":
        ia = ia.t().contiguous().t()
    elif case == "k0":
        k = 0
    elif case == "k9":
        k, config = 9, _config(9)
    elif case == "capsule_k2":
        k, config = 2, _config(2)
    return feats, ia, ib, valid, k, config


BAD = {"mixed_device": ValueError, "feats_dtype": TypeError,
       "index_dtype": TypeError, "valid_dtype": TypeError,
       "feats_width": ValueError, "batch": ValueError,
       "candidate_shape": ValueError, "non_contiguous": ValueError,
       "non_contiguous_index": ValueError, "k0": ValueError,
       "k9": ValueError, "capsule_k2": ValueError}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses(case):
    feats, ia, ib, valid, k, config = _bad_inputs(case)
    before = collide_kernel.collide_pairs.launches
    with pytest.raises(BAD[case]):
        collide_kernel.collide_pairs(feats, ia, ib, valid, k, config)
    assert collide_kernel.collide_pairs.launches == before


def test_classic_narrowphase_calls_the_wrapper(monkeypatch):
    """``narrowphase()`` computes its manifolds through
    ``collide_kernel.collide_pairs`` once, with the config's K."""
    from rl_ode_physics_tpu_torch.models.scenes import capsule_stack_world
    config = EngineConfig.conformance(max_bodies=68, max_pair_candidates=256,
                                      max_contacts=256)
    state = capsule_stack_world(config, seed=7, device="cpu")
    calls = []
    real = collide_kernel.collide_pairs

    def spy(feats, ia, ib, valid, k, cfg):
        calls.append(k)
        return real(feats, ia, ib, valid, k, cfg)

    monkeypatch.setattr(collide_kernel, "collide_pairs", spy)
    cand = broadphase.broadphase(state, config)
    contacts = nph.narrowphase(state, cand, config)
    assert calls == [8]
    assert int(contacts.count.sum()) > 0


# ---------------------------------------------------------------------------
# The card: the kernel against the plain version
# ---------------------------------------------------------------------------

def _on_card(tensors):
    return [t.cuda() for t in tensors]


def _both(feats, ia, ib, valid, k, config):
    args = _on_card((feats, ia, ib, valid))
    before = collide_kernel.collide_pairs.launches
    got = collide_kernel.collide_pairs(*args, k, config)
    assert collide_kernel.collide_pairs.launches == before + 1
    want = collide_kernel.collide_pairs_plain(*args, k, config)
    torch.cuda.synchronize()
    return got, want, args[3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_card_kernel_matches_plain_each_pair(kind, dtype):
    """Each type pair alone, at k = 8, 4, 2 and 1 where its manifold fits,
    box-box with and without the exact clip."""
    _require_card()
    feats, ia, ib, valid = pair_table([kind], 11, DTYPES[dtype])
    live = 0
    for k in (8, 4, 2, 1):
        for exact in ((False, True) if kind == "box_box" else (False,)):
            config = _config(k, exact)
            if not _fits(config, k):
                config = _config(k, exact, enable_capsules=False)
                if "capsule" in kind:
                    continue
            got, want, cvalid = _both(feats, ia, ib, valid, k, config)
            assert_same(got, want, cvalid, f"{kind} {dtype} K={k} {exact}")
            live += int(want[3].sum())
    assert live > 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,exact,kw", CPU_CASES,
                         ids=[f"K{k}{'-exact' if e else ''}-{len(kw)}"
                              for k, e, kw in CPU_CASES])
def test_card_kernel_matches_plain_mixed(k, exact, kw, dtype):
    """All nine type pairs mixed in one candidate list with invalid slots,
    NULL and TRIMESH pairs, and (``kw``) the capsule or plane kernels
    disabled: a disabled pair stores zeros and is not valid."""
    _require_card()
    feats, ia, ib, valid = pair_table(KINDS, 23, DTYPES[dtype])
    config = _config(k, exact, **kw)
    got, want, cvalid = _both(feats, ia, ib, valid, k, config)
    assert_same(got, want, cvalid, f"mixed {dtype} K={k} {exact} {kw}")
    assert int(want[3].sum()) > 300


def _stack_batch(dtype, worlds=8, substeps=0):
    """``worlds`` capsule-stack worlds (seeds 0, 1, ...) on the card under
    the quickstep-f64 engine fields, stepped ``substeps``."""
    from rl_ode_physics_tpu_torch.models.scenes import capsule_stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import (
        concat_worlds, make_batched_step_fn)
    config = EngineConfig.conformance(max_bodies=68, max_pair_candidates=256,
                                      max_contacts=256, dtype=dtype)
    batch = concat_worlds([capsule_stack_world(config, seed=s, device="cuda")
                           for s in range(worlds)])
    if substeps:
        batch = make_batched_step_fn(config, substeps=substeps,
                                     device="cuda")(batch)
    return config, batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("substeps", [300, 720], ids=["mid_fall", "settled"])
def test_card_stack_contacts_are_the_plain_paths(substeps, dtype,
                                                 monkeypatch):
    """``narrowphase()`` on BASELINE config 2's worlds: the kernel's
    ``Contacts`` equal those of the plain path bit for bit."""
    _require_card()
    config, batch = _stack_batch(dtype, substeps=substeps)
    cand = broadphase.broadphase(batch, config)
    before = collide_kernel.collide_pairs.launches
    got = nph.narrowphase(batch, cand, config)
    assert collide_kernel.collide_pairs.launches == before + 1
    monkeypatch.setattr(collide_kernel, "collide_pairs",
                        collide_kernel.collide_pairs_plain)
    want = nph.narrowphase(batch, cand, config)
    torch.cuda.synchronize()
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        assert torch.equal(g, w), field.name
    assert int(want.count.sum()) > 50


@pytest.mark.cuda
def test_card_classic_step_launches_once_a_substep():
    """The classic step of the quickstep-f64 engine fields, graphed, two
    substeps a replay: the kernel is credited once a substep."""
    _require_card()
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    config, batch = _stack_batch("float64", worlds=4)
    fn = make_batched_step_fn(config, substeps=2, unroll=2, device="cuda")
    batch = fn(batch)                        # captures
    assert fn.graphed
    before = collide_kernel.collide_pairs.launches
    for _ in range(5):
        batch = fn(batch)
    torch.cuda.synchronize()
    assert collide_kernel.collide_pairs.launches == before + 10


@pytest.mark.cuda
def test_card_typed_arena_step_never_launches_it(monkeypatch):
    """The arena's typed step does not call the classic narrowphase: no
    launch, and a second capture of the step with ``collide_pairs`` made
    to raise succeeds with the same nodes as the first."""
    _require_card()
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    config = bench_config(64)
    world = scenes.bench_world(config, device="cuda")

    def graph_nodes():
        batch = replicate(world, 64, device="cuda")
        fn = make_batched_step_fn(config, substeps=2, unroll=2,
                                  device="cuda")
        for _ in range(3):
            batch = fn(batch)
        torch.cuda.synchronize()
        assert fn.graphed
        return [n for c in fn.graphs.captures.values()
                for n in c.nodes().values()]

    before = collide_kernel.collide_pairs.launches
    nodes = graph_nodes()
    assert collide_kernel.collide_pairs.launches == before

    def refuse(*args):
        raise AssertionError("the typed step reached collide_pairs")

    monkeypatch.setattr(collide_kernel, "collide_pairs", refuse)
    assert nodes and graph_nodes() == nodes
