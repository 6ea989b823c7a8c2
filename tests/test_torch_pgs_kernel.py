"""The PGS kernel's arithmetic on the CPU: ``ops/pgs_kernel.pgs_kernel_order``
(``csrc/pgs_solve.cu``'s loop in PyTorch, on the unpacked row table: the
warp's scan for the live rows, the staged rows, the rows past them read
from the table, a row's bodies held as registers) against the plain
version (``ops/solver.pgs_sweeps_plain``, the Python row loop) and both
against the JAX package's ``solve_pgs`` under ``vmap``.

The inputs are ``test_torch_pgs.py``'s: the settled pile's classic
contacts in two worlds whose velocities differ, cold and warm started,
at μ=∞, finite μ, per-body surfaces and without friction; and the hinge
chain under PGS, joint rows in the sweeps, and its joint passes alone
(DANTZIG's, at ω = 1). Beside them: the scan's order on scattered live
masks against ``nonzero()``, and the kernel's order with each world's
live rows past a small S (S forced through ``staged=``) on a synthetic
table with scattered live rows and live rows whose bodies are one slot
(a = b; the pipelines' live rows have a < b), and on the hinge chain.

Tolerances:
- the kernel's order against the plain version, float32 and float64:
  bitwise. Both round every operation once, in the same order (the
  kernel is built with ``-fmad=false``); a world's skipped dead row is
  the plain loop's ``dλ = 0`` row, which adds ±0.
- against JAX, float32: ``ATOL`` 1e-5, as ``test_torch_pgs.py`` (XLA
  fuses multiply-adds that PyTorch rounds twice, and sequential PGS
  carries each row's roundoff into the next). float64 is held to JAX in
  ``test_torch_x64.py`` (JAX's x64 is process-wide, so it runs there in
  a subprocess); here the kernel's order is held to the plain version in
  float64.

The wrapper's CPU route: a CPU tensor runs the plain version and counts
no launch; a wrong dtype or shape, or tensors on two devices, raise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.ops import broadphase as jax_bp
from rl_ode_physics_tpu.ops import integrator as jax_integrator
from rl_ode_physics_tpu.ops import joints as jax_jt
from rl_ode_physics_tpu.ops import narrowphase as jax_np
from rl_ode_physics_tpu.ops import solver as jax_solver
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.ops import joints as jt
from rl_ode_physics_tpu_torch.ops import pgs_kernel, solver
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    PILE, jax_state, settled_pile, single_cpu_thread, to_numpy)
from test_torch_pgs import CASES, _batch_inputs, _lam0, _ported

ATOL = 1e-5
HINGE_CAPS = dict(max_bodies=16, max_pair_candidates=128, max_contacts=64)
HINGE_SETTLE = 40


def _f64(obj):
    """A dataclass of tensors with every float field in float64."""
    return type(obj)(**{
        f.name: (v.double() if v.is_floating_point() else v)
        for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]})


def _kernel_order(monkeypatch):
    """Route ``solve_pgs`` (and DANTZIG's joint passes) through the
    kernel's order instead of the wrapper."""
    monkeypatch.setattr(pgs_kernel, "pgs_solve", pgs_kernel.pgs_kernel_order)


def _solve(tstate, tcontacts, tcfg, lam0, joints_rows=None):
    return solver.solve_pgs(tstate, tcontacts, tcfg, lam0=lam0,
                            return_lam=True, joints_rows=joints_rows)


def _equal(got, want, what):
    for name, g, w in zip(("linvel", "angvel", "lam"),
                          (got[0].linvel, got[0].angvel, got[1]),
                          (want[0].linvel, want[0].angvel, want[1])):
        assert g.dtype == w.dtype, (what, name)
        assert torch.equal(g, w), (what, name,
                                   float((g - w).abs().max()))


@functools.lru_cache(maxsize=None)
def _case_inputs(case):
    """``_batch_inputs`` of a case, made once for its cold and warm runs."""
    return _batch_inputs(JaxConfig(**PILE, solver=JaxSolverKind.PGS,
                                   **CASES[case]))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_matches_plain_and_jax(case, warm, monkeypatch):
    """float32: the kernel's order bitwise the plain loop, both within
    ``ATOL`` of JAX's ``solve_pgs``; float64: bitwise the plain loop."""
    jcfg = JaxConfig(**PILE, solver=JaxSolverKind.PGS, **CASES[case])
    tcfg = EngineConfig(**PILE, solver=SolverKind.PGS, **CASES[case])
    jstate, jcontacts = _case_inputs(case)
    lam0 = _lam0(jcontacts) if warm else None
    ref, ref_lam = jax.jit(jax.vmap(
        lambda s, c, l0: jax_solver.solve_pgs(s, c, jcfg, lam0=l0,
                                              return_lam=True)))(
        jstate, jcontacts, None if lam0 is None else jnp.asarray(lam0))
    tstate, tcontacts = _ported(jstate, jcontacts)
    tlam0 = None if lam0 is None else torch.from_numpy(lam0)

    plain = _solve(tstate, tcontacts, tcfg, tlam0)
    plain64 = _solve(_f64(tstate), _f64(tcontacts), tcfg,
                     None if tlam0 is None else tlam0.double())
    _kernel_order(monkeypatch)
    order = _solve(tstate, tcontacts, tcfg, tlam0)
    order64 = _solve(_f64(tstate), _f64(tcontacts), tcfg,
                     None if tlam0 is None else tlam0.double())

    _equal(order, plain, "float32")
    _equal(order64, plain64, "float64")
    assert plain64[0].linvel.dtype == torch.float64
    for got in (plain, order):
        for name in ("linvel", "angvel"):
            np.testing.assert_allclose(getattr(got[0], name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref_lam),
                                   atol=ATOL, rtol=0, err_msg="lam")
    # float64 against float32: the same solve to float32 roundoff
    np.testing.assert_allclose(plain64[0].linvel.numpy(),
                               plain[0].linvel.numpy(), atol=ATOL)
    assert float(plain[1].abs().max()) > 0          # the rows did work


@functools.lru_cache(maxsize=None)
def _hinge_inputs():
    """The JAX hinge chain under PGS in two worlds (the second kicked),
    settled ``HINGE_SETTLE`` substeps: its contacts, joint rows and the
    state after external forces, on the JAX side, and the port's joint
    rows of the same state and table."""
    jcfg = JaxConfig(**HINGE_CAPS, solver=JaxSolverKind.PGS)
    tcfg = EngineConfig(**HINGE_CAPS, solver=SolverKind.PGS)
    w, jj = jax_scenes.hinge_chain_scene(jcfg)
    w = jax_make_step_fn(jcfg, substeps=HINGE_SETTLE, donate=False,
                         joints=jj)(w)
    arrays = to_numpy(w)
    batch = {k: np.stack([v, v]) for k, v in arrays.items()}
    dyn = batch["inv_mass"][1] > 0
    kick = np.random.default_rng(2).normal(scale=0.2,
                                           size=batch["linvel"][1].shape)
    batch["linvel"][1] = (batch["linvel"][1]
                          + np.where(dyn[:, None], kick, 0)).astype(np.float32)
    jb = jax_state(batch)
    n = jb.pos.shape[1]

    def prepare(s):
        exclude = jax_jt.connected_mask(jj, n)
        cand = jax_bp.broadphase(s, jcfg, exclude=exclude)
        contacts = jax_np.narrowphase(s, cand, jcfg)
        rows = jax_jt.joint_rows(s, jj, jcfg)
        return jax_integrator.apply_external_forces(s, jcfg), contacts, rows

    js, jc, jrows = jax.jit(jax.vmap(prepare))(jb)
    tj = bridge.joints_from_numpy(to_numpy(jj), device="cpu")
    trows = jt.joint_rows(bridge.world_from_numpy(batch, device="cpu"), tj,
                          tcfg)
    return jcfg, tcfg, (js, jc, jrows), trows


def test_joint_rows_in_the_sweeps(monkeypatch):
    """The hinge chain under PGS, joint rows after each contact sweep:
    the kernel's order bitwise the plain loop in float32 and float64, both
    within ``ATOL`` of JAX's ``solve_pgs(..., joints_rows=...)``."""
    jcfg, tcfg, (js, jc, jrows), trows = _hinge_inputs()
    assert int(np.asarray(jc.count).min()) > 0           # contacts too
    assert bool(trows["live"].any())
    ref, ref_lam = jax.jit(jax.vmap(
        lambda s, c, r: jax_solver.solve_pgs(s, c, jcfg, return_lam=True,
                                             joints_rows=r)))(js, jc, jrows)
    tstate, tcontacts = _ported(js, jc)
    rows64 = {k: (v.double() if v.is_floating_point() else v)
              for k, v in trows.items()}
    plain = _solve(tstate, tcontacts, tcfg, None, trows)
    plain64 = _solve(_f64(tstate), _f64(tcontacts), tcfg, None, rows64)
    _kernel_order(monkeypatch)
    _equal(_solve(tstate, tcontacts, tcfg, None, trows), plain, "float32")
    _equal(_solve(_f64(tstate), _f64(tcontacts), tcfg, None, rows64),
           plain64, "float64")
    for name in ("linvel", "angvel"):
        np.testing.assert_allclose(getattr(plain[0], name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(plain[1].numpy(), np.asarray(ref_lam),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_joint_passes_alone(dtype, monkeypatch):
    """DANTZIG's joint passes (no contact rows, ω = 1, ``solver_iterations``
    passes) through the wrapper's joint-only entry: the kernel's order
    bitwise the plain loop; in float32 within ``ATOL`` of the JAX
    package's loop of ``joint_iteration_seq``."""
    jcfg, tcfg, (js, _, jrows), trows = _hinge_inputs()
    f = getattr(torch, dtype)
    trows = {k: (v.to(f) if v.is_floating_point() else v)
             for k, v in trows.items()}
    vel = torch.from_numpy(np.concatenate(
        [np.asarray(js.linvel), np.asarray(js.angvel)], -1)).to(f)
    params = dict(solver.pgs_params(tcfg), omega=1.0)
    plain = pgs_kernel.pgs_solve(vel, None, None, trows, **params)
    order = pgs_kernel.pgs_kernel_order(vel, None, None, trows, **params)
    assert plain[1] is None and order[1] is None
    assert torch.equal(order[0], plain[0])

    def jax_passes(lin, ang, rows):
        vel8 = jnp.concatenate([lin, ang, jnp.zeros_like(lin[:, :2])], -1)
        lam = jnp.zeros_like(rows["rhs"])
        for _ in range(jcfg.solver_iterations):
            vel8, lam = jax_jt.joint_iteration_seq(
                vel8, rows, lam, 1.0, jcfg.cfm / jcfg.dt)
        return vel8[:, :6]

    if dtype == "float32":
        ref = jax.jit(jax.vmap(jax_passes))(js.linvel, js.angvel, jrows)
        np.testing.assert_allclose(plain[0].numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)
    assert float((plain[0] - vel).abs().max()) > 1e-4    # the rows did work

    # solve() under DANTZIG runs the same entry: the kernel's order there
    # gives the same bits as the plain loop
    dcfg = EngineConfig(**HINGE_CAPS, solver=SolverKind.DANTZIG)
    tstate = bridge.world_from_numpy(to_numpy(js), device="cpu")
    if dtype == "float64":
        tstate = _f64(tstate)
    state = tstate.replace(linvel=vel[..., 0:3].contiguous(),
                           angvel=vel[..., 3:6].contiguous())
    empty = _no_contacts(state)
    want = solver.solve(state, empty, dcfg, trows)
    _kernel_order(monkeypatch)
    got = solver.solve(state, empty, dcfg, trows)
    assert torch.equal(got.linvel, want.linvel)
    assert torch.equal(got.angvel, want.angvel)
    assert torch.equal(want.linvel, plain[0][..., 0:3])


def _no_contacts(state):
    """Contacts of 4 dead rows for every world of ``state``."""
    from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts
    bsz, f = state.num_worlds, state.pos.dtype
    fields = {}
    for field in dataclasses.fields(Contacts):
        if field.name in ("point", "normal"):
            fields[field.name] = torch.zeros((bsz, 4, 3), dtype=f)
        elif field.name in ("depth",):
            fields[field.name] = torch.zeros((bsz, 4), dtype=f)
        elif field.name == "valid":
            fields[field.name] = torch.zeros((bsz, 4), dtype=torch.bool)
        elif field.name in ("count", "overflow"):
            fields[field.name] = torch.zeros((bsz,), dtype=torch.int32)
        else:
            fields[field.name] = torch.zeros((bsz, 4), dtype=torch.int32)
    return Contacts(**fields)


def _small_table(bsz=2, c=5, n=4, f=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn((bsz, c) + shape, generator=gen, dtype=f)

    rows = {k: r(3) for k in ("r_a", "r_b", "n", "t1", "t2")}
    rows.update({k: r().abs() + 1.0 for k in ("d_n", "d_t1", "d_t2",
                                               "inv_m_a", "inv_m_b")})
    rows.update(target=r(), mu=r().abs(), inv_i_a=r(3, 3), inv_i_b=r(3, 3),
                a=torch.randint(0, n, (bsz, c), generator=gen),
                b=torch.randint(0, n, (bsz, c), generator=gen),
                valid=torch.rand((bsz, c), generator=gen) < 0.7)
    vel = torch.randn((bsz, n, 6), generator=gen, dtype=f)
    lam = torch.zeros((bsz, c, 3), dtype=f)
    return vel, lam, rows


PARAMS = dict(iterations=3, omega=1.3, cfm_term=1e-3, mu=0.5)


def test_wrapper_takes_the_plain_version_on_cpu():
    """A CPU tensor runs the plain loop, bit for bit, and counts no
    launch."""
    vel, lam, rows = _small_table()
    before = pgs_kernel.pgs_solve.launches
    got = pgs_kernel.pgs_solve(vel, lam, rows, **PARAMS)
    want = solver.pgs_sweeps_plain(vel, lam, rows, **PARAMS)
    assert pgs_kernel.pgs_solve.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], vel)
    order = pgs_kernel.pgs_kernel_order(vel, lam, rows, **PARAMS)
    assert torch.equal(order[0], want[0]) and torch.equal(order[1], want[1])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    vel, lam, rows = _small_table()
    with pytest.raises(TypeError):
        pgs_kernel.pgs_solve(vel.half(), lam, rows, **PARAMS)
    with pytest.raises(TypeError):
        pgs_kernel.pgs_solve(vel.double(), lam.double(), rows, **PARAMS)
    with pytest.raises(ValueError):
        pgs_kernel.pgs_solve(vel[..., :3], lam, rows, **PARAMS)
    with pytest.raises(ValueError):
        pgs_kernel.pgs_solve(vel, lam[:, :2], rows, **PARAMS)
    with pytest.raises(ValueError):
        pgs_kernel.pgs_solve(vel, None, rows, **PARAMS)
    with pytest.raises(ValueError):
        pgs_kernel.pgs_solve(vel, lam, dict(rows, mu=None),
                             **PARAMS, per_body_surface=True)
    with pytest.raises(ValueError):            # two devices
        pgs_kernel.pgs_solve(vel, lam.to("meta"), rows, **PARAMS)
    with pytest.raises(ValueError):            # not a card, not the CPU
        pgs_kernel.pgs_solve(vel.to("meta"), lam.to("meta"),
                             {k: v.to("meta") for k, v in rows.items()},
                             **PARAMS)
    # a world past max_slots is taken: its velocities stay in device
    # memory, and its share of shared memory holds none of them
    n = pgs_kernel.max_slots(torch.float32) + 1
    big = torch.zeros((vel.shape[0], n, 6))
    big[:, :vel.shape[1]] = vel
    want = solver.pgs_sweeps_plain(big, lam, rows, **PARAMS)
    got = pgs_kernel.pgs_kernel_order(big, lam, rows, **PARAMS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    c = rows["valid"].shape[1]
    assert (pgs_kernel.launch_shape(torch.float32, n, c).shared_bytes
            < pgs_kernel.launch_shape(torch.float32, n - 1, c).shared_bytes)
    assert pgs_kernel.max_slots(torch.float64) == 1024


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staging_order_on_scattered_live_rows(seed):
    """The kernel's scan of the live flags (``live_rows``, 32 flags at a
    time, a prefix popcount a chunk) gives each world's live rows in
    ``valid.nonzero()``'s buffer order, its count, and the first live row
    past the staged ones, on scattered masks (not a prefix) of several
    chunks, at a cap below, at and above the counts."""
    gen = torch.Generator().manual_seed(seed)
    valid = torch.rand((6, 100), generator=gen) < torch.tensor(
        [0.0, 0.05, 0.3, 0.6, 0.95, 1.0])[:, None]
    assert not valid[2].cumprod(0).sum() == valid[2].sum()   # not a prefix
    for cap in (0, 5, 30, 100):
        row, count, past = pgs_kernel.live_rows(valid, cap)
        assert row.shape == (6, cap)
        for w in range(6):
            live = valid[w].nonzero().flatten()
            held = min(cap, len(live))
            assert int(count[w]) == len(live)
            assert torch.equal(row[w, :held], live[:held]), (cap, w)
            assert bool((row[w, held:] == -1).all())
            assert int(past[w]) == (int(live[cap]) if len(live) > cap
                                    else valid.shape[1])


def _stable_table(bsz=3, c=40, n=4, f=torch.float32, seed=0):
    """A synthetic row table whose sweeps stay bounded (each row's d well
    above its couplings), with scattered live rows and live rows whose two
    bodies are one slot (a = b): the pipelines' broadphase pairs have
    a < b, so only such a table has them."""
    vel, lam, rows = _small_table(bsz, c, n, f, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    rows.update({k: rows[k] + 4.0 for k in ("d_n", "d_t1", "d_t2")})
    rows.update({k: 0.3 * rows[k] for k in ("inv_i_a", "inv_i_b")})
    rows["valid"] = torch.rand((bsz, c), generator=gen) < 0.5
    rows["b"][:, ::5] = rows["a"][:, ::5]
    rows["valid"][:, ::5] = True
    lam = torch.where(rows["valid"][..., None], 0.1 * torch.rand(
        (bsz, c, 3), generator=gen, dtype=f), 0.0)
    return vel, lam, rows


@pytest.mark.parametrize("staged", [0, 3, None])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["mu_inf", "mu_finite", "per_body_surface",
                                  "no_friction"])
def test_kernel_order_past_the_staged_rows(case, dtype, staged):
    """The kernel's order with each world's live rows past a small S read
    from the table (S forced to 0 and 3, and the launch's own S) is
    bitwise the plain loop, on a table with scattered live rows and live
    rows with a = b."""
    f = getattr(torch, dtype)
    over = dict(mu_inf={}, mu_finite=dict(mu=0.5),
                per_body_surface=dict(per_body_surface=True),
                no_friction=dict(friction=False))[case]
    params = dict(iterations=4, omega=1.3, cfm_term=1e-3, **over)
    vel, lam, rows = _stable_table(f=f)
    live = rows["valid"]
    assert int(live.sum(1).min()) > 3
    assert bool(((rows["a"] == rows["b"]) & live).any())
    want = solver.pgs_sweeps_plain(vel, lam, rows, **params)
    got = pgs_kernel.pgs_kernel_order(vel, lam, rows, staged=staged,
                                      **params)
    assert bool(torch.isfinite(want[0]).all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[0], vel)


@pytest.mark.parametrize("staged", [0, 3, None])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_joint_order_past_the_staged_rows(dtype, staged):
    """The hinge chain's joint passes alone (ω = 1) with each world's live
    joint rows past a small S_j read from the table, and its joint rows in
    the sweeps past S and S_j: the kernel's order bitwise the plain
    loop."""
    f = getattr(torch, dtype)
    _, tcfg, (js, jc, _), trows = _hinge_inputs()
    trows = {k: (v.to(f) if v.is_floating_point() else v)
             for k, v in trows.items()}
    assert int(trows["live"].sum(1).min()) > 3
    vel = torch.from_numpy(np.concatenate(
        [np.asarray(js.linvel), np.asarray(js.angvel)], -1)).to(f)
    params = dict(solver.pgs_params(tcfg), omega=1.0)
    want = solver.pgs_sweeps_plain(vel, None, None, trows, **params)
    got = pgs_kernel.pgs_kernel_order(vel, None, None, trows,
                                      staged_joints=staged, **params)
    assert got[1] is None and torch.equal(got[0], want[0])
    assert not torch.equal(want[0], vel)

    tstate, tcontacts = _ported(js, jc)
    if dtype == "float64":
        tstate, tcontacts = _f64(tstate), _f64(tcontacts)
    vel, lam, rows = solver.pgs_inputs(tstate, tcontacts, tcfg)
    assert int(rows["valid"].sum(1).min()) > 0
    params = solver.pgs_params(tcfg)
    want = solver.pgs_sweeps_plain(vel, lam, rows, trows, **params)
    got = pgs_kernel.pgs_kernel_order(vel, lam, rows, trows, staged=staged,
                                      staged_joints=staged, **params)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
