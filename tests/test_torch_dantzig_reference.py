"""The port's DANTZIG step against the plain float64 reference of ODE's
``dWorldStep`` solve (``testing/dantzig_reference.py``), on the CPU.

- The port's float64 DANTZIG step against the reference's step on small
  seeded rains, within the ``dantzig-f64`` configuration's ``vel_gap``
  and ``pose_gap`` limits.
- The port's pivot loop (``ops/lcp._pivot_solve``, the plain version of
  the hand kernel) against the reference's Dantzig pivoting on the
  seeded systems of ``testing/lcp_systems``.
- The reference's KKT self-check raises on a perturbed λ.
- The solve's device counters on an eager run, and a solve stopped at
  ``MAX_PIVOT_ROUNDS`` counted on ``WorldState.overflow``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch.core import world
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.ops import lcp, lcp_kernel
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.testing import dantzig_reference as D
from rl_ode_physics_tpu_torch.testing import lcp_systems
from rl_ode_physics_tpu_torch.testing import referee as R
from rl_ode_physics_tpu_torch.utils import tracing
from rl_ode_physics_tpu_torch.utils.prng import RandStream

from _threads import single_cpu_thread  # noqa: F401  (autouse)

LIMITS = json.loads((Path(__file__).resolve().parents[1] / "h100_bench"
                     / "configs" / "dantzig-f64.json").read_text())["limits"]
RAIN_SEEDS = (3, 11, 29)
SETTLE = 60


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()


def _config(**kw):
    return EngineConfig.conformance(
        max_bodies=16, max_pair_candidates=64, max_contacts=64,
        dtype="float64", solver=SolverKind.DANTZIG,
        matmul_precision="highest", **kw)


def _small_rain(config, seed: int):
    """The arena and 12 bodies: 11 boxes and spheres at seeded sizes,
    jittered about two layers of a 0.9 m grid 1.0 and 1.9 m up (apart, so
    that none starts inside another), which pile on the floor within
    ``SETTLE`` substeps, and the kinematic player capsule."""
    b = scenes._arena(config, seed)
    rng = RandStream(seed)
    for k in range(11):
        pos = ((k % 3 - 1) * 0.9 + rng.double(-0.05, 0.05),
               1.0 + 0.9 * (k // 6),
               (k // 3 % 2 - 0.5) * 0.9 + rng.double(-0.05, 0.05))
        if rng.randint(0, 2) == 0:
            b.add_body(BodyType.BOX, pos, (rng.double(0.3, 0.8),
                                           rng.double(0.3, 0.8),
                                           rng.double(0.3, 0.8)))
        else:
            b.add_body(BodyType.SPHERE, pos, (rng.double(0.15, 0.4), 0.0,
                                              0.0))
    b.add_body(BodyType.CAPSULE, (0.0, 2.0, -3.0), (0.5, 1.0, 0.0),
               kinematic=True)
    return b.finish("cpu")


def _ref_config(config):
    return R.RefereeConfig(
        dt=config.dt, gravity=config.gravity, erp=config.erp,
        cfm=config.cfm, max_correcting_vel=config.max_correcting_vel,
        bounce=config.bounce, bounce_vel=config.bounce_vel, mu=config.mu,
        friction=config.friction,
        max_contacts_per_pair=config.max_contacts_per_pair)


@pytest.fixture(scope="module")
def settled_rains():
    """Each seed's rain after ``SETTLE`` DANTZIG substeps, two worlds."""
    config = _config()
    out = {}
    for seed in RAIN_SEEDS:
        state = replicate(_small_rain(config, seed), 2, device="cpu")
        for _ in range(SETTLE):
            state = world.step(state, config)
        out[seed] = state
    return config, out


@pytest.mark.parametrize("seed", RAIN_SEEDS)
def test_dantzig_step_matches_the_reference(settled_rains, seed):
    config, states = settled_rains
    state = states[seed]
    before = R.state_to_numpy(state, 0)
    assert len(R._contacts(before, _ref_config(config))) >= 8
    after = state
    ref = before
    for _ in range(2):
        after = world.step(after, config)
        ref = D.step(ref, _ref_config(config))
    got = R.state_to_numpy(after, 0)
    moving = (before["body_type"] != R.NULL) & ~before["is_static"]

    def gap(*names):
        return max(float(np.abs(got[n] - ref[n]).max(-1)[moving].max())
                   for n in names)
    assert gap("linvel", "angvel") <= LIMITS["vel_gap"]
    assert gap("pos", "quat") <= LIMITS["pose_gap"]
    assert int(after.overflow.sum()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pivot_solve_matches_the_reference(seed):
    a, b, valid, is_normal, _ = lcp_systems.random_contact_lcp(
        seed, worlds=3, contacts=16, bodies=24)
    a_t, b_t, v_t, n_t = map(torch.as_tensor, (a, b, valid, is_normal))
    lam, rounds = lcp._pivot_solve(a_t, b_t, v_t, n_t, True)
    assert int(rounds.max()) < lcp.MAX_PIVOT_ROUNDS
    for w in range(3):
        idx = torch.nonzero(v_t[w]).flatten()
        ref = D.solve_lcp(a_t[w][idx][:, idx], b_t[w][idx], ~n_t[w][idx])
        scale = float(ref.abs().max())
        assert float((lam[w][idx] - ref).abs().max()) <= 1e-12 * scale
        # some normal rows left at their bound, some pressed
        normal = n_t[w][idx]
        assert 0 < int((ref[normal] > 0).sum()) < int(normal.sum())


@pytest.mark.parametrize("row", ["free", "normal", "none"])
def test_kkt_check_raises_on_a_perturbed_lambda(row):
    a, b, valid, is_normal, _ = lcp_systems.random_contact_lcp(
        5, worlds=1, contacts=12, bodies=20, live=1.0)
    a_t, b_t = torch.as_tensor(a[0]), torch.as_tensor(b[0])
    free = ~torch.as_tensor(is_normal[0])
    lam = D.solve_lcp(a_t, b_t, free)
    assert D.kkt_residual(a_t, b_t, lam, free) <= 1e-13
    if row == "none":
        D.check_kkt(a_t, b_t, lam, free)
        return
    k = int(torch.nonzero(free if row == "free" else ~free)[0])
    bad = lam.clone()
    bad[k] += 1e-6 * float(lam.abs().max())
    with pytest.raises(ArithmeticError):
        D.check_kkt(a_t, b_t, bad, free)


def _pivot_calls(monkeypatch):
    """Every pivot solve's inputs and outputs, as the step makes them."""
    calls = []
    solve = lcp_kernel.lcp_pivot_solve

    def spy(a_mat, b, valid, is_normal, friction, mu_row=None):
        lam, rounds = solve(a_mat, b, valid, is_normal, friction, mu_row)
        calls.append((valid.clone(), is_normal.clone(), lam.clone(),
                      rounds.clone()))
        return lam, rounds
    monkeypatch.setattr(lcp_kernel, "lcp_pivot_solve", spy)
    return calls


def test_pivot_counters_count_each_world_solve(settled_rains, monkeypatch):
    config, states = settled_rains
    state = states[RAIN_SEEDS[0]]
    calls = _pivot_calls(monkeypatch)
    with tracing.recording("cpu"):
        for _ in range(2):
            state = world.step(state, config)
        c = tracing.read()["counters"]
    vs = [cl[0].sum(1).long() for cl in calls]
    assert c["lcp_valid_rows"] == int(sum(x.sum() for x in vs)) > 0
    assert c["lcp_valid_rows_sq"] == int(sum((x ** 2).sum() for x in vs))
    assert c["lcp_valid_rows_cube"] == int(sum((x ** 3).sum() for x in vs))
    assert c["pivot_rounds"] == int(sum(cl[3].sum() for cl in calls)) > 0
    assert c["pivot_capped"] == 0
    # μ = ∞: every valid friction row and the pressed normal rows
    active = sum(int((valid & (~normal | (lam > 0))).sum())
                 for valid, normal, lam, _ in calls)
    assert c["lcp_active_rows"] == active
    assert 0 < active <= c["lcp_valid_rows"]
    assert c["world_substeps"] == 2 * state.num_worlds


def test_a_capped_solve_counts_on_overflow(settled_rains, monkeypatch):
    config, states = settled_rains
    state = states[RAIN_SEEDS[1]]
    calls = _pivot_calls(monkeypatch)
    assert int(world.step(state, config).overflow.sum()) == 0
    assert int(calls[-1][3].max()) > 1
    monkeypatch.setattr(lcp, "MAX_PIVOT_ROUNDS", 1)
    with tracing.recording("cpu"):
        after = world.step(state, config)
        c = tracing.read()["counters"]
    assert after.overflow.tolist() == [1, 1]
    assert c["pivot_capped"] == 2
    assert c["rows_dropped"] == 0
