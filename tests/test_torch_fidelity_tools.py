"""The port's fidelity tools against the JAX package's scripts:
``utils/tpu_default_conformance`` (the shipped throughput policy against
the float64 referee), ``utils/solver_convergence`` and
``utils/manifold_deviation``, on the CPU at small sizes.

Tolerances: the referee trajectory bit for bit (NumPy on both sides, the
initial states bitwise); the conformance script's five numbers within
1e-5 absolute of the JAX script's printed ones and its divergence step
equal; ``solve_err`` within 1e-4 relative; the rotated stack bit for
bit; a 20-step manifold trajectory within 1e-5 (float32 PGS, where XLA
fuses multiply-adds that PyTorch rounds twice).
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu.testing import referee as jax_referee
from rl_ode_physics_tpu_torch.testing import conformance
from rl_ode_physics_tpu_torch.utils import (
    manifold_deviation, solver_convergence, tpu_default_conformance)
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import single_cpu_thread, to_numpy  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# the fewest steps the JAX script runs: its last number is the motion over
# the last 50
STEPS = 50
_NUMBER = r"([-+0-9.e]+)"
_LINE = re.compile(
    rf"max rel pos err = {_NUMBER}, late resting-height err = {_NUMBER} "
    rf"over \d+ steps; first >1cm divergence at step (\d+); "
    rf"sorted-final-heights err = {_NUMBER}; engine end-state motion over "
    rf"last 50 steps = {_NUMBER}")


@pytest.fixture
def benchmarks(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "benchmarks"))
    monkeypatch.syspath_prepend(str(REPO))


def _five(line: str):
    m = _LINE.search(line)
    assert m, line
    err, late, step, heights, motion = m.groups()
    return [float(err), float(late), float(heights), float(motion)], int(step)


def test_tpu_default_conformance_matches_jax(benchmarks, capsys):
    """The JAX script's line and the port's at 50 steps, and the referee
    trajectory of both packages from their (bitwise equal) initial
    states."""
    import tpu_default_conformance as jax_tool
    jax_tool.main(STEPS, "default", "")
    ref = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("[tpu-default-conformance]")]
    got = tpu_default_conformance.main(STEPS, "default", "cpu")
    line = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("[tpu-default-conformance]")]
    assert len(ref) == len(line) == 1
    (ref_nums, ref_step), (got_nums, got_step) = _five(ref[0]), _five(line[0])
    np.testing.assert_allclose(got_nums, ref_nums, rtol=0, atol=1e-5)
    assert got_step == ref_step == got["first_divergence_step"]
    np.testing.assert_allclose(
        [got["max_rel_pos_err"], got["late_height_err"],
         got["sorted_heights_err"], got["late_motion"]], got_nums,
        rtol=5e-4)                         # the printed numbers, 4 digits

    jcfg = JaxConfig.throughput(max_bodies=16, max_pair_candidates=128,
                                max_contacts=256)
    jinit = jax_referee.state_to_numpy(jax_scenes.mini_stack_world(jcfg))
    tinit = conformance.state_to_numpy(conformance.build(
        "mini_stack", tpu_default_conformance.throughput_config(),
        "cpu")[0])
    assert jinit.keys() == tinit.keys()
    for key in jinit:
        assert np.array_equal(jinit[key], tinit[key]), key
    rcfg, w = jax_referee.RefereeConfig(), dict(jinit)
    ref_pos = []
    for _ in range(STEPS):
        w = jax_referee.referee_step(w, rcfg)
        ref_pos.append(w["pos"].copy())
    got_pos, _ = conformance.referee_trajectory(tinit, STEPS)
    assert np.array_equal(got_pos, np.stack(ref_pos))


def test_tpu_default_conformance_refuses_short_runs():
    with pytest.raises(ValueError, match="50"):
        tpu_default_conformance.run(STEPS - 1, device="cpu")


def test_solver_convergence_matches_jax(benchmarks):
    """One seed's state after 5 settle steps (40 substeps) on each side,
    and the solve error of 3 (omega, beta, iters) cases against the
    400-sweep solve."""
    import solver_convergence as jax_tool
    cases = [(1.0, 0.0, 10), (1.3, 0.9, 8), (1.2, 0.45, 15)]
    jcfg = JaxConfig(solver=JaxSolverKind.JACOBI, max_bodies=64,
                     max_pair_candidates=256, max_contacts=128,
                     max_contacts_per_pair=4, enable_capsules=False,
                     enable_planes=False)
    (jstate,) = jax_tool.contact_rich_states(jcfg, seeds=(42,),
                                             settle_steps=5)
    # the script's eager contact phases under one jit: op-by-op dispatch
    # compiles each operation apart
    contacts, s2 = jax.jit(lambda s: (
        jax_tool.nph.narrowphase(s, jax_tool.bp.broadphase(s, jcfg), jcfg),
        jax_tool.integ.apply_external_forces(s, jcfg)))(jstate)
    jref = jax_tool.sol.solve_jacobi(s2, contacts, dataclasses.replace(
        jcfg, solver_iterations=solver_convergence.REFERENCE_ITERATIONS))
    ref = [jax_tool.solve_err(s2, contacts, dataclasses.replace(
        jcfg, jacobi_omega=om, jacobi_beta=b, solver_iterations=it),
        (jref.linvel, jref.angvel)) for om, b, it in cases]

    cfg = solver_convergence.convergence_config()
    states = solver_convergence.contact_rich_states(cfg, seeds=(42,),
                                                    settle_steps=5,
                                                    device="cpu")
    assert len(states) == 1
    np.testing.assert_allclose(bridge.world_to_numpy(states[0], 0)["pos"],
                               to_numpy(jstate)["pos"], rtol=0, atol=1e-5)
    got = solver_convergence.table(states, cfg, cases)
    np.testing.assert_allclose([got[c][0] for c in cases], ref, rtol=1e-4)


def test_rotated_stack_bitwise(benchmarks):
    import manifold_deviation as jax_tool
    for name, cfg in manifold_deviation.variants().items():
        jcfg = JaxConfig(**dict(manifold_deviation.BASE,
                                solver=JaxSolverKind.PGS),
                         exact_box_clip=cfg.exact_box_clip,
                         max_contacts_per_pair=cfg.max_contacts_per_pair)
        ref = to_numpy(jax_tool.rotated_stack(jcfg))
        got = bridge.world_to_numpy(
            manifold_deviation.rotated_stack(cfg, device="cpu"), 0)
        for key in ref:
            assert np.array_equal(got[key], ref[key]), (name, key)


def test_manifold_run_matches_jax(benchmarks):
    """20 steps of the exact-clip variant on both sides, within 1e-5."""
    import manifold_deviation as jax_tool
    cfg = manifold_deviation.variants()["exact"]
    jcfg = JaxConfig(**dict(manifold_deviation.BASE,
                            solver=JaxSolverKind.PGS),
                     exact_box_clip=True, max_contacts_per_pair=8)
    ref, _ = jax_tool.run(jcfg, 20)
    got, _ = manifold_deviation.run(cfg, 20, device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    pairs = manifold_deviation.divergence({"a": got, "b": ref})
    assert pairs[0][:2] == ("a", "b") and pairs[0][2] <= 1e-5
