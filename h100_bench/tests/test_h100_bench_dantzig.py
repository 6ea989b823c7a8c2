"""The ``dantzig-f64`` configuration's plain reference (the frozen Dantzig
referee) against the port's CPU step at a tiny size, the faults a cell can
have coming out as not correct, and the float32 control."""

from __future__ import annotations

import pytest

from conftest import tiny_run
from test_h100_bench_reference import altered, half_batch, unchanged

CELL = "dantzig-f64.stack-1024"


def test_reference_holds_the_cpu_step():
    numbers, correct, rows, out = tiny_run(CELL, worlds=2, warm=8)
    assert correct, rows
    assert numbers["world_calls"] >= 4
    assert out["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    _, correct, rows, _ = tiny_run(CELL, step_factory=fault, worlds=2,
                                   warm=8)
    assert not correct, rows


def test_float32_control_fails():
    """The program's own float32 DANTZIG step in the float64 cell's place
    reads above the limits."""
    import control
    from benchlib import checks, manifest
    numbers, correct, rows, out = tiny_run(CELL, worlds=2, warm=8)
    assert correct, rows
    setup = out["setup"]
    ref = manifest.reference(setup.cfg["reference"])
    ctl = control.control_afters(ref, setup, out["samples"], "cpu")
    got = checks.check(ref, out["samples"], setup, [ctl])[1]
    ok, rows = checks.judge(got, setup.cfg["limits"])
    assert not ok, rows


def test_reference_raises_on_a_wrong_solve():
    """The referee's KKT self-check: a λ off the solution raises, so a
    reference that went wrong judges nothing correct."""
    import torch
    from benchlib import manifest
    ref = manifest.reference("dantzig_referee")
    a = torch.tensor([[2.0, 0.5, 0.0], [0.5, 1.5, 0.2], [0.0, 0.2, 1.0]],
                     dtype=torch.float64)
    b = torch.tensor([-1.0, 0.3, -0.4], dtype=torch.float64)
    free = torch.tensor([False, False, True])
    lam = ref.solve_lcp(a, b, free)
    assert ref.kkt_residual(a, b, lam, free) <= 1e-14
    with pytest.raises(ArithmeticError):
        ref.check_kkt(a, b, lam + torch.tensor([0.0, 0.0, 1e-3],
                                              dtype=torch.float64), free)
