"""The plain references against the port's CPU step at a tiny size, the
faults a cell can have coming out as not correct, and the controls."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import tiny_run

CELLS = ("arena64-hb8.settled-8192", "quickstep-f64.stack-1024")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_holds_the_cpu_step(cell):
    numbers, correct, rows, out = tiny_run(cell, worlds=2, warm=8)
    assert correct, rows
    # the run's first call and at least one call of the window, each
    # world of both
    assert numbers["world_calls"] >= 4
    assert out["failed"] == 0


def _program():
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    return make_batched_step_fn


def unchanged(config, **kw):
    """A step that returns its state unchanged."""
    return lambda batch: batch


def half_batch(config, **kw):
    """A step that steps the first half of the batch and leaves the rest
    out, as they were."""
    step = _program()(config, **kw)

    def fn(batch):
        from rl_ode_physics_tpu_torch.parallel.batch import (
            concat_worlds, take_worlds)
        h = batch.num_worlds // 2
        rest = take_worlds(batch, h, batch.num_worlds)
        rest = type(rest)(**{f.name: getattr(rest, f.name).clone()
                             for f in dataclasses.fields(rest)})
        return concat_worlds([step(take_worlds(batch, 0, h)), rest])
    return fn


def altered(config, **kw):
    """A step whose answer is altered where it is produced: one body's
    velocity in every world off by 1 cm/s."""
    step = _program()(config, **kw)

    def fn(batch):
        out = step(batch)
        slot = int(torch.nonzero(out.inv_mass[0] > 0)[0, 0])
        out.linvel[:, slot, 0] += 1e-2
        return out
    return fn


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault):
    _, correct, rows, _ = tiny_run(cell, step_factory=fault, worlds=2,
                                   warm=8)
    assert not correct, rows


def test_float64_control_fails():
    """The program's own float32 path in the float64 cell's place reads
    above the limits."""
    import control
    from benchlib import checks, manifest
    numbers, correct, rows, out = tiny_run("quickstep-f64.stack-1024",
                                           worlds=2, warm=8)
    assert correct, rows
    setup = out["setup"]
    ref = manifest.reference(setup.cfg["reference"])
    ctl = control.control_afters(ref, setup, out["samples"], "cpu")
    got = checks.check(ref, out["samples"], setup, [ctl])[1]
    ok, rows = checks.judge(got, setup.cfg["limits"])
    assert not ok, rows


def test_tf32_control_fails():
    """The arena's reference with TF32 operands in its solver, in the
    program's place, reads above the limits."""
    import control
    from benchlib import checks, manifest
    numbers, correct, rows, out = tiny_run("arena64-hb8.settled-8192",
                                           worlds=2, warm=48)
    assert correct, rows
    setup = out["setup"]
    ref = manifest.reference(setup.cfg["reference"])
    ctl = control.control_afters(ref, setup, out["samples"], "cpu")
    got = checks.check(ref, out["samples"], setup, [ctl])[1]
    ok, rows = checks.judge(got, setup.cfg["limits"])
    assert not ok, rows
