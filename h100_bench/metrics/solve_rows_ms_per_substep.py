"""Solver rows (``pack_solver_inputs`` and the Jacobi planes,
``pgs_inputs`` or ``_build_lcp``): device ms a substep between the
program's stage stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "solve.rows")
