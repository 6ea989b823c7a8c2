"""Solver iterations (the Jacobi loop, ``pgs_solve``, ``lcp_pivot_solve``
and the joint passes): device ms a substep between the program's stage
stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "solve.iterate")
