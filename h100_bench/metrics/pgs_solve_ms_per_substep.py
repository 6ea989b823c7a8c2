"""PGS sweeps (``ops.pgs_kernel`` -> ``csrc/pgs_solve.cu``): device ms a
substep of ``pgs_solve_kernel``. Moves ``body_steps_per_s``."""

from _kernels import ms_per_substep


def read(ctx):
    return ms_per_substep(ctx, "pgs_solve_kernel")
