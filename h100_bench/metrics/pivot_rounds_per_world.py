"""Solver iterations: DANTZIG's pivot rounds a world-solve (the program's
``pivot_rounds`` counter over ``world_substeps``; one solve a world a
substep). Moves ``body_steps_per_s``."""

from _pivot import per_world


def read(ctx):
    return per_world(ctx, "pivot_rounds")
