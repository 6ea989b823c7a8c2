"""Solver rows: the rows of DANTZIG's last solve that are off their
bounds, a world-solve (the program's ``lcp_active_rows`` counter over
``world_substeps``): the size of the block each pivot round eliminates.
Moves ``body_steps_per_s``."""

from _pivot import per_world


def read(ctx):
    return per_world(ctx, "lcp_active_rows")
