"""Pair phase: the pairs the pair kernels tested, a world a substep
(the program's ``pairs_tested`` counter over ``world_substeps``). Moves
``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.per_world(ctx, "pairs_tested")
