"""Narrowphase (the feature gathers, the pair kernels, the fold and the
emission; the dense manifolds on the dense path): device ms a substep
between the program's stage stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "collide")
