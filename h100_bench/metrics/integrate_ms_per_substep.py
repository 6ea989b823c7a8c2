"""Integration (the external forces and the position update, with the
graph's write-back of the carry): device ms a substep between the
program's stage stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "forces", "integrate")
