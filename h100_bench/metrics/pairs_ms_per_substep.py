"""Pair phase (the broadphase and its candidate compaction, or the typed
paths' eligibility, SAP and bucket compaction): device ms a substep
between the program's stage stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "pairs")
