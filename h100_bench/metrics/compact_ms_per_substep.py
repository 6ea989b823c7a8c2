"""Contact compaction (the payload packing, its ``cat`` and
``compact_rows``): device ms a substep between the program's stage
stamps. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.stage_ms(ctx, "compact")
