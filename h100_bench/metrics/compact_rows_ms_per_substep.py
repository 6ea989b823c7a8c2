"""Contact compaction (``ops.compaction_kernel`` ->
``csrc/compact_rows.cu``): device ms a substep of ``compact_rows_kernel``.
Moves ``body_steps_per_s``."""

from _kernels import ms_per_substep


def read(ctx):
    return ms_per_substep(ctx, "compact_rows_kernel")
