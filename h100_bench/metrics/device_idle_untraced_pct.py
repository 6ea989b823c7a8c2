"""Device (H100), untraced: the share of the stamped calls' device time
that lies outside the step, from the last stamp of a call to the first of
the next (the harness's own kernels between calls, the host's launch,
idle), with no profiler running. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    rec = stages.program(ctx)
    if rec is None:
        return None
    total = sum(rec["stages_ns"].values())
    return 100.0 * rec["stages_ns"]["outside"] / total if total else None
