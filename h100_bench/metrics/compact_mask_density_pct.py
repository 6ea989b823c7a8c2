"""Contact compaction: the set share of the mask handed to the row
compaction (the program's ``candidate_rows`` counter over the mask's
entries, ``candidate_slots``), in %. Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    rec = stages.program(ctx)
    if rec is None or not rec["counters"].get("candidate_slots"):
        return None
    c = rec["counters"]
    return 100.0 * c["candidate_rows"] / c["candidate_slots"]
