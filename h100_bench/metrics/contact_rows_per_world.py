"""Contact compaction: the contact rows the solver works on, a world a
substep (the program's ``contact_rows`` counter, ``contacts.count``
summed, over ``world_substeps``). Moves ``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    return stages.per_world(ctx, "contact_rows")
