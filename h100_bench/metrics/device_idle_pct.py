"""Device (H100): the share of the traced window in which no device
operation ran, from the union of their intervals on the timeline (not
from summed times). Moves ``body_steps_per_s``."""


def read(ctx):
    window = ctx.get("window_s")
    if not window:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / window)
