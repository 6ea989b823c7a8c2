"""Step pipeline (``core.world`` and its ops): the summed device time of
every kernel in the traced calls, per substep. Moves
``body_steps_per_s``."""

from _kernels import kernels


def read(ctx):
    ks = kernels(ctx)
    if not ks or not ctx.get("traced_substeps"):
        return None
    return sum(t - s for _, s, t in ks) / 1e3 / ctx["traced_substeps"]
