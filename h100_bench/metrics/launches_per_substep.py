"""Step pipeline: the device kernels the traced calls ran, per substep
(the harness's resets and failure count included). Moves
``body_steps_per_s``."""

from _kernels import kernels


def read(ctx):
    ks = kernels(ctx)
    if not ks or not ctx.get("traced_substeps"):
        return None
    return len(ks) / ctx["traced_substeps"]
