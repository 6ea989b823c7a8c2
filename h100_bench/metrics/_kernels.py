"""What the device-trace readers share: the traced window's kernels."""


def kernels(ctx):
    """(name, start_us, end_us) of every kernel the traced calls ran:
    the device operations less the copies and fills."""
    return [k for k in ctx.get("kernels", ())
            if not k[0].startswith(("Memcpy", "Memset"))]


def ms_per_substep(ctx, part: str):
    """Summed device ms a substep of the kernels whose name holds
    ``part``; None where no such kernel ran."""
    hits = [t - s for name, s, t in kernels(ctx) if part in name]
    if not hits or not ctx.get("traced_substeps"):
        return None
    return sum(hits) / 1e3 / ctx["traced_substeps"]
