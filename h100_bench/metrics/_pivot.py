"""What DANTZIG's readers share: the program's pivot counters
(``ops/lcp.solve_dantzig``), read from the run's program record."""

from benchlib import stages


def counters(ctx, *names):
    """The record's counters with ``names`` and ``world_substeps`` among
    them; None where there is no record, it holds no world-substep, or
    the program counts none of ``names`` (a program from before them)."""
    rec = stages.program(ctx)
    if rec is None:
        return None
    c = rec["counters"]
    if not c.get("world_substeps") or any(n not in c for n in names):
        return None
    return c


def per_world(ctx, name: str):
    """Counter ``name`` over the world-substeps it was summed over."""
    c = counters(ctx, name)
    return None if c is None else c[name] / c["world_substeps"]
