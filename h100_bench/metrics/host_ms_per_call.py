"""Graph replay layer (``parallel.batch``, ``utils.graphs``): the median
host time of a call of the measured window, from its start to the return
of the program's step function, before the synchronise, on the harness's
clock. Moves ``call_ms_p95``."""

import statistics


def read(ctx):
    host = ctx.get("host_ms")
    return statistics.median(host) if host else None
