"""Graph replay layer (``parallel.batch``, ``utils.graphs``): the program's
own host spans of a call (``prepare``, ``launch``, ``hand_out``), ms a
call on ``perf_counter``. The inside counterpart of ``host_ms_per_call``.
Moves ``call_ms_p95``."""

from benchlib import stages


def read(ctx):
    rec = stages.program(ctx)
    if rec is None or "prepare" not in rec["spans"]:
        return None
    calls = rec["spans"]["prepare"]["count"]
    return sum(s["ns"] for s in rec["spans"].values()) / 1e6 / calls
