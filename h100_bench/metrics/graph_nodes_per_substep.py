"""Step pipeline: the nodes of the step's CUDA graph a substep, less the
stage stamps and counter nodes that tracing put in it (the program's
count beside the trace's ``launches_per_substep``). Moves
``body_steps_per_s``."""

from benchlib import stages


def read(ctx):
    rec = stages.program(ctx)
    graphs = [g for g in (rec or {}).get("graphs", ())
              if g["nodes"] is not None and g["substeps"]]
    if not graphs:
        return None
    g = graphs[-1]
    return (g["nodes"] - g["stamps"] - g["counter_nodes"]) / g["substeps"]
