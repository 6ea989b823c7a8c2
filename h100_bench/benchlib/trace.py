"""The traced calls of a ``--trace 1`` run and what is read from them.

After the measured window, a few more calls run under ``torch.profiler``
(CPU and CUDA activities), each phase of the harness's loop inside a
``record_function`` span (``h100_bench.resets``, ``.step``, ``.check``,
``.sync``) and the whole inside ``h100_bench.window``. From the trace:

* the device's operations (kernels, copies, fills) with their names and
  intervals; ``busy_s`` is the length of the union of their intervals
  inside the window, not the sum of their times, so overlapping kernels
  count once;
* ``breakdown``: the device operations that took most time, and the
  longest idle gaps of the device inside the window, each named by the
  harness span and the CUDA runtime call the host was in at the gap's
  middle.
"""

from __future__ import annotations

import collections

SPAN = "h100_bench."
# a device operation's name in the breakdown: its first characters, enough
# to tell the kernel and its first template argument
NAME_CHARS = 120


def traced(batch, step, resets, fail, call: int, n: int, device):
    """``n`` calls under the profiler: (reduced trace, batch, next call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities) as prof:
        with record_function(SPAN + "window"):
            for _ in range(n):
                with record_function(SPAN + "resets"):
                    resets.apply(batch, call)
                with record_function(SPAN + "step"):
                    batch = step(batch)
                with record_function(SPAN + "check"):
                    fail.update(batch)
                with record_function(SPAN + "sync"):
                    sync()
                call += 1
    return reduce(prof.events()), batch, call


def _is_device(event) -> bool:
    """A device operation: a CUDA event that is not the device-side image
    of a ``record_function`` span."""
    import torch
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.name.startswith(SPAN))


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce(events) -> dict:
    """The device operations inside the harness's window span, the busy
    and window seconds, and the breakdown."""
    window = [e for e in events if e.name == SPAN + "window"]
    if not window:
        raise RuntimeError("the trace holds no h100_bench.window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    ops = []
    spans, runtime = [], []
    for e in events:
        r = e.time_range
        if _is_device(e):
            start, end = max(r.start, w0), min(r.end, w1)
            if end > start:
                ops.append((e.name, start, end))
        elif e.name.startswith(SPAN) and e.name != SPAN + "window":
            spans.append((r.start, r.end, e.name[len(SPAN):]))
        elif e.name.startswith("cuda"):
            runtime.append((r.start, r.end, e.name))
    busy = merge((s, t) for _, s, t in ops)
    busy_us = sum(t - s for s, t in busy)
    by_name = collections.Counter()
    for name, s, t in ops:
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-6
    gaps = []
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    named = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + t)
        span = next((n for a, b, n in spans if a <= mid <= b), "loop")
        call = next((n for a, b, n in runtime if a <= mid <= b), None)
        named.append([span if call is None else f"{span}:{call}",
                      (t - s) * 1e-6])
    return dict(
        kernels=ops, busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        breakdown=dict(device_ops=[[n, v] for n, v in
                                   by_name.most_common(10)],
                       idle_gaps=named))
