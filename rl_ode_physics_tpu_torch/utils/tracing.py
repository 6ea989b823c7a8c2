"""Tracing inside the port's step: stage stamps, device counters, host spans.

Off by default. ``with tracing.recording(device): ...`` (or
``enable(device)`` … ``disable()``) switches it on for a block, and
``read()`` returns one record of what ran since ``enable`` or the last
``reset()``. With tracing off every call here returns at a flag test and
launches nothing, so a step captured then is the untraced step's graph;
``utils/graphs`` keeps the two captures apart (the state is part of its
capture key).

* **Stage stamps.** ``stamp(stage)`` ends a stage of the substep
  (``core/world._step_impl`` and the functions it calls). On a card it
  launches ``stage_stamp`` (``csrc/stage_stamp.cu``), one thread on the
  current stream, so a CUDA graph captured while tracing is on holds it
  and every replay runs it: it reads ``%globaltimer``, adds the time since
  the previous stamp to the stage's accumulator and 1 to its count. The
  ``start`` stamp at the entry of every substep credits the time since the
  last stamp (the device's time outside the step: the caller's own work,
  the host's launch, idle) to ``outside``, and keeps each such gap in a
  ring. A stage that interleaves with another (the typed path's buckets)
  stamps each time it ends and sums its pieces. On the CPU, where eager
  ops run in order, the same calls take ``time.perf_counter_ns``.
* **Device counters.** ``count(name, x)`` adds the sum of a (B,) integer
  tensor, or the groups of a bool mask that hold a set entry, to a
  counter by one ``stage_count`` launch (a sum on the host on the CPU),
  summed over worlds and substeps: ``pairs_tested``, ``contact_rows``,
  ``rows_dropped``, ``world_substeps`` (``core/world._pair_row_counters``,
  the helper the diagnostics share), ``candidate_rows`` with the mask's
  entries ``candidate_slots`` (the mask handed to the row compaction),
  and DANTZIG's solve (``ops/lcp.solve_dantzig``, a world-solve each):
  ``lcp_valid_rows`` V and its powers ``lcp_valid_rows_sq`` and
  ``lcp_valid_rows_cube``, ``lcp_active_rows``, ``pivot_rounds`` and
  ``pivot_capped``. A count whose source is a function is made only while
  tracing is on.
* **Host spans.** ``span(name)`` times a block of the program's host
  code on ``perf_counter_ns`` into a bounded ring (``utils/graphs``:
  ``prepare``, ``launch``, ``hand_out`` of a graphed call), and opens a
  ``torch.profiler.record_function`` named ``rl_ode.<name>`` where a
  profiler is active. ``read()`` puts each outside gap of the device under
  the span open at its midpoint (``caller`` where none was), through the
  offset between the two clocks that ``enable`` measures.
* **Graphs.** ``utils/graphs`` notes each graph it captures while tracing
  is on: its nodes, the stamps and counter nodes among them, and the
  substeps it holds.

The accumulators of a device are one int64 tensor, made at its first
``enable`` and kept (a graph holds its address), zeroed in place by
``reset()``; nothing is read on the host before ``read()``. One device is
traced at a time.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import functools
import time

import torch

# the stages of a substep, in the order a substep passes them; "outside"
# is the device's time between the last stamp and the next "start"
STAGES = ("outside", "mesh", "joints", "pairs", "collide", "compact",
          "forces", "solve.rows", "solve.iterate", "integrate")
# the stamps: each ends its stage; "start" ends "outside"
STAMPS = ("start",) + STAGES[1:]
COUNTERS = ("pairs_tested", "candidate_rows", "candidate_slots",
            "contact_rows", "rows_dropped", "world_substeps",
            "lcp_valid_rows", "lcp_valid_rows_sq", "lcp_valid_rows_cube",
            "lcp_active_rows", "pivot_rounds", "pivot_capped")
# outside gaps kept on the device, host spans kept on the host
GAP_RING = 1024
SPAN_RING = 4096
SPAN_PREFIX = "rl_ode."

_S = len(STAGES)
_COUNTER = 2 + 2 * _S
_GAPS = _COUNTER + len(COUNTERS)
_SIZE = _GAPS + 1 + 2 * GAP_RING
_STAMP_INDEX = {name: i for i, name in enumerate(STAMPS)}
_COUNTER_INDEX = {name: _COUNTER + i for i, name in enumerate(COUNTERS)}
# stage_count's kinds of source
_CONST, _INT32, _GROUPS = 0, 1, 2

_on = False
_device = None
_acc = None            # the traced device's accumulators
_host = None           # on the CPU: a numpy view of them
_ACC = {}              # device → its accumulators, kept once made
_clock = {"offset_ns": 0, "uncertainty_ns": None}
_spans = collections.deque(maxlen=SPAN_RING)
_span_totals = collections.defaultdict(lambda: [0, 0])
_order = collections.deque(maxlen=64)
_graphs = collections.deque(maxlen=64)
_kernels_at_reset = {}
# what was launched, by kind, over the process: a capture takes its
# difference to count the stamps and counter nodes of its graph
_launched = collections.Counter()
# true while tracing's own host code runs (a test tells its ops apart)
own = False


def enabled() -> bool:
    return _on


def _same_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _on_card() -> bool:
    return _device.type == "cuda"


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    from rl_ode_physics_tpu_torch.ops import kernel_build
    return kernel_build.build("stage_stamp.cu")


FUNCTIONS = {
    "stamp_launch": [ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "count_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    from rl_ode_physics_tpu_torch.ops import kernel_build
    return kernel_build.load(build(), FUNCTIONS)


def _stream() -> int:
    return torch.cuda.current_stream(_device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _sync() -> None:
    if _device is not None and _on_card():
        torch.cuda.synchronize(_device)


def _calibrate(repeats: int = 5) -> dict:
    """The offset of ``%globaltimer`` from ``perf_counter_ns``: a stamp
    between two host reads around synchronisations, the tightest of
    ``repeats``; the uncertainty is half that window."""
    best = None
    lib = _library()
    for _ in range(repeats):
        torch.cuda.synchronize(_device)
        h0 = time.perf_counter_ns()
        _check(lib.stamp_launch(_acc.data_ptr(), -1, _S, _GAPS, GAP_RING,
                                _stream()), "stage_stamp")
        torch.cuda.synchronize(_device)
        h1 = time.perf_counter_ns()
        g = int(_acc[1])
        if best is None or h1 - h0 < best[1] - best[0]:
            best = (h0, h1, g)
    h0, h1, g = best
    return {"offset_ns": g - (h0 + h1) // 2, "uncertainty_ns": (h1 - h0) / 2}


def enable(device) -> None:
    """Switch tracing on for the steps on ``device``; its accumulators are
    made (at the first call for the device), zeroed, and on a card the
    kernels built and the clocks' offset measured."""
    global _on, _device, _acc, _host, _clock
    _device = _same_device(device)
    if _device not in _ACC:
        _ACC[_device] = torch.zeros(_SIZE, dtype=torch.int64, device=_device)
    _acc = _ACC[_device]
    _host = None if _on_card() else _acc.numpy()
    if _on_card():
        with torch.cuda.device(_device):
            _clock = _calibrate()
    else:
        _clock = {"offset_ns": 0, "uncertainty_ns": 0.0}
    _graphs.clear()
    reset()
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def recording(device):
    """Tracing on for the block, on ``device``, and off after it. Refused
    where tracing is on already: a record inside another would zero the
    outer's accumulators."""
    if _on:
        raise RuntimeError("tracing is on already: a recording inside "
                           "another would erase the outer record")
    enable(device)
    try:
        yield
    finally:
        disable()


def reset() -> None:
    """Zero the accumulators, the spans and the launch counts' baseline."""
    global _kernels_at_reset
    from rl_ode_physics_tpu_torch.utils import graphs
    _sync()
    _acc.zero_()
    _spans.clear()
    _span_totals.clear()
    _order.clear()
    _kernels_at_reset = graphs.read_counts(graphs.kernel_counters())


# ---------------------------------------------------------------------------
# On the main path
# ---------------------------------------------------------------------------

def stamp(name: str) -> None:
    """End stage ``name`` (one of ``STAMPS``)."""
    if not _on:
        return
    s = _STAMP_INDEX[name]
    _order.append(name)
    _launched["stamp"] += 1
    _launched["stamp:" + name] += 1
    if _host is None:
        _check(_library().stamp_launch(_acc.data_ptr(), s, _S, _GAPS,
                                       GAP_RING, _stream()), "stage_stamp")
        return
    now = time.perf_counter_ns()
    prev = int(_host[0])
    if prev:
        _host[2 + s] += now - prev
        if s == 0:
            seen = int(_host[_GAPS])
            i = _GAPS + 1 + 2 * (seen % GAP_RING)
            _host[i], _host[i + 1] = prev, now
            _host[_GAPS] = seen + 1
    _host[2 + _S + s] += 1
    _host[0] = now


def count(name: str, x, group: int = 1, also=None) -> None:
    """Add to counter ``name``: the sum of ``x``, a (B,) int32 tensor,
    or the groups of ``group`` consecutive entries of ``x``, a contiguous
    bool mask, that hold a set entry; or ``x`` itself where it is an int.
    ``x`` may be a function of no arguments that gives one of those: it is
    called only while tracing is on, and its ops are tracing's own.
    ``also``: (counter, int) added in the same launch."""
    global own
    if not _on:
        return
    if callable(x):
        own = True
        try:
            x = x()
        finally:
            own = False
    slot = _COUNTER_INDEX[name]
    slot2, add2 = (-1, 0) if also is None else (_COUNTER_INDEX[also[0]],
                                                int(also[1]))
    _launched["count"] += 1
    if _host is not None:
        own = True
        try:
            if not torch.is_tensor(x):
                value = int(x)
            elif x.dtype == torch.bool:
                value = int(x.reshape(-1, group).any(-1).sum())
            else:
                value = int(x.sum())
        finally:
            own = False
        _host[slot] += value
        if slot2 >= 0:
            _host[slot2] += add2
        return
    if not torch.is_tensor(x):
        src, n, kind = None, int(x), _CONST
    else:
        kind = {torch.int32: _INT32, torch.bool: _GROUPS}.get(x.dtype)
        if kind is None or not x.is_contiguous():
            raise TypeError(f"count {name}: a contiguous int32 or bool "
                            f"tensor, not {x.dtype}")
        src = x.data_ptr()
        n = x.numel() // group if kind == _GROUPS else x.numel()
    _check(_library().count_launch(_acc.data_ptr(), slot, src, n, kind,
                                   group, slot2, add2, _stream()),
           "stage_count")


class _Span:
    __slots__ = ("name", "t0", "fn")

    def __init__(self, name: str):
        self.name = name
        self.fn = None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self.fn = torch.autograd.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _spans.append((self.name, self.t0, t1))
        total = _span_totals[self.name]
        total[0] += t1 - self.t0
        total[1] += 1
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that times the block as host span ``name`` where tracing
    is on, and does nothing where it is off."""
    return _Span(name) if _on else _NO_SPAN


def launched() -> collections.Counter:
    """What tracing has launched over the process, by kind (a copy)."""
    return collections.Counter(_launched)


def note_graph(nodes, before: collections.Counter) -> None:
    """Record a graph captured while tracing was on: ``nodes`` (None where
    unknown) and what tracing launched into it (``launched()`` before the
    capture, against now)."""
    added = launched() - before
    _graphs.append({
        "nodes": nodes,
        "stamps": added["stamp"],
        "counter_nodes": added["count"],
        "substeps": added["stamp:start"],
        "per_stamp": {s: added["stamp:" + s] for s in STAMPS
                      if added["stamp:" + s]}})


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------

def _outside_by_span(acc, offset_ns: int) -> dict:
    """Each outside gap the ring holds, under the host span open at its
    midpoint (``caller`` where none was): name → ns."""
    seen = int(acc[_GAPS])
    gaps = acc[_GAPS + 1:_GAPS + 1 + 2 * min(seen, GAP_RING)].reshape(-1, 2)
    spans = sorted(_spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out = collections.Counter()
    for g0, g1 in gaps.tolist():
        mid = (g0 + g1) // 2 - offset_ns
        i = bisect.bisect_right(starts, mid) - 1
        inside = i >= 0 and mid <= spans[i][2]
        out[spans[i][0] if inside else "caller"] += g1 - g0
    return dict(out)


def read() -> dict:
    """One record of what ran since ``enable`` or ``reset()``: each
    stage's nanoseconds (``stages_ns``) and stamps (``stamps``), the
    counters, the host spans (ns and count), the outside gaps by host span,
    the hand kernels' launches, the graphs captured since ``enable``, the
    stamps of the last substep in order and the clocks' offset."""
    from rl_ode_physics_tpu_torch.utils import graphs
    if _acc is None:
        raise RuntimeError("tracing was never enabled")
    _sync()
    acc = _acc.cpu().numpy().copy()
    order = list(_order)
    if "start" in order:
        order = order[len(order) - 1 - order[::-1].index("start"):]
    now = graphs.read_counts(graphs.kernel_counters())
    return {
        "device": str(_device),
        "stages_ns": {s: int(acc[2 + i]) for i, s in enumerate(STAGES)},
        "stamps": {s: int(acc[2 + _S + i]) for i, s in enumerate(STAMPS)},
        "counters": {c: int(acc[i]) for c, i in _COUNTER_INDEX.items()},
        "spans": {name: {"ns": t[0], "count": t[1]}
                  for name, t in _span_totals.items()},
        "outside_by_span": _outside_by_span(acc, _clock["offset_ns"]),
        "outside_gaps": int(acc[_GAPS]),
        "kernel_launches": graphs.counts_added(_kernels_at_reset, now),
        "graphs": list(_graphs),
        "order": order,
        "clock": dict(_clock),
    }
