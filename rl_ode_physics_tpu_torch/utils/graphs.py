"""One launch per call on the card: the port's ``jax.jit`` over ``lax.scan``.

The JAX package compiles every step it runs: ``make_step_fn`` and
``make_batched_step_fn`` are ``jax.jit`` over a ``lax.scan`` of the
substeps (``rl_ode_physics_tpu/core/world.py:369-411``,
``parallel/batch.py:44-106``), so a call of 96 substeps is one program on
the device. The port's counterpart on the card is a CUDA graph: the
kernels of ``unroll`` substeps are captured once and replayed, so the host
launches one graph where it launched some 3,500 kernels a substep.

``Graphed(body, unroll, donate)`` holds the graphs of one body, a function
``(carry, consts) -> (carry, aux)`` of trees of tensors (a ``WorldState``,
a tuple, a dict):

* **capture.** At the first call for a signature (the shapes, dtypes and
  device of every tensor, and the trees' structure), the body runs once
  eagerly on a side stream, on a copy of the call's tensors: that builds
  the hand kernels at first use (``ops/kernel_build``) and warms the
  libraries before any capture. Then ``unroll`` calls of the body are
  captured into one ``torch.cuda.CUDAGraph`` that ends by copying the new
  carry into the graph's own carry buffers.
* **replay.** A call of ``steps`` body calls replays that graph
  ``steps // unroll`` times, then a second graph of the remainder, which
  shares the first one's memory pool. With ``unroll = steps`` a call is one
  launch; with ``unroll=1`` it is ``steps`` launches, each of a whole body
  call. ``aux`` is what the last body call of the graph returned.
* **donate.** With ``donate=True`` a carry tensor that already is the
  graph's buffer is used in place, any other is copied in, and the call
  returns tensors on the graph's buffers, updated in place: as with a
  donated JAX buffer, the caller does not read the old handle again. A
  later call that is handed that result steps it in place; a later call
  on other tensors first moves a result that is still referenced to
  memory of its own (one copy), so ``a = f(x); b = f(y)`` leaves ``a``
  as it was, as in JAX. A view taken of a donated result follows the
  buffers. With ``donate=False`` every tensor is copied in and the result
  is returned as new tensors that no later call writes over.
* **cache.** A new signature captures anew, as JAX retraces on a new
  shape. At most ``MAX_GRAPHS`` signatures are held over all functions
  (``lru_cache(maxsize=64)`` in ``parallel/batch.py:44``); the least
  recently used one beyond that is released with its memory pool, and so
  is every graph of a function that is garbage-collected.

``Graphed`` also holds the route: it calls the body ``steps`` times
eagerly where it does not graph, so an entry point calls one object.
``disable_graphs()`` is the counterpart of ``jax.disable_jit``: under it
every call runs the eager loop. ``capturable(config, joints)`` says
whether a configuration's step can be captured at all: every solver's can,
joints included (PGS's sweeps and DANTZIG's pivot loop are each one hand
kernel that reads nothing on the host). A function made for the CPU runs
its eager loop, with ``graphed = False`` and the reason in
``eager_reason``. A capture that fails (a host read that a body makes)
raises; no call falls back to the eager loop from it.

The hand kernels' wrappers count their launches in Python, which a replay
does not run. Each capture records what the counters added while it was
captured (``read_counts`` / ``counts_added``), takes it back (the capture
launched nothing), and every replay adds it again (``credit``); the
warm-up's launches are the graph's building, as a JAX compile is, and are
taken back too. So a count reads the kernels that ran on the call's data.

Tracing (``utils/tracing``): whether it is on is part of the capture key,
so a step captured with stamps is never replayed as the untraced one, nor
the other way round. A graph captured with tracing on ends with the
stamp its ``Graphed`` names (``closing_stamp``: the step layer's
``integrate``, so the carry's copy is the integration's write-back), where
it names one, and is noted with its nodes; a graphed call's host work is
three spans, ``prepare`` (``_detach_handed`` and the copies in),
``launch`` (the replays) and ``hand_out``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import time
import weakref

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.utils import tracing

# bounded: a configuration sweep would otherwise hold every graph's pool
MAX_GRAPHS = 64

_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Run every entry point's eager loop inside the block, as
    ``jax.disable_jit`` runs JAX's functions op by op."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def graphs_enabled() -> bool:
    return _disabled == 0


def on_card(tensor: torch.Tensor) -> bool:
    """Whether a call on ``tensor`` replays graphs: it lies on a card and
    no ``disable_graphs()`` block is open."""
    return tensor.is_cuda and graphs_enabled()


# ---------------------------------------------------------------------------
# What a graph cannot hold
# ---------------------------------------------------------------------------

def capturable(config: EngineConfig, joints=None):
    """(True, "") where a step under ``config`` (with ``joints``, a joint
    table or None) can be captured into a CUDA graph; (False, the host read
    that forbids it, with its file:line) where it cannot. No solver's step
    reads the host: JACOBI's is tensor code, PGS's sweeps are
    ``ops/pgs_kernel.pgs_solve`` and DANTZIG's pivot loop is
    ``ops/lcp_kernel.lcp_pivot_solve``, and the joint passes are
    ``pgs_solve`` under both, so every configuration is capturable."""
    return True, ""


def for_card(device) -> bool:
    """Whether a function made for ``device`` (None: the default device)
    runs on a card."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per (values, dtype,
    device): a copy from the host's memory cannot be captured, so a
    constant that a captured step reads is made before (by the warm-up) and
    then only read. Callers never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

def kernel_counters() -> dict:
    """name → the hand kernel's wrapper whose ``launches`` counts it,
    looked up on its module at every call (a caller may have wrapped it)."""
    from rl_ode_physics_tpu_torch.ops import (
        collide_kernel, compaction_kernel, lcp_kernel, mesh_kernels,
        pgs_kernel)
    return {"compact_rows_t": compaction_kernel.compact_rows_t,
            "collide_pairs": collide_kernel.collide_pairs,
            "sphere_mesh_d2_tiles": mesh_kernels.sphere_mesh_d2_tiles,
            "sphere_mesh_d2": mesh_kernels.sphere_mesh_d2,
            "pgs_solve": pgs_kernel.pgs_solve,
            "lcp_pivot_solve": lcp_kernel.lcp_pivot_solve}


def read_counts(counters: dict) -> dict:
    """name → launches of every counter that counts (a wrapper put in a
    kernel's place without a count is left out)."""
    return {name: c.launches for name, c in counters.items()
            if hasattr(c, "launches")}


def counts_added(before: dict, after: dict) -> dict:
    """What the counters added between two ``read_counts``: the names that
    moved, with how much."""
    return {name: after[name] - before[name] for name in before
            if after[name] != before[name]}


def set_counts(counters: dict, counts: dict) -> None:
    for name, value in counts.items():
        counters[name].launches = value


def credit(counters: dict, added: dict, times: int = 1) -> None:
    """Add ``times`` × ``added`` to the counters: the launches of that many
    replays of a graph whose capture counted ``added``."""
    for name, value in added.items():
        counters[name].launches += value * times


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def flatten(tree):
    """(leaves, treedef): the tensors of a tree of tensors, dataclasses,
    tuples, lists, dicts and None, in order, and its hashable structure."""
    leaves = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
            return "T"
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return ("dc", type(x), tuple(
                (f.name, walk(getattr(x, f.name)))
                for f in dataclasses.fields(x)))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        raise TypeError(f"a graph carries tensors, not {type(x).__name__}")

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d == "T":
            return next(it)
        if d is None:
            return None
        kind, rest = d[0], d[1:]
        if kind == "dc":
            cls, fields = rest
            return cls(**{name: build(sub) for name, sub in fields})
        if kind == "dict":
            return {k: build(sub) for k, sub in rest[0]}
        items = [build(sub) for sub in rest[0]]
        return tuple(items) if kind == "tuple" else items

    return build(treedef)


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _same_buffer(t: torch.Tensor, buf: torch.Tensor) -> bool:
    return t is buf or (t.data_ptr() == buf.data_ptr()
                        and t.shape == buf.shape and t.dtype == buf.dtype
                        and t.stride() == buf.stride())


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A tensor of its own on ``t``'s memory (not a view of ``t``), so it
    can later be moved to memory of its own with ``set_``."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.shape, t.stride())


def _copy_in(buffers, leaves) -> None:
    for buf, t in zip(buffers, leaves):
        if not _same_buffer(t, buf):
            buf.copy_(t)


# ---------------------------------------------------------------------------
# The graphs
# ---------------------------------------------------------------------------

def _node_count(graph) -> int:
    """The nodes of a captured ``cudaGraph_t`` (``cuGraphGetNodes`` of
    ``libcuda``)."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return count.value


@functools.lru_cache(maxsize=None)
def _capture_stream(device) -> torch.cuda.Stream:
    """The stream that captures on ``device``: one a card, made once."""
    return torch.cuda.Stream(device)


class CudaGraph:
    """``fn()`` captured on ``device`` into one CUDA graph, in ``pool`` (a
    sibling graph's pool, or None for a new one). Python's cycle collector
    is held off during the capture: a graph it would free there (one held
    in a reference cycle) destroys its executable, which a capture
    forbids."""

    def __init__(self, fn, device, pool=None):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device):
                with torch.cuda.graph(self._graph, pool=pool,
                                      stream=_capture_stream(device)):
                    fn()
        finally:
            if collecting:
                gc.enable()
        self.nodes = _node_count(self._graph)
        self._graph.instantiate()

    def pool(self):
        return self._graph.pool()

    def replay(self) -> None:
        self._graph.replay()

    def reset(self) -> None:
        self._graph.reset()


def warm_up(fn, device) -> None:
    """``fn()`` once on a side stream of ``device``, ordered after the work
    already queued, as a capture wants."""
    stream = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        fn()
    current.wait_stream(stream)


# the graph class and warm-up; a test may put stand-ins for the card here
GRAPH = CudaGraph
WARM_UP = warm_up

_LIVE: "collections.OrderedDict[int, weakref.ref]" = collections.OrderedDict()


def _register(capture) -> None:
    key = id(capture)
    _LIVE[key] = weakref.ref(capture, lambda _: _LIVE.pop(key, None))
    while len(_LIVE) > MAX_GRAPHS:
        _, ref = _LIVE.popitem(last=False)
        victim = ref()
        if victim is not None:
            victim.release()


def live_graphs() -> int:
    """How many signatures hold graphs, over all functions."""
    return len(_LIVE)


def release_all() -> None:
    """Release every graph held, with its memory pool."""
    for ref in list(_LIVE.values()):
        capture = ref()
        if capture is not None:
            capture.release()
    _LIVE.clear()


class _Capture:
    """The graphs of one body at one signature: the carry and constant
    buffers they read and write, one graph per number of body calls, and
    what each capture added to the launch counters."""

    def __init__(self, owner, key, carry, consts):
        self._owner = weakref.ref(owner)
        self._key = key
        self._body = owner.body
        self._closing_stamp = owner.closing_stamp
        carry_leaves, self._carry_def = flatten(carry)
        const_leaves, self._const_def = flatten(consts)
        self.device = carry_leaves[0].device
        self.carry = [_fresh(t) for t in carry_leaves]
        self.consts = [_fresh(t) for t in const_leaves]
        self.graphs, self.added, self.aux = {}, {}, {}
        self.aux_def = None
        self._handed = []       # weak references to a donated call's result
        self.capture_s = 0.0
        self._pool = None
        counters = kernel_counters()
        before = read_counts(counters)
        t0 = time.perf_counter()
        WARM_UP(self._warm_body, self.device)
        self.capture_s += time.perf_counter() - t0
        set_counts(counters, before)

    def _warm_body(self) -> None:
        self._body(unflatten(self._carry_def, [t.clone() for t in self.carry]),
                   unflatten(self._const_def, self.consts))

    def _calls(self, n: int) -> None:
        carry = unflatten(self._carry_def, self.carry)
        consts = unflatten(self._const_def, self.consts)
        aux = None
        for _ in range(n):
            carry, aux = self._body(carry, consts)
        out, carry_def = flatten(carry)
        if carry_def != self._carry_def:
            raise TypeError("the body returned a carry of another structure")
        for buf, t in zip(self.carry, out):
            if not _same_buffer(t, buf):
                buf.copy_(t)
        if self._closing_stamp:
            tracing.stamp(self._closing_stamp)
        self.aux[n], self.aux_def = flatten(aux)

    def graph(self, n: int):
        if n not in self.graphs:
            counters = kernel_counters()
            before = read_counts(counters)
            stamped = tracing.launched()
            t0 = time.perf_counter()
            self.graphs[n] = GRAPH(lambda: self._calls(n), self.device,
                                   self._pool)
            self.capture_s += time.perf_counter() - t0
            if self._pool is None:
                self._pool = self.graphs[n].pool()
            self.added[n] = counts_added(before, read_counts(counters))
            set_counts(counters, before)
            if tracing.enabled():
                tracing.note_graph(getattr(self.graphs[n], "nodes", None),
                                   stamped)
        return self.graphs[n]

    def nodes(self) -> dict:
        """Body calls → graph nodes, of each graph captured."""
        return {n: getattr(g, "nodes", None) for n, g in self.graphs.items()}

    def _detach_handed(self, donated) -> None:
        """Move every tensor of the last donated result that is still
        referenced, other than those handed back in ``donated``, to memory
        of its own: this call writes over the buffers it lies on."""
        keep = {id(t) for t in donated}
        for ref in self._handed:
            t = ref()
            if t is not None and id(t) not in keep:
                t.set_(t.clone())
        self._handed = []

    def _hand_out(self, leaves) -> list:
        out = [_alias(t) for t in leaves]
        self._handed = [weakref.ref(t) for t in out]
        return out

    def run(self, carry, consts, steps: int, unroll: int, donate: bool):
        carry_leaves, _ = flatten(carry)
        const_leaves, _ = flatten(consts)
        with tracing.span("prepare"):
            self._detach_handed(carry_leaves if donate else ())
            _copy_in(self.carry, carry_leaves)
            _copy_in(self.consts, const_leaves)
        counters = kernel_counters()
        u = max(1, min(unroll, steps))
        full, rest = divmod(steps, u)
        last = None
        for n, times in ((u, full), (rest, 1 if rest else 0)):
            if times:
                graph = self.graph(n)
                with tracing.span("launch"):
                    for _ in range(times):
                        graph.replay()
                credit(counters, self.added[n], times)
                last = n
        aux_leaves = self.aux[last] if last is not None else []
        with tracing.span("hand_out"):
            if donate:
                out = self._hand_out(self.carry + aux_leaves)
            else:
                out = [t.clone() for t in self.carry + aux_leaves]
        n = len(self.carry)
        aux = unflatten(self.aux_def, out[n:]) if last is not None else None
        return unflatten(self._carry_def, out[:n]), aux

    def release(self) -> None:
        self._detach_handed(())       # before the pool its aux lies in goes
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.aux.clear()
        self.carry, self.consts = [], []
        owner = self._owner()
        if owner is not None:
            owner.captures.pop(self._key, None)
        _LIVE.pop(id(self), None)


class Graphed:
    """``body(carry, consts) -> (carry, aux)`` called ``steps`` times a
    call. Call it as ``graphed(carry, consts, steps)`` → (carry, aux).

    Where ``graphed`` (the function is for a card, and ``config`` with
    ``joints`` is capturable; no ``config``: capturable) and the carry lies
    on a card outside ``disable_graphs()``, a call replays CUDA graphs of
    ``unroll`` body calls (``unroll=None``: all of a call's steps in one
    graph); otherwise it is the eager loop, and ``eager_reason`` says why
    where it always is. ``closing_stamp``: the ``utils/tracing`` stage
    that a graph captured with tracing on ends, after the carry's copy."""

    def __init__(self, body, unroll=None, donate: bool = True,
                 config: EngineConfig | None = None, joints=None,
                 device=None, closing_stamp: str | None = None):
        self.body = body
        self.closing_stamp = closing_stamp
        self.unroll = unroll
        self.donate = donate
        self.captures = {}
        ok, reason = (True, "") if config is None else capturable(config,
                                                                  joints)
        if ok and not for_card(device):
            ok, reason = False, "a function made for the CPU runs its eager loop"
        self.graphed, self.eager_reason = ok, reason

    def capture_for(self, carry, consts=None):
        """The ``_Capture`` of this signature, made if new."""
        carry_leaves, carry_def = flatten(carry)
        const_leaves, const_def = flatten(consts)
        key = (carry_def, const_def, _signature(carry_leaves),
               _signature(const_leaves), tracing.enabled())
        capture = self.captures.get(key)
        if capture is None:
            capture = _Capture(self, key, carry, consts)
            self.captures[key] = capture
            _register(capture)
        elif id(capture) in _LIVE:
            _LIVE.move_to_end(id(capture))
        return capture

    def __call__(self, carry, consts=None, steps: int = 1, donate=None):
        """(carry, aux) after ``steps`` body calls; ``donate`` overrides
        the function's for this call."""
        if not (self.graphed and on_card(flatten(carry)[0][0])):
            aux = None
            for _ in range(steps):
                carry, aux = self.body(carry, consts)
            return carry, aux
        capture = self.capture_for(carry, consts)
        unroll = steps if self.unroll is None else self.unroll
        return capture.run(carry, consts, steps, unroll,
                           self.donate if donate is None else donate)

    def stats(self) -> list:
        """Capture seconds and graph nodes of every signature held."""
        return [dict(capture_s=c.capture_s, nodes=c.nodes())
                for c in self.captures.values()]


class StepFunction:
    """state → state: ``substeps`` calls of ``substep(state)`` through a
    ``Graphed`` (``graphs``), whose ``graphed`` and ``eager_reason`` it
    carries; ``closing_stamp`` as there."""

    def __init__(self, substep, substeps: int, unroll, donate: bool,
                 config: EngineConfig, joints=None, device=None,
                 closing_stamp: str | None = None):
        self.substeps = substeps
        self.graphs = Graphed(lambda state, _: (substep(state), None),
                              unroll, donate, config, joints, device,
                              closing_stamp)
        self.graphed = self.graphs.graphed
        self.eager_reason = self.graphs.eager_reason

    def __call__(self, state, donate=None):
        return self.graphs(state, None, self.substeps, donate)[0]
