"""The port's one-launch-per-call form (``utils/graphs.py``) against the
JAX package's ``jax.jit`` over ``lax.scan``.

The CPU has no CUDA graphs, so the graphed route runs here on stand-ins:
a "graph" that keeps the captured function and runs it at every replay,
and a warm-up run in place. Everything around the capture runs as on the
card: the signature cache, the copies into and out of the graph's
buffers, ``unroll`` and its remainder graph, ``donate``, ``chunk`` and the
launch-count bookkeeping. The card's own capture is held bitwise to the
eager loop in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 28.

The small bench configuration (16 slots, 12 bodies) from the bench world:
the first impacts come at substep 30, so 32 substeps end with live
contact rows. Tolerance: ``tests/test_torch_step.py``'s atol 1e-4 against
JAX (XLA fuses multiply-adds on the CPU where PyTorch rounds each
operation); the graphed route against the port's eager loop, bitwise.
"""

import ast
import contextlib
import dataclasses
import functools
import inspect
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl_ode_physics_tpu.core.world as jax_world
import rl_ode_physics_tpu.parallel.batch as jax_batch
import rl_ode_physics_tpu.parallel.mesh as jax_mesh
from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu_torch import bench
from rl_ode_physics_tpu_torch.core import world as t_world
from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.ops import compaction_kernel
from rl_ode_physics_tpu_torch.ops import joints as joint_ops
from rl_ode_physics_tpu_torch.parallel import batch as t_batch
from rl_ode_physics_tpu_torch.parallel import mesh as t_mesh
from rl_ode_physics_tpu_torch.utils import bridge, graphs

from _torch_port import (  # noqa: F401
    SMALL_BODIES, configs, single_cpu_thread, to_numpy)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
SUBSTEPS = 32                  # past the first impacts at substep 30
WORLDS = 4


class FakeGraph:
    """A CUDA graph's stand-in: the capture keeps the function, and a
    replay runs it. ``capturing`` is true while a capture (or a warm-up)
    runs the function, when a kernel's Python wrapper would count."""

    capturing = False
    made = 0

    def __init__(self, fn, device, pool=None):
        FakeGraph.made += 1
        self.fn, self.nodes = fn, None      # the capture: kept, not run

    def pool(self):
        return None

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


def fake_warm_up(fn, device):
    FakeGraph.capturing = True
    try:
        fn()
    finally:
        FakeGraph.capturing = False


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Every entry point takes its graphed route on CPU tensors."""
    monkeypatch.setattr(graphs, "GRAPH", FakeGraph)
    monkeypatch.setattr(graphs, "WARM_UP", fake_warm_up)
    monkeypatch.setattr(graphs, "on_card",
                        lambda tensor: graphs.graphs_enabled())
    monkeypatch.setattr(graphs, "for_card", lambda device: True)
    yield
    graphs.release_all()


def _start(jcfg, num_worlds=WORLDS):
    """The small bench world in ``num_worlds`` worlds, each world's
    velocities kicked apart (from numpy): (JAX batch, numpy arrays)."""
    world = jax_scenes.bench_world(jcfg, num_bodies=SMALL_BODIES)
    arrays = to_numpy(jax_batch.replicate(world, num_worlds))
    rng = np.random.default_rng(8)
    dyn = arrays["inv_mass"] > 0
    kick = rng.normal(scale=0.05, size=arrays["linvel"].shape)
    arrays["linvel"] = (arrays["linvel"] + np.where(
        dyn[..., None], kick, 0)).astype(np.float32)
    return (JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            arrays)


# the JAX scan's unroll replicates its body in the compiled program and
# changes no operation; past 4 its compile on the CPU takes minutes (110-
# 125 s at 32), so the port's unroll 32 is held to JAX's at 4
JAX_UNROLL_CAP = 4


@functools.lru_cache(maxsize=None)
def _jax_reference(chunk: int, unroll: int):
    jcfg, _ = configs()
    jbatch, _ = _start(jcfg)
    fn = jax_batch.make_batched_step_fn(jcfg, substeps=SUBSTEPS,
                                        donate=False, chunk=chunk,
                                        unroll=min(unroll, JAX_UNROLL_CAP))
    return to_numpy(fn(jbatch))


def _params(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


# the JAX parameters the port leaves out: it has no Pallas switch (the
# hand kernels run wherever a tensor is on a card), and its mesh carries
# its axis name on the Mesh
LEFT_OUT = ("use_pallas", "axis_name")


@pytest.mark.parametrize("name,jax_fn,port_fn,port_extra", [
    ("make_step_fn", jax_world.make_step_fn, t_world.make_step_fn, ()),
    ("make_batched_step_fn", jax_batch.make_batched_step_fn,
     t_batch.make_batched_step_fn, ("device", "trimesh", "joints")),
    ("make_sharded_step_fn", jax_mesh.make_sharded_step_fn,
     t_mesh.make_sharded_step_fn, ()),
    ("make_shard_map_step_fn", jax_mesh.make_shard_map_step_fn,
     t_mesh.make_shard_map_step_fn, ()),
])
def test_signatures_follow_jax(name, jax_fn, port_fn, port_extra):
    """The JAX parameters, in the JAX order and with its defaults, then the
    port's own: a call written for the JAX function means the same."""
    jax_fn = getattr(jax_fn, "__wrapped__", jax_fn)
    want = [p for p in _params(jax_fn) if p[0] not in LEFT_OUT]
    got = _params(port_fn)
    assert got[:len(want)] == want, name
    assert [n for n, _ in got[len(want):]] == list(port_extra), name


@pytest.mark.parametrize("route", ["graphs", "eager"])
@pytest.mark.parametrize("chunk", [0, 2])
@pytest.mark.parametrize("unroll", [1, 4, SUBSTEPS])
@pytest.mark.parametrize("donate", [True, False])
def test_batched_step_matches_jax(request, donate, unroll, chunk, route):
    if route == "graphs":
        request.getfixturevalue("cpu_graphs")
    jcfg, tcfg = configs()
    _, arrays = _start(jcfg)
    ref = _jax_reference(chunk, unroll)
    batch = bridge.world_from_numpy(arrays, device="cpu")
    live = []
    compact = compaction_kernel.compact_rows_t

    def recording(mask, payload_t, k, sel_dtype=None):
        live.append(int(mask.sum()))
        return compact(mask, payload_t, k, sel_dtype)

    fn = t_batch.make_batched_step_fn(tcfg, SUBSTEPS, donate, chunk, unroll,
                                      device="cpu")
    assert fn.graphed is (route == "graphs")
    compaction_kernel.compact_rows_t = recording
    try:
        got = bridge.world_to_numpy(fn(batch))
    finally:
        compaction_kernel.compact_rows_t = compact
    # the graphed route's warm-up runs one more substep, on a copy
    warm_up = 1 if route == "graphs" else 0
    assert len(live) == SUBSTEPS * (2 if chunk else 1) + warm_up
    assert live[-1] > 0
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow"):
        assert np.array_equal(got[name], ref[name]), name


@pytest.mark.parametrize("unroll", [1, 4, 5, SUBSTEPS])
@pytest.mark.parametrize("chunk", [0, 2])
def test_graphed_route_is_bitwise_the_eager_loop(cpu_graphs, unroll, chunk):
    """The replay logic (unroll, the remainder graph, chunks) changes no
    bit of what the eager loop computes."""
    jcfg, tcfg = configs()
    _, arrays = _start(jcfg)
    fn = t_batch.make_batched_step_fn(tcfg, SUBSTEPS, True, chunk, unroll,
                                      device="cpu")
    got = fn(bridge.world_from_numpy(arrays, device="cpu"))
    with graphs.disable_graphs():
        want = fn(bridge.world_from_numpy(arrays, device="cpu"))
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("route", ["graphs", "eager"])
@pytest.mark.parametrize("chunk", [0, 2])
def test_donate_false_leaves_the_input(request, route, chunk):
    if route == "graphs":
        request.getfixturevalue("cpu_graphs")
    _, tcfg = configs()
    _, arrays = _start(configs()[0])
    batch = bridge.world_from_numpy(arrays, device="cpu")
    before = {f.name: getattr(batch, f.name).clone()
              for f in dataclasses.fields(batch)}
    fn = t_batch.make_batched_step_fn(tcfg, 4, False, chunk, 2,
                                      device="cpu")
    first = fn(batch)
    kept = {f.name: getattr(first, f.name).clone()
            for f in dataclasses.fields(first)}
    second = fn(batch)
    for name, value in before.items():
        assert torch.equal(getattr(batch, name), value), name
        # a later call writes over no earlier output
        assert torch.equal(getattr(first, name), kept[name]), name
        assert torch.equal(getattr(second, name), kept[name]), name
    assert int(first.tick[0]) == int(batch.tick[0]) + 4


def test_donate_true_steps_the_graph_buffers_in_place(cpu_graphs):
    """``batch = fn(batch)``: the first call copies the batch in, later
    ones find it already is the graph's buffers."""
    _, tcfg = configs()
    _, arrays = _start(configs()[0])
    fn = t_batch.make_batched_step_fn(tcfg, 2, True, device="cpu")
    batch = fn(bridge.world_from_numpy(arrays, device="cpu"))
    again = fn(batch)
    assert again.pos.data_ptr() == batch.pos.data_ptr()
    assert int(again.tick[0]) == 4 and int(batch.tick[0]) == 4
    (capture,) = fn.graphs.captures.values()
    assert capture.carry[0].data_ptr() == again.pos.data_ptr()


@pytest.mark.parametrize("hand_back", [False, True])
def test_donated_result_is_not_overwritten_by_a_call_on_other_tensors(
        cpu_graphs, hand_back):
    """``a = f(x); b = f(y)`` leaves ``a`` as it was, as JAX does: the
    second call moves ``a`` off the graph's buffers before it copies ``y``
    in. Handed back (``f(a)``) a result is stepped in place, and a result
    passed to a call that is not donated is left as it was."""
    _, tcfg = configs()
    _, arrays = _start(configs()[0])
    fn = t_batch.make_batched_step_fn(tcfg, 2, True, device="cpu")
    x = bridge.world_from_numpy(arrays, device="cpu")
    a = fn(x)
    kept = {f.name: getattr(a, f.name).clone() for f in dataclasses.fields(a)}
    (capture,) = fn.graphs.captures.values()
    b = fn.graphs(a, None, 2, False)[0] if hand_back else fn(x)
    for name, value in kept.items():
        assert torch.equal(getattr(a, name), value), name
    assert a.pos.data_ptr() != capture.carry[0].data_ptr()
    assert int(b.tick[0]) == (4 if hand_back else 2)
    if not hand_back:
        assert torch.equal(b.pos, a.pos)        # the same input, stepped
        c = fn(b)                               # handed back: in place
        assert c.pos.data_ptr() == b.pos.data_ptr()
        assert int(c.tick[0]) == int(b.tick[0]) == 4


def test_donated_aux_is_not_overwritten(cpu_graphs):
    fn = graphs.Graphed(lambda c, _: (c + 1, c * 2))
    c1, aux1 = fn(torch.zeros(3), None, 2)
    c2, aux2 = fn(c1, None, 2)
    assert torch.equal(aux1, torch.full((3,), 2.0))
    assert torch.equal(aux2, torch.full((3,), 6.0))
    assert torch.equal(c2, torch.full((3,), 4.0))


def test_new_shape_captures_anew(cpu_graphs):
    _, tcfg = configs()
    _, arrays = _start(configs()[0])
    fn = t_batch.make_batched_step_fn(tcfg, 2, True, unroll=2, device="cpu")
    made = FakeGraph.made
    fn(bridge.world_from_numpy(arrays, device="cpu"))
    fn(bridge.world_from_numpy(arrays, device="cpu"))
    assert FakeGraph.made == made + 1 and len(fn.graphs.captures) == 1
    small = {k: v[:2] for k, v in arrays.items()}
    fn(bridge.world_from_numpy(small, device="cpu"))
    assert FakeGraph.made == made + 2 and len(fn.graphs.captures) == 2


def test_cache_is_bounded_and_frees_the_evicted(cpu_graphs, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    graphs.release_all()
    fn = graphs.Graphed(lambda c, _: (c + 1, None))
    for n in (1, 2, 3):
        fn(torch.zeros(n))
    assert graphs.live_graphs() == 2
    assert sorted(k[2][0][0] for k in fn.captures) == [(2,), (3,)]


@pytest.mark.parametrize("solver,joints,graphed,read", [
    ("JACOBI", False, True, None),
    ("JACOBI", True, True, None),
    ("PGS", False, True, None),
    ("DANTZIG", False, True, None),
    ("PGS", True, True, None),
    ("DANTZIG", True, True, None),
])
def test_capturable(solver, joints, graphed, read):
    config = EngineConfig(solver=SolverKind[solver])
    table = joint_ops.empty_joints(2, device="cpu") if joints else None
    ok, reason = graphs.capturable(config, table)
    assert ok is graphed
    if read is None:
        assert reason == ""
    else:
        assert read in reason and "host" in reason
    fn = t_batch.make_batched_step_fn(config, device="cuda", joints=table)
    assert fn.graphed is graphed and fn.eager_reason == reason
    cpu_fn = t_world.make_step_fn(config, joints=table)
    assert cpu_fn.graphed is (graphed and torch.cuda.is_available())


class _Counter:
    def __init__(self):
        self.launches = 0


def test_launch_count_bookkeeping():
    counters = {"a": _Counter(), "b": _Counter()}
    before = graphs.read_counts(counters)
    counters["a"].launches += 3
    added = graphs.counts_added(before, graphs.read_counts(counters))
    assert added == {"a": 3}
    graphs.set_counts(counters, before)
    assert graphs.read_counts(counters) == {"a": 0, "b": 0}
    graphs.credit(counters, added, times=5)
    assert graphs.read_counts(counters) == {"a": 15, "b": 0}


class CountingGraph(FakeGraph):
    """A stand-in whose capture runs the function as a capture does: the
    Python wrappers run (and count), the kernels do not."""

    def __init__(self, fn, device, pool=None):
        super().__init__(fn, device, pool)
        FakeGraph.capturing = True
        try:
            fn()
        finally:
            FakeGraph.capturing = False


@pytest.mark.parametrize("steps,unroll", [(7, 1), (7, 3), (7, 7), (8, 4)])
def test_replays_add_what_their_capture_counted(cpu_graphs, monkeypatch,
                                                steps, unroll):
    """A body that launches one counted kernel: the warm-up's and the
    captures' counts are taken back, and each replay adds its capture's."""
    counter = _Counter()
    monkeypatch.setattr(graphs, "kernel_counters", lambda: {"k": counter})
    monkeypatch.setattr(graphs, "GRAPH", CountingGraph)

    def body(carry, _):
        if FakeGraph.capturing:         # the wrapper runs, no kernel does
            counter.launches += 1
            return carry, None
        return carry + 1, None          # a replay: the kernel runs

    fn = graphs.Graphed(body, unroll=unroll)
    out, _ = fn(torch.zeros(3), None, steps)
    assert torch.equal(out, torch.full((3,), float(steps)))
    assert counter.launches == steps
    fn(out, None, steps)
    assert counter.launches == 2 * steps


def test_diagnostics_step_is_the_eager_one(cpu_graphs):
    _, tcfg = configs()
    _, arrays = _start(configs()[0])
    start = t_batch.make_batched_step_fn(tcfg, 31, False, device="cpu")(
        bridge.world_from_numpy(arrays, device="cpu"))
    fn = t_world.make_diagnostics_step_fn(tcfg)
    state, metrics = fn(start)
    want_state, want = t_world.step_with_diagnostics(start, tcfg)
    assert torch.equal(state.pos, want_state.pos)
    assert set(metrics) == set(want)
    for name in want:
        assert torch.equal(metrics[name], want[name]), name
    assert int(metrics["num_contacts"].max()) > 0


@pytest.fixture
def no_bench_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.syspath_prepend(str(REPO))
    sys.modules.pop("bench", None)


@pytest.mark.parametrize("route", ["graphs", "eager"])
def test_measure_at_jax_defaults_matches_jax_measure(request, no_bench_env,
                                                     route):
    """``_measure`` at the JAX bench's ``BENCH_UNROLL=4`` and donation,
    4 launches of 8 substeps (past the landing), against the JAX
    ``_measure`` with the same arguments."""
    if route == "graphs":
        request.getfixturevalue("cpu_graphs")
    import bench as jax_bench
    from chip_smoke import last_batches
    s = dict(num_worlds=4, num_bodies=16, substeps=8, launches=1, chunk=0,
             unroll=4)
    with last_batches(jax_batch) as ref_last, \
            last_batches(t_batch) as got_last:
        _, _, ref_dynamic = jax_bench._measure(
            jax_bench.bench_config(16), *s.values())
        value, _, dynamic = bench._measure(bench.bench_config(16), **s,
                                           device="cpu")
    assert value > 0 and dynamic == ref_dynamic == 12
    ref = to_numpy(ref_last[-1][0])
    got = bridge.world_to_numpy(got_last[-1][0])
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow"):
        assert np.array_equal(got[name], ref[name]), name
    assert int(got["tick"][0]) == 32


def test_graphs_module_imports_only_torch_and_the_port():
    path = REPO / "rl_ode_physics_tpu_torch" / "utils" / "graphs.py"
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    third_party = roots - set(sys.stdlib_module_names)
    assert third_party == {"torch", "rl_ode_physics_tpu_torch"}, roots
