"""Tracing inside the port's step (``utils/tracing.py``) and the benchmark's
readers of it.

On the CPU the stamps take the host's clock and the counters sum on the
host, through the same calls the card's kernels serve: the stage names of
every pipeline in order and their counts, tracing off against on op for
op, the capture key and the host spans on the graph tests' stand-ins, the
counters against ``step_with_diagnostics``, and each reader of
``h100_bench/metrics`` on a record made by hand. The tests marked ``cuda``
run the stamps inside a captured graph on the card:

    python -m pytest tests/test_torch_tracing.py -m cuda -q
"""

import collections
import contextlib
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rl_ode_physics_tpu_torch.core import world
from rl_ode_physics_tpu_torch.core.config import (
    EngineConfig, SolverKind, bench_config)
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.parallel.batch import (
    make_batched_step_fn, replicate)
from rl_ode_physics_tpu_torch.utils import graphs, tracing

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

STACK = dict(max_bodies=12, max_pair_candidates=64, max_contacts=128)
CONF = dict(max_bodies=16, max_pair_candidates=128, max_contacts=256)
TAIL = ["compact", "forces", "solve.rows", "solve.iterate", "integrate"]

# pipeline → the stamps of one substep, in order
ORDERS = {
    "typed-cm": ["start"] + ["pairs", "collide"] * 3 + TAIL,
    "typed-row-major": ["start"] + ["pairs", "collide"] * 3 + TAIL,
    "classic": ["start", "pairs", "collide"] + TAIL,
    "pgs": ["start", "pairs", "collide"] + TAIL,
    "dantzig": ["start", "pairs", "collide"] + TAIL,
    "mesh": ["start", "mesh", "pairs", "collide"] + TAIL,
    "joints": ["start", "joints", "pairs", "collide", "compact", "joints",
               "forces", "solve.rows", "solve.iterate", "integrate"],
    "dense": ["start", "collide", "forces", "solve.iterate", "integrate"],
}


def _scene(name):
    """(config, batch of 2 worlds, step kwargs) of a pipeline, settled a
    few substeps so that it has contacts."""
    mesh = joints = None
    if name in ("typed-cm", "typed-row-major"):
        config = bench_config(16)
        if name == "typed-row-major":
            config = config.replace(cm_narrowphase=False)
        state = scenes.bench_world(config, num_bodies=12, device="cpu")
        settle = 40
    elif name in ("classic", "dense"):
        config = EngineConfig(**STACK, dense_pipeline=name == "dense")
        state, settle = scenes.mini_stack_world(config, device="cpu"), 48
    elif name in ("pgs", "dantzig"):
        config = EngineConfig.conformance(
            **CONF, solver=SolverKind.PGS if name == "pgs"
            else SolverKind.DANTZIG)
        state, settle = scenes.mini_stack_world(config, device="cpu"), 48
    elif name == "mesh":
        config = EngineConfig.conformance(**CONF)
        state, mesh = scenes.ridge_mesh_scene(config, device="cpu")
        settle = 20
    else:
        config = EngineConfig.conformance(**CONF)
        state, joints = scenes.hinge_chain_scene(config, device="cpu")
        settle = 8
    kw = dict(trimesh=mesh, joints=joints)
    batch = make_batched_step_fn(config, substeps=settle, device="cpu",
                                 **kw)(replicate(state, 2, device="cpu"))
    return config, batch, kw


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()


@pytest.mark.parametrize("name", list(ORDERS))
def test_stage_order_and_counts(name):
    config, batch, kw = _scene(name)
    with tracing.recording("cpu"):
        for _ in range(2):
            batch = world._step_impl(batch, config, kw["trimesh"],
                                     joints=kw["joints"])
        rec = tracing.read()
    assert rec["order"] == ORDERS[name]
    want = collections.Counter(ORDERS[name])
    for stamp in tracing.STAMPS:
        assert rec["stamps"][stamp] == 2 * want[stamp], stamp
    for stage in tracing.STAGES[1:]:
        assert (rec["stages_ns"][stage] > 0) == bool(want[stage]), stage
    # the second substep's start closes the gap after the first's last
    # stamp; the first start after enable closes none
    assert rec["outside_gaps"] == 1
    assert rec["counters"]["world_substeps"] == 2 * batch.num_worlds


class OpLog(TorchDispatchMode):
    """The aten ops dispatched, less those tracing runs for itself."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not tracing.own:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["typed-cm", "classic", "pgs", "dantzig",
                                  "dense"])
def test_tracing_off_adds_no_op(name):
    """One eager substep dispatches the same ops with tracing off as with
    tracing on, less the counters' own sums: the stamps and the spans add
    none, and nothing else runs only for the trace."""
    config, batch, _ = _scene(name)
    logs = []
    for on in (False, True):
        traced = tracing.recording("cpu") if on else contextlib.nullcontext()
        with traced, OpLog() as log:
            world.step(batch, config)
        logs.append(log.ops)
    assert logs[0] == logs[1]
    assert len(logs[0]) > 100


class RunningGraph:
    """A CUDA graph's stand-in whose capture runs the function once, as a
    capture runs the Python (here the CPU's stamps too), and whose replay
    runs it again."""

    def __init__(self, fn, device, pool=None):
        self.fn, self.nodes = fn, 500
        fn()

    def pool(self):
        return None

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


@pytest.fixture
def cpu_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "GRAPH", RunningGraph)
    monkeypatch.setattr(graphs, "WARM_UP", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "on_card",
                        lambda tensor: graphs.graphs_enabled())
    monkeypatch.setattr(graphs, "for_card", lambda device: True)
    yield
    graphs.release_all()


def test_capture_key_holds_the_tracing_state(cpu_graphs):
    """A step captured with tracing off is not replayed with tracing on,
    and the other way round: each state has its own capture."""
    config, batch, _ = _scene("classic")
    fn = make_batched_step_fn(config, substeps=2, unroll=2, donate=False,
                              device="cpu")
    fn(batch)
    assert [k[-1] for k in fn.graphs.captures] == [False]
    with tracing.recording("cpu"):
        fn(batch)
        fn(batch)
        rec = tracing.read()
    assert [k[-1] for k in fn.graphs.captures] == [False, True]
    fn(batch)
    assert len(fn.graphs.captures) == 2
    # the stamped graph: 2 substeps, one closing stamp after the carry's
    # copy; its note counts the stamps and counter nodes it holds
    note = rec["graphs"][-1]
    per_stamp = collections.Counter(ORDERS["classic"] * 2 + ["integrate"])
    assert note == {"nodes": 500, "stamps": sum(per_stamp.values()),
                    "counter_nodes": 2 * 5, "substeps": 2,
                    "per_stamp": dict(per_stamp)}
    # the warm-up's substep, the capture's run and two replays ran the
    # stamps; each call made three host spans
    assert rec["stamps"]["start"] == 1 + 3 * 2
    assert {k: v["count"] for k, v in rec["spans"].items()} == {
        "prepare": 2, "launch": 2, "hand_out": 2}


def test_only_a_closing_stamp_named_ends_a_graph(cpu_graphs):
    """A ``Graphed`` that names no closing stamp (not a step: a control
    step's or a rollout's body) captures no stamp of its own."""
    fn = graphs.Graphed(lambda c, _: (c + 1, None))
    with tracing.recording("cpu"):
        fn(torch.zeros(3), None, 2)
        rec = tracing.read()
    assert rec["graphs"][-1]["stamps"] == 0
    assert rec["stamps"] == {s: 0 for s in tracing.STAMPS}


def test_a_recording_inside_another_is_refused():
    """A nested recording raises and leaves the outer record as it was."""
    config, batch, _ = _scene("classic")
    with tracing.recording("cpu"):
        world.step(batch, config)
        before = tracing.read()
        with pytest.raises(RuntimeError, match="on already"):
            with tracing.recording("cpu"):
                pass
        assert tracing.enabled()
        after = tracing.read()
    assert not tracing.enabled()
    assert after["stamps"] == before["stamps"]
    assert after["stages_ns"] == before["stages_ns"]
    assert after["counters"] == before["counters"]
    assert before["stamps"]["start"] == 1


def test_host_spans_open_profiler_ranges(cpu_graphs):
    """Under an active profiler the host spans are ``record_function``
    ranges named ``rl_ode.<span>``, on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile
    config, batch, _ = _scene("classic")
    fn = make_batched_step_fn(config, substeps=1, donate=False,
                              device="cpu")
    with tracing.recording("cpu"):
        fn(batch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn(batch)
    names = [e.name for e in prof.events()]
    for span in ("prepare", "launch", "hand_out"):
        assert names.count(tracing.SPAN_PREFIX + span) == 1, span


def test_outside_gaps_go_under_the_open_host_span():
    tracing.enable("cpu")
    tracing.reset()
    t = time.perf_counter_ns()
    tracing._spans.extend([("prepare", t, t + 100), ("launch", t + 100,
                                                     t + 300)])
    acc = tracing._acc.numpy().copy()
    gaps = [(t + 10, t + 50), (t + 150, t + 250), (t + 400, t + 500)]
    acc[tracing._GAPS] = len(gaps)
    for i, (g0, g1) in enumerate(gaps):
        acc[tracing._GAPS + 1 + 2 * i:tracing._GAPS + 3 + 2 * i] = g0, g1
    assert tracing._outside_by_span(acc, 0) == {
        "prepare": 40, "launch": 100, "caller": 100}
    # a device clock ahead of the host's by 1,000 ns
    shifted = acc.copy()
    shifted[tracing._GAPS + 1:tracing._GAPS + 7] += 1000
    assert tracing._outside_by_span(shifted, 1000) == {
        "prepare": 40, "launch": 100, "caller": 100}


@pytest.mark.parametrize("name", ["typed-cm", "classic", "dense"])
def test_counters_equal_the_diagnostics(name):
    """``pairs_tested`` and ``contact_rows`` are the sums of
    ``step_with_diagnostics``' ``num_pairs`` and ``num_contacts``, and
    ``rows_dropped`` the rise of ``overflow``, over a few substeps; the
    classic pipeline at 2 rows drops some."""
    config, batch, _ = _scene(name)
    if name == "classic":
        config = config.replace(max_contacts=2)
    pairs = contacts = 0
    before = int(batch.overflow.sum())
    with tracing.recording("cpu"):
        for _ in range(3):
            batch, m = world.step_with_diagnostics(batch, config)
            pairs += int(m["num_pairs"].sum())
            contacts += int(m["num_contacts"].sum())
        rec = tracing.read()
    c = rec["counters"]
    assert c["pairs_tested"] == pairs > 0
    assert c["contact_rows"] == contacts > 0
    assert c["rows_dropped"] == int(batch.overflow.sum()) - before
    if name == "classic":
        assert c["rows_dropped"] > 0
    if name != "dense":
        assert 0 < c["candidate_rows"] < c["candidate_slots"]
    assert c["world_substeps"] == 3 * batch.num_worlds


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------

def _record():
    """A record as ``tracing.read`` makes it, of 4 substeps in 2 calls."""
    ms = 1_000_000
    return {
        "stages_ns": {"outside": 2 * ms, "mesh": 0, "joints": 0,
                      "pairs": 4 * ms, "collide": 40 * ms,
                      "compact": 12 * ms, "forces": 2 * ms,
                      "solve.rows": 8 * ms, "solve.iterate": 28 * ms,
                      "integrate": 4 * ms},
        "stamps": dict({s: 0 for s in tracing.STAMPS}, start=4),
        "counters": {"pairs_tested": 800, "candidate_rows": 300,
                     "candidate_slots": 4000, "contact_rows": 240,
                     "rows_dropped": 0, "world_substeps": 16},
        "spans": {"prepare": {"ns": 100_000, "count": 2},
                  "launch": {"ns": 300_000, "count": 2},
                  "hand_out": {"ns": 200_000, "count": 2}},
        "graphs": [{"nodes": 7000, "stamps": 25, "counter_nodes": 10,
                    "substeps": 2}],
    }


READINGS = {
    "pairs_ms_per_substep": 1.0,
    "collide_ms_per_substep": 10.0,
    "compact_ms_per_substep": 3.0,
    "solve_rows_ms_per_substep": 2.0,
    "solve_iterate_ms_per_substep": 7.0,
    "integrate_ms_per_substep": 1.5,
    "device_idle_untraced_pct": 2.0,
    "step_host_ms_per_call": 0.3,
    "graph_nodes_per_substep": 3482.5,
    "pairs_per_world": 50.0,
    "contact_rows_per_world": 15.0,
    "compact_mask_density_pct": 7.5,
}


@pytest.mark.parametrize("name", list(READINGS))
def test_reader_reads_the_program_record(name):
    from benchlib import manifest
    read = manifest.reader(name)
    assert read({"program": _record()}) == pytest.approx(READINGS[name])
    # no record: the parent's runs, and every run with --trace 0
    assert read({}) is None
    assert read({"program": None}) is None
    assert read({"cell": "arena64-hb8.settled-8192", "kernels": []}) is None


def _pivot_context(counters):
    """A traced run's context of the DANTZIG cell: 4 traced substeps whose
    ``lcp_pivot`` kernels took 1 ms a substep, and a record of 8
    world-substeps with ``counters``."""
    rec = _record()
    rec["counters"] = dict(rec["counters"], world_substeps=8, **counters)
    return {"program": rec, "cell": "dantzig-f64.stack-1024",
            "traced_substeps": 4,
            "kernels": [("void lcp_pivot_large<double>", 0.0, 3000.0),
                        ("void lcp_pivot_warp<double>", 5000.0, 6000.0),
                        ("Memset (Device)", 6000.0, 9000.0),
                        ("pgs_solve_kernel", 9000.0, 19000.0)]}


PIVOT = {"lcp_valid_rows": 8 * 300, "lcp_valid_rows_sq": 8 * 300 ** 2,
         "lcp_valid_rows_cube": 8 * 300 ** 3, "lcp_active_rows": 8 * 250,
         "pivot_rounds": 8 * 5, "pivot_capped": 0}
# 1,024 worlds of V = 300: ⅔·V³ + 4·V² operations a world at 67 TFLOP/s
# (the bound: more than 8·V² + 17·V bytes at 3.35 TB/s), over 1 ms
PIVOT_READINGS = {
    "pivot_rounds_per_world": 5.0,
    "lcp_active_rows_per_world": 250.0,
    "lcp_pivot_roofline_pct": 100.0 * 1e3 * 1024
    * (2 / 3 * 300 ** 3 + 4 * 300 ** 2) / 67e12,
}


@pytest.mark.parametrize("name", list(PIVOT_READINGS))
def test_pivot_reader_reads_the_program_record(name):
    from benchlib import manifest
    read = manifest.reader(name)
    assert read(_pivot_context(PIVOT)) == pytest.approx(
        PIVOT_READINGS[name])
    # a program from before the pivot counters, and no record
    assert read(_pivot_context({})) is None
    assert read({}) is None
    bench = manifest.load()
    metric = next(m for m in bench["per_layer"] if m["name"] == name)
    assert metric["workloads"] == ["dantzig-f64.stack-1024"]
    assert metric["moves"] == "body_steps_per_s"


def test_manifest_lists_the_program_metrics():
    from benchlib import manifest
    bench = manifest.load()
    assert manifest.validate(bench) == []
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READINGS:
        assert layer[name]["source"] in ("program_span", "program_counter")
        assert "workloads" not in layer[name]
        for cell in bench["workloads"]:
            assert name in [m["name"] for m in manifest.metrics_of(
                bench, cell["name"], "per_layer")]


def test_record_request_starts_at_the_traced_calls():
    """The record's process gets the run's seed and runs the window's
    calls first, so that its loop reads the traced calls' worlds."""
    from benchlib import stages
    ctx = {"cell": "quickstep-f64.stack-1024", "call_ms": [52.0] * 947,
           "traced_substeps": 12}
    assert stages.request(ctx, 3000000007) == [
        "--workload", "quickstep-f64.stack-1024", "--seed", "3000000007",
        "--calls-before", "947"]


def test_a_failed_record_fails_the_run(monkeypatch):
    """Where the program has tracing and a card, a record process that
    fails raises; with no card, or a program without tracing, there is no
    record and the readers read None."""
    import subprocess
    from benchlib import stages
    ctx = {"cell": "arena64-hb8.settled-8192", "call_ms": [1.0] * 4,
           "traced_substeps": 8}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stages.program(dict(ctx)) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
            a[0], 1, stdout=""))
    with pytest.raises(RuntimeError, match="exit 1"):
        stages.program(dict(ctx))
    import importlib.util
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert stages.program(dict(ctx)) is None


def test_run_seed_is_the_command_line_seed():
    from benchlib import stages
    assert stages.run_seed(["--workload", "x", "--seed", "3000000007",
                            "--trace", "1"]) == 3000000007
    assert stages.run_seed(["--workload", "x"], default=5) == 5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the stamps are kernels)")
    return torch.device("cuda", 0)


def _card_step(worlds=1024, substeps=2):
    """A settled bench batch on the card and its step of ``substeps``."""
    config = bench_config(64)
    batch = replicate(scenes.bench_world(config, device="cuda"), worlds,
                      device="cuda")
    batch = make_batched_step_fn(config, substeps=96, device="cuda")(batch)
    fn = make_batched_step_fn(config, substeps=substeps, unroll=substeps,
                              device="cuda")
    return fn, batch


@pytest.mark.cuda
def test_card_replays_count_replays_times_stamps():
    dev = _card()
    fn, batch = _card_step()
    with tracing.recording(dev):
        batch = fn(batch)                   # captures
        tracing.reset()
        for _ in range(7):
            batch = fn(batch)
        rec = tracing.read()
    note = rec["graphs"][-1]
    assert note["substeps"] == 2
    for stamp in tracing.STAMPS:
        assert rec["stamps"][stamp] == 7 * note["per_stamp"].get(
            stamp, 0), stamp
    assert sum(rec["stamps"].values()) == 7 * note["stamps"]
    assert rec["counters"]["world_substeps"] == 7 * 2 * 1024


@pytest.mark.cuda
def test_card_stages_and_outside_sum_to_the_wall_time():
    dev = _card()
    fn, batch = _card_step()
    with tracing.recording(dev):
        batch = fn(batch)
        tracing.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(20):
            batch = fn(batch)
            torch.cuda.synchronize()
        wall = time.perf_counter_ns() - t0
        rec = tracing.read()
    stamped = sum(rec["stages_ns"].values())
    assert abs(stamped - wall) <= 0.02 * wall, (stamped, wall)


@pytest.mark.cuda
def test_card_untraced_graph_is_the_traced_one_less_the_stamps():
    dev = _card()
    fn, batch = _card_step()
    batch = fn(batch)
    with tracing.recording(dev):
        batch = fn(batch)
    stats = {key[-1]: c.nodes()[2] for key, c in fn.graphs.captures.items()}
    note = tracing.read()["graphs"][-1]
    assert note["nodes"] == stats[True]
    assert stats[False] == (stats[True] - note["stamps"]
                            - note["counter_nodes"])


@pytest.mark.cuda
def test_card_host_span_encloses_the_converted_stamp():
    dev = _card()
    with tracing.recording(dev):
        for _ in range(5):
            with tracing.span("probe"):
                tracing.stamp("integrate")
                torch.cuda.synchronize()
            device_ns = int(tracing._acc[0])
            _, t0, t1 = tracing._spans[-1]
            host = device_ns - tracing._clock["offset_ns"]
            unc = tracing._clock["uncertainty_ns"]
            assert t0 - unc <= host <= t1 + unc, (t0, host, t1, unc)


@pytest.mark.cuda
def test_card_counters_equal_the_diagnostics():
    """The ``stage_count`` kernels against the diagnostics' sums, on the
    card, over a captured diagnostics step's replays."""
    dev = _card()
    _, batch = _card_step(worlds=256)
    config = bench_config(64)
    fn = world.make_diagnostics_step_fn(config)
    pairs = contacts = 0
    with tracing.recording(dev):
        fn(batch)
        tracing.reset()
        for _ in range(3):
            batch, m = fn(batch)
            pairs += int(m["num_pairs"].sum())
            contacts += int(m["num_contacts"].sum())
        rec = tracing.read()
    c = rec["counters"]
    assert c["pairs_tested"] == pairs > 0
    assert c["contact_rows"] == contacts > 0
    assert c["world_substeps"] == 3 * 256
    assert 0 < c["candidate_rows"] < c["candidate_slots"]


def test_stage_record_of_a_tiny_cell_feeds_every_reader(monkeypatch):
    """``benchlib.stages.record`` on a cell cut to 4 worlds on the CPU:
    the closed loop's calls, one record, and every reader reads it."""
    import json
    from benchlib import manifest, stages
    monkeypatch.setattr(stages, "SECONDS", 0.2)
    with open(BENCH / "configs" / "arena64-hb8.json") as f:
        cfg = json.load(f)
    traffic = manifest.traffic_of({"traffic": "settled-8192"})
    traffic.update(worlds=4, pool_worlds=4, warmup_substeps=8)
    rec = stages.record(cfg, traffic, 3000000011, "cpu")
    assert rec["calls"] >= stages.MIN_CALLS
    assert rec["stamps"]["start"] == 2 * rec["calls"]
    assert rec["counters"]["world_substeps"] == 4 * 2 * rec["calls"]
    assert rec["spans"] == {}            # the CPU's step is not graphed
    assert not tracing.enabled()
    for name in READINGS:
        value = manifest.reader(name)({"program": rec})
        if name in ("step_host_ms_per_call", "graph_nodes_per_substep"):
            assert value is None, name
        else:
            assert value is not None and value >= 0, name
