"""The port's roofline, SAP cost analysis and orientation probe against the
JAX package's ``benchmarks/roofline.py``, ``sap_cost_analysis.py`` and
``orientation_probe.py``, on the CPU at small sizes.

The operation count (``utils/roofline.OpCount``) is held to hand counts: a
lone ``bmm`` moves (b·m·k + b·k·n + b·m·n)·4 bytes and does 2·b·m·k·n
flops in float32 or bf16, a view moves nothing, an in-place operation
reads and writes its tensor once each. On a substep of the bench the
flops double exactly with the batch and the bytes within 1% (a few
constants do not scale), and the matmul flops are at least
``bench.py:326``'s closed form of the solver's selector products; the
compaction kernel is booked once a substep by its bytes. ``roofline_model``
names the binding resource as the JAX script does; ``main`` prints the
JAX script's keys (read from its source) and the port's three. The SAP
census prints both rows and the ratio line. The orientation trip is held
to the JAX script's own loop body, for every probe shape at B=4, within
1e-6, and the probe list to the JAX script's nine calls (read with
``ast``).
"""

import ast
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch import bench
from rl_ode_physics_tpu_torch.models import scenes
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.utils import (
    bounds, orientation_probe, roofline, sap_cost_analysis)

from _torch_port import single_cpu_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# what utils/roofline adds to the JAX script's keys
ROOFLINE_ADDED = {"card", "ops/substep/chunk", "flops_counted"}
# the bytes of a substep that do not scale with the batch (scalars,
# the arena's constants): under 1% at B=2
BYTES_RTOL = 0.01
ORIENTATION_TRIPS = 3
ORIENTATION_WORLDS = 4
ORIENTATION_ATOL = 1e-6


def _count(fn):
    mode = roofline.OpCount()
    with mode:
        fn()
    return mode


@pytest.fixture
def no_bench_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_of_a_lone_bmm(dtype):
    b, m, k, n = 3, 4, 5, 6
    a = torch.ones((b, m, k), dtype=dtype)
    s = torch.ones((b, k, n), dtype=dtype)
    mode = _count(lambda: torch.bmm(a, s))
    size = a.element_size()
    assert mode.flops == 2 * b * m * k * n
    assert mode.bytes == (b * m * k + b * k * n + b * m * n) * size
    assert dict(mode.ops) == {"bmm": 1}


def test_a_view_adds_nothing_and_in_place_reads_and_writes():
    a = torch.ones((3, 4, 5))
    mode = _count(lambda: a.view(12, 5).transpose(0, 1))
    assert (mode.bytes, mode.flops, sum(mode.ops.values())) == (0, 0, 0)
    mode = _count(lambda: a.add_(1.0))
    assert mode.bytes == 2 * a.numel() * 4 and dict(mode.ops) == {"add_": 1}
    mode = _count(lambda: torch.zeros_like(a))
    assert mode.bytes == a.numel() * 4


def _bench_count(b, substeps=1):
    config = bench.bench_config(16)
    world = scenes.bench_world(config, num_bodies=12, device="cpu")
    return config, roofline.count_substeps(
        config, replicate(world, b, device="cpu"), substeps)


def test_substep_count_scales_with_the_batch(no_bench_env):
    config, two = _bench_count(2)
    _, four = _bench_count(4)
    assert four["flops"] == 2 * two["flops"] > 0
    assert abs(four["bytes"] / two["bytes"] - 2) <= 2 * BYTES_RTOL
    assert two["ops"] == four["ops"]
    assert two["flops"] >= bench.solver_flops(config) * 2
    assert four["flops"] >= bench.solver_flops(config) * 4


def test_compaction_booked_once_a_substep_by_its_bytes(no_bench_env,
                                                      monkeypatch):
    """The kernel's wrapper is booked once a substep, with
    ``bounds.compaction_bytes`` on the mask and payload it was handed, and
    is restored after the count."""
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    wrapper = compaction_kernel.compact_rows_t
    calls = []

    def caught(mask, payload_t, k, sel_dtype=None):
        calls.append(bounds.compaction_bytes(
            mask, payload_t.shape[1], k, payload_t.element_size()))
        return wrapper(mask, payload_t, k, sel_dtype)

    caught.launches = 0
    monkeypatch.setattr(compaction_kernel, "compact_rows_t", caught)
    _, count = _bench_count(2, substeps=2)
    assert count["ops"]["compact_rows_t"] == len(calls) == 2
    assert count["op_bytes"]["compact_rows_t"] == sum(calls)
    assert compaction_kernel.compact_rows_t is caught
    mask = torch.zeros((2, 384), dtype=torch.bool)
    assert bounds.compaction_bytes(mask, 10, 64) == 2 * 384 + 2 * (
        4 * 10 * 64 + 64 + 8)
    mask[:, :100] = True
    assert bounds.compaction_bytes(mask, 10, 64) == 2 * 384 + 2 * (
        4 * 10 * 64 + 64 + 8) + 4 * 10 * 2 * 64


@pytest.mark.parametrize("case,want", [
    (dict(bytes_sub=3.35e10, flops_sub=1e9, floor_sub=1e-3), "bytes"),
    (dict(bytes_sub=1e6, flops_sub=6.7e12, floor_sub=1e-3), "flops"),
    (dict(bytes_sub=1e6, flops_sub=1e6, floor_sub=0.04), "op-floor"),
])
def test_roofline_model_names_the_bound(case, want):
    out = roofline.roofline_model(
        case["bytes_sub"], case["flops_sub"], 0.05, case["floor_sub"],
        worlds=8192, chunk=8192, dynamic=60,
        bw_gbs=bounds.HBM_BYTES_PER_S / 1e9,
        peak_tflops=bounds.FP32_OPS_PER_S / 1e12)
    assert out["bound"] == want
    t_stream = max(out["t_bytes_ms"], out["t_flops_ms"])
    assert out["t_model_ms"] == pytest.approx(t_stream + out["t_floor_ms"])
    assert out["ceiling_body_steps_per_sec"] == pytest.approx(
        8192 * 60 / (out["t_model_ms"] / 1e3))
    assert out["measured_over_model"] == pytest.approx(
        50.0 / out["t_model_ms"])


def _dict_keys(path: Path, target: str) -> set:
    """The constant keys of the dict literal assigned to ``target`` in a
    script."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            if ast.unparse(node.targets[0]) == target:
                keys |= {k.value for k in node.value.keys}
    return keys


def test_roofline_main_prints_the_jax_keys(no_bench_env, monkeypatch,
                                           capsys):
    for key, value in (("BENCH_BODIES", "16"), ("BENCH_WORLDS", "4"),
                       ("BENCH_SUBSTEPS", "1")):
        monkeypatch.setenv(key, value)
    assert roofline.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    decoder, rows, at = json.JSONDecoder(), [], 0
    while out[at:].strip():
        row, at = decoder.raw_decode(out, out.index("{", at))
        rows.append(row)
    jax_keys = _dict_keys(REPO / "benchmarks" / "roofline.py", "out")
    assert len(jax_keys) == 17
    assert [r["config"] for r in rows] == ["headline hb-8", "parity plain-20"]
    for row in rows:
        assert set(row) == jax_keys | ROOFLINE_ADDED
        assert row["card"] == "cpu" and row["chunk"] == 4
        assert row["flops_counted"] == "matmul-family"
        assert row["bound"] in ("bytes", "flops", "op-floor")
        assert row["bytes/substep/chunk"] > 0 and row["ops/substep/chunk"] > 0


def test_sap_census_rows_and_ratio_line(no_bench_env, capsys):
    r = sap_cost_analysis.run(num_bodies=64, chunk=2, substeps=2, sap_w=16,
                              device="cpu")
    src = REPO / "benchmarks" / "sap_cost_analysis.py"
    jax_row = _dict_keys(src, "results[label]")
    assert "hlo_instructions" in jax_row and "fusion" in jax_row
    want = (jax_row - {"hlo_instructions", "fusion"}) | {"aten_ops", "cat"}
    for label in ("dense", "sap"):
        row = r[label]
        assert want <= set(row)
        assert row["overflow"] == 0 and row["substeps"] == 2
        assert row["aten_ops"] > 0 and row["bytes/substep"] > 0
    tree = ast.parse(src.read_text())
    ratio = {k.value for node in ast.walk(tree)
             if isinstance(node, ast.Dict)
             and any(getattr(k, "value", None) == "flops_ratio"
                     for k in node.keys)
             for k in node.keys}
    assert set(r["ratio"]) == ratio | {"cat_delta"}
    assert r["ratio"]["instr_delta"] == r["sap"]["aten_ops"] - \
        r["dense"]["aten_ops"]
    out = capsys.readouterr().out
    assert out.startswith("dense {") and "\nsap {" in out


@pytest.fixture(scope="module")
def jax_orientation():
    """``benchmarks/orientation_probe.py`` imported, with the repository's
    root on the path as the script puts it there."""
    root = str(REPO)
    sys.path.insert(0, root)
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        sys.modules.pop("orientation_probe", None)
        import orientation_probe as mod
        yield mod
    finally:
        sys.path.remove(root)
        sys.path.remove(str(REPO / "benchmarks"))


@pytest.mark.parametrize("index", range(len(orientation_probe.PROBES)))
def test_orientation_trip_matches_the_jax_body(jax_orientation, monkeypatch,
                                               index):
    """The JAX probe's own loop body, through its ``make_f``, for 3 trips at
    B=4: the port's chain within 1e-6 on the same inputs."""
    import jax
    _, label, _, m, kk, l = orientation_probe.PROBES[index]
    b = ORIENTATION_WORLDS
    caught = {}

    def slope(make_f, k1, k2, a, s):
        caught["ref"] = np.asarray(jax.jit(make_f(ORIENTATION_TRIPS))(a, s))
        return 1.0

    monkeypatch.setattr(jax_orientation, "slope", slope)
    jax_orientation.probe(label, b, m, kk, l)
    a, s = orientation_probe.inputs(b, m, kk, l, device="cpu")
    got = orientation_probe.chain(a, s, ORIENTATION_TRIPS).numpy()
    assert got.shape == caught["ref"].shape
    np.testing.assert_allclose(got, caught["ref"], rtol=0,
                               atol=ORIENTATION_ATOL)


def test_orientation_probes_are_the_jax_scripts():
    """The JAX script's ``probe(...)`` calls, in order, with ``B`` its
    value there."""
    tree = ast.parse((REPO / "benchmarks" / "orientation_probe.py")
                     .read_text())
    names = {node.targets[0].id: node.value.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and isinstance(node.targets[0], ast.Name)
             and isinstance(node.value, ast.Constant)}
    calls = [tuple(names[a.id] if isinstance(a, ast.Name) else a.value
                   for a in node.args)
             for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "probe"]
    assert len(calls) == 9
    assert [p[1:] for p in orientation_probe.PROBES] == calls


def test_orientation_run_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(orientation_probe, "PROBES", tuple(
        (head, label, 2, m, kk, l)
        for head, label, _, m, kk, l in orientation_probe.PROBES))
    r = orientation_probe.run(1, 2, iters=1, device="cpu")
    assert [p["label"] for p in r] == [p[1] for p in orientation_probe.PROBES]
    assert all(np.isfinite(p["ms_per_bmm"]) for p in r)
    assert capsys.readouterr().out.count("== ") == 5


@pytest.mark.parametrize("module", [bench, roofline, sap_cost_analysis,
                                    orientation_probe])
def test_entry_points_need_the_card_unless_asked(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        module.main([])
