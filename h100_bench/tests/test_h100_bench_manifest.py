"""BENCHMARK.json against the contract's schema, and a cell, a traffic mix
and a per-layer metric added as files and manifest entries alone."""

from __future__ import annotations

import json
import shutil

import pytest

from benchlib import manifest


def test_manifest_is_valid():
    assert manifest.validate(manifest.load()) == []


def test_every_cell_resolves():
    bench = manifest.load()
    for cell in bench["workloads"]:
        cfg = manifest.config_of(bench, cell)
        traffic = manifest.traffic_of(cell)
        assert traffic["scene"] in cfg["scenes"]
        assert set(cfg["limits"])
        manifest.reference(cfg["reference"])
        for kind in ("per_layer",):
            for m in manifest.metrics_of(bench, cell["name"], kind):
                assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("name, ok", [
    ("arena64-hb8.settled-8192", True), ("_x", True), ("a" * 64, True),
    ("a" * 65, False), ("has space", False), ("a/b", False),
    ("a,b", False), ("-lead", False), ("µs", False)])
def test_name_characters(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit, ok", [
    ("body-steps/s", True), ("%", True), ("ms", True), ("kernels", True),
    ("tokens per s", False), ("a" * 17, False), ("µs", False), ("", False)])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


@pytest.mark.parametrize("breakage", [
    lambda b: b.pop("per_layer"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["end_to_end"][0].update(why="extra key"),
    lambda b: b["workloads"].append(dict(b["workloads"][0])),
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b.update(run_seconds=60),
    lambda b: b["per_layer"][0].update(moves="no_such_metric"),
    lambda b: b["end_to_end"].pop(),
    lambda b: b["command"].append("../outside.py"),
])
def test_validate_refuses(breakage):
    bench = manifest.load()
    breakage(bench)
    assert manifest.validate(bench)


def test_cell_mix_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a per-layer metric and
    a cell as new files and manifest entries, with no file edited."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "h100_bench")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}

    traffic = json.loads((tmp_path / "h100_bench/traffic/stack-1024.json")
                         .read_text())
    traffic.update(worlds=2048, pool_worlds=2048)
    (tmp_path / "h100_bench/traffic/stack-2048.json").write_text(
        json.dumps(traffic))
    (tmp_path / "h100_bench/metrics/kernels_named_gemm.py").write_text(
        "def read(ctx):\n"
        "    hits = [k for k in ctx.get('kernels', ()) if 'gemm' in k[0]]\n"
        "    return len(hits) or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(
        name="quickstep-f64.stack-2048", config="quickstep-f64",
        traffic="stack-2048", chips=1, why="twice the stack cell's worlds"))
    bench["per_layer"].append(dict(
        name="kernels_named_gemm", unit="kernels", better="lower",
        source="device_trace", layer="step pipeline (core.world and its ops)",
        moves="body_steps_per_s", workloads=["quickstep-f64.stack-2048"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert (tmp_path / path).read_bytes() == data

    loaded = manifest.load(tmp_path)
    assert manifest.validate(loaded, tmp_path) == []
    cell = manifest.cell(loaded, "quickstep-f64.stack-2048")
    assert manifest.traffic_of(cell, tmp_path)["worlds"] == 2048
    assert manifest.config_of(loaded, cell, tmp_path)["name"] == \
        "quickstep-f64"
    names = [m["name"] for m in manifest.metrics_of(
        loaded, cell["name"], "per_layer")]
    assert "kernels_named_gemm" in names
    assert "compact_rows_ms_per_substep" not in names
    read = manifest.reader("kernels_named_gemm", tmp_path)
    assert read({"kernels": [("sm90_gemm_x", 0.0, 1.0)]}) == 1
    assert read({"kernels": []}) is None
