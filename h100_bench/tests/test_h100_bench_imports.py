"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program: top-level names compared
whole, since the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from benchlib import checks, manifest

PROGRAM = "rl_ode_physics_tpu_torch"


def _top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(p for p in manifest.BENCH_DIR.rglob("*.py")
                  if "tests" not in p.parts)


def test_forbidden_names_are_compared_whole():
    assert checks.forbidden_modules([PROGRAM, PROGRAM + ".core",
                                     "numpy", "jaxtyping"]) == []
    assert checks.forbidden_modules(["jax.numpy"]) == ["jax"]
    assert checks.forbidden_modules(["rl_ode_physics_tpu.core"]) == [
        "rl_ode_physics_tpu"]
    assert checks.forbidden_modules(["flax", "jaxlib.xla"]) == [
        "flax", "jaxlib"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    assert not _top_level_imports(path) & set(checks.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((manifest.BENCH_DIR / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run of each configuration through the harness, in a process
    of its own, leaves no forbidden module in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import conftest\n"
        "from benchlib import checks\n"
        "for cell in ('arena64-hb8.settled-8192',"
        " 'quickstep-f64.stack-1024'):\n"
        "    conftest.tiny_run(cell, seconds=0.1, worlds=2, warm=2)\n"
        "print(checks.forbidden_modules())\n"
        % (str(manifest.BENCH_DIR / "tests"), str(manifest.BENCH_DIR)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A per-layer reader that imports ``jax`` after the window: the run
    prints no result and exits with another code than 0."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "h100_bench")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (tmp_path / "h100_bench" / "metrics" / "host_ms_per_call.py").write_text(
        "def read(ctx):\n"
        "    import jax  # noqa: F401\n"
        "    return 1.0\n")
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import run\n"
        "from benchlib import manifest\n"
        "root = run.Path(%r)\n"
        "bench = manifest.load(root)\n"
        "out = dict(trace={}, host_ms=[1.0], call_ms=[2.0])\n"
        "metrics = run.per_layer(bench, 'arena64-hb8.settled-8192', out,"
        " root)\n"
        "sys.exit(run.emit(dict(correct=True, metrics=metrics)))\n"
        % (str(tmp_path / "stub"), str(tmp_path / "h100_bench"),
           str(manifest.ROOT), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 4, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr
