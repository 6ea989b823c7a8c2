"""``BENCHMARK.json``: its schema, and what a cell's name leads to.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:

* ``h100_bench/configs/<config>.json``: the engine's fields, the scenes and
  the name of the plain reference (``h100_bench/reference/<name>.py``);
* ``h100_bench/traffic/<traffic>.json``: the batch, the call length, the
  resets and the seeded content, read by the one generator in
  ``benchlib.traffic``;
* ``h100_bench/metrics/<metric>.py``: a reader with ``read(ctx)`` that
  returns the metric's value, or None where it finds nothing to read.

So a cell, a mix or a metric is added as new files and manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text, what: str, errors: list) -> None:
    if (not isinstance(text, str) or not 1 <= len(text) <= 200
            or "\n" in text or "\t" in text):
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(manifest: dict, root: Path = ROOT) -> list:
    """The contract's rules that a file can be checked against alone; the
    list of what breaks them (empty: none)."""
    errors = []
    if set(manifest) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(manifest)} != "
                      f"{sorted(TOP_KEYS)}")
        return errors
    paths = manifest["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths: 1 to 16 directories")
        paths = []
    for p in paths:
        if (not PATH_RE.match(p) or p.startswith("/")
                or ".." in p.split("/")):
            errors.append(f"path {p!r} is not a plain relative path")
    command = manifest["command"]
    if not (isinstance(command, list) and 1 <= len(command) <= 32):
        errors.append("command: a list of 1 to 32 strings")
        command = []
    for word in command:
        _line(word, f"command word {word!r}", errors)
        if isinstance(word, str) and (word.startswith("/")
                                      or ".." in word.split("/")):
            errors.append(f"command word {word!r} leaves the repo")
        if (isinstance(word, str) and "/" in word
                and not any(word == p or word.startswith(p.rstrip("/") + "/")
                            for p in paths)):
            errors.append(f"command word {word!r} names a file outside "
                          f"paths")
    rs = manifest["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")

    names = []
    configs = {}
    if not 1 <= len(manifest["configs"]) <= 24:
        errors.append("configs: 1 to 24 entries")
    for c in manifest["configs"]:
        if set(c) != CONFIG_KEYS:
            errors.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        configs[c["name"]] = c
        names.append(("config", c["name"]))
        _line(c["source"], f"config {c['name']} source", errors)
        _line(c["why"], f"config {c['name']} why", errors)
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            errors.append(f"config {c['name']}: file outside paths")
        elif not (Path(root) / c["file"]).is_file():
            errors.append(f"config {c['name']}: {c['file']} is missing")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16):
            errors.append(f"config {c['name']}: reduced, at most 16 keys")
        for key in c["reduced"]:
            if not NAME_RE.match(key):
                errors.append(f"config {c['name']}: reduced key {key!r}")
    files = [c["file"] for c in configs.values()]
    if len(set(files)) != len(files):
        errors.append("two configurations share a file")

    cells = manifest["workloads"]
    if not 1 <= len(cells) <= 24:
        errors.append("workloads: 1 to 24 cells")
    pairs = set()
    used = set()
    four = 0
    for w in cells:
        if set(w) != CELL_KEYS:
            errors.append(f"cell {w.get('name')}: keys {sorted(w)}")
            continue
        names.append(("cell", w["name"]))
        _line(w["why"], f"cell {w['name']} why", errors)
        if w["config"] not in configs:
            errors.append(f"cell {w['name']}: no configuration "
                          f"{w['config']!r}")
        used.add(w["config"])
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"cell {w['name']}: its pair appears twice")
        pairs.add((w["config"], w["traffic"]))
        if not NAME_RE.match(str(w["traffic"])):
            errors.append(f"cell {w['name']}: traffic name")
        if w["chips"] not in (1, 4):
            errors.append(f"cell {w['name']}: chips 1 or 4")
        four += w["chips"] == 4
    if four > max(1, len(cells) // 4):
        errors.append("more cells on four chips than the contract allows")
    for name in set(configs) - used:
        errors.append(f"configuration {name} is used by no cell")

    e2e = manifest["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        errors.append("end_to_end: 1 to 16 metrics")
    cell_names = {w.get("name") for w in cells}
    e2e_names = set()
    for m in e2e:
        extra = set(m) - E2E_KEYS
        if not E2E_KEYS <= set(m) or extra - {"workloads"}:
            errors.append(f"metric {m.get('name')}: keys {sorted(m)}")
            continue
        names.append(("metric", m["name"]))
        e2e_names.add(m["name"])
        if m["source"] not in ("host_clock", "device_trace"):
            errors.append(f"metric {m['name']}: an end-to-end metric's "
                          f"source is host_clock or device_trace")
        b = m["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errors.append(f"metric {m['name']}: bound from 0.01 to 0.25")
    if "setup_s" not in e2e_names:
        errors.append("no setup_s metric")
    layers = manifest["per_layer"]
    if not 1 <= len(layers) <= 128:
        errors.append("per_layer: 1 to 128 metrics")
    for m in layers:
        extra = set(m) - LAYER_KEYS
        if not LAYER_KEYS <= set(m) or extra - {"workloads"}:
            errors.append(f"metric {m.get('name')}: keys {sorted(m)}")
            continue
        names.append(("metric", m["name"]))
        _line(m["layer"], f"metric {m['name']} layer", errors)
        if m["moves"] not in e2e_names:
            errors.append(f"metric {m['name']}: moves {m['moves']!r}, no "
                          f"end-to-end metric")
        if m["source"] not in SOURCES:
            errors.append(f"metric {m['name']}: source {m['source']!r}")
    for m in e2e + layers:
        if not isinstance(m, dict) or "name" not in m:
            continue
        if not UNIT_RE.match(str(m.get("unit", ""))):
            errors.append(f"metric {m['name']}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            errors.append(f"metric {m['name']}: better lower or higher")
        for w in m.get("workloads", []):
            if w not in cell_names:
                errors.append(f"metric {m['name']}: no cell {w!r}")
    for kind, name in names:
        if not NAME_RE.match(str(name)):
            errors.append(f"{kind} name {name!r}")
    for kind in ("config", "cell", "metric"):
        seen = [n for k, n in names if k == kind]
        if len(set(seen)) != len(seen):
            errors.append(f"two {kind}s share a name")
    return errors


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_of(manifest: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == cell_entry["config"]:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell_entry['config']!r}")


def traffic_of(cell_entry: dict, root: Path = ROOT) -> dict:
    path = (Path(root) / "h100_bench" / "traffic"
            / f"{cell_entry['traffic']}.json")
    with open(path) as f:
        return json.load(f)


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric_name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``h100_bench/metrics/<metric_name>.py``."""
    folder = Path(root) / "h100_bench" / "metrics"
    if str(folder) not in sys.path:
        sys.path.insert(0, str(folder))
    return load_module(folder / f"{metric_name}.py",
                       f"h100_bench_metric_{metric_name}").read


def reference(name: str, root: Path = ROOT):
    """The plain reference module ``h100_bench/reference/<name>.py``."""
    folder = Path(root) / "h100_bench" / "reference"
    if str(folder) not in sys.path:
        sys.path.insert(0, str(folder))
    return load_module(folder / f"{name}.py", f"h100_bench_reference_{name}")
