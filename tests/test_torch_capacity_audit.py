"""The port's capacity audit and the bench's configurations against the JAX
package's ``bench.py`` and ``benchmarks/capacity_audit.py``.

``core/config.bench_config(n, parity)`` must equal ``bench.bench_config``
field by field with no ``BENCH_*`` variable set but
``BENCH_PALLAS_COMPACT=1`` (the compaction through the kernel, the same
numbers); ``capacity_signature`` must give the JAX script's string, a key
of ``benchmarks/audited_capacities.json``; ``audit_config`` must find the
JAX script's peaks and overflow exactly (they are counts).
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from rl_ode_physics_tpu_torch.core.config import bench_config
from rl_ode_physics_tpu_torch.utils import capacity_audit

from _torch_port import single_cpu_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(n, parity) for n in (64, 512) for parity in (False, True)]


@pytest.fixture
def jax_scripts(monkeypatch):
    """``bench`` and ``benchmarks/capacity_audit`` imported with every
    ``BENCH_*`` variable unset but ``BENCH_PALLAS_COMPACT=1``."""
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("BENCH_PALLAS_COMPACT", "1")
    monkeypatch.syspath_prepend(str(REPO / "benchmarks"))
    monkeypatch.syspath_prepend(str(REPO))
    for name in ("bench", "capacity_audit"):
        sys.modules.pop(name, None)
    import bench
    import capacity_audit as jax_audit
    return bench, jax_audit


def _fields(cfg) -> dict:
    return {f.name: (v.value if hasattr(v, "value") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("n,parity", SHAPES)
def test_bench_config_matches_bench_py(jax_scripts, n, parity):
    bench, _ = jax_scripts
    assert (_fields(bench_config(n, parity=parity))
            == _fields(bench.bench_config(n, parity=parity)))


@pytest.mark.parametrize("n,parity", SHAPES)
def test_capacity_signature_matches_jax_and_registry(jax_scripts, n, parity):
    bench, jax_audit = jax_scripts
    sig = capacity_audit.capacity_signature(bench_config(n, parity), n)
    assert sig == jax_audit.capacity_signature(
        bench.bench_config(n, parity=parity), n)
    registry = json.loads((REPO / "benchmarks" /
                           "audited_capacities.json").read_text())
    assert sig in registry
    assert capacity_audit.load_registry()[sig] == registry[sig]


def test_audit_config_matches_jax(jax_scripts):
    """16 slots, seeds 42 and 7, 48 substeps (both run one chunk of 50):
    the same live-contact peaks, bucket pair peaks and overflow, exactly."""
    bench, jax_audit = jax_scripts
    ref = jax_audit.audit_config(bench.bench_config(16), 16, 48, (42, 7))
    got = capacity_audit.audit_config(bench_config(16), 16, 48, (42, 7),
                                      device="cpu")
    assert len(got) == len(ref)
    for (seed, pc, pb, ovf, first), (rseed, rpc, rpb, rovf) in zip(got, ref):
        assert (seed, pc, ovf) == (rseed, rpc, rovf)
        assert np.array_equal(pb, np.asarray(rpb))
        assert first is None and ovf == 0


def test_audit_signs_clean_policies_outside_benchmarks(tmp_path):
    """``sign`` writes only clean entries, to the path it is given, with the
    platform; the TPU registry is left as it was."""
    registry = REPO / "benchmarks" / "audited_capacities.json"
    before = registry.read_bytes()
    entries = capacity_audit.audit(16, 2, (42,), "cpu")
    assert [e["label"] for e in entries] == ["headline hb-8",
                                             "parity plain-20"]
    assert all(e["tpu"] is None and e["overflow"] == 0 for e in entries)
    dirty = dict(entries[1], signature="dirty", overflow=3)
    out = tmp_path / "signed.json"
    signed = capacity_audit.sign([entries[0], dirty], "cpu", out)
    assert signed == [entries[0]["signature"]]
    written = json.loads(out.read_text())
    assert list(written) == signed
    assert written[signed[0]]["platform"] == "cpu"
    assert written[signed[0]]["peak_pairs"] == entries[0]["peak_pairs"]
    assert registry.read_bytes() == before


def test_main_prints_the_jax_lines_and_compares(capsys, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(capacity_audit, "SIGNED", tmp_path / "a.json")
    rc = capacity_audit.main(["--bodies", "16", "--steps", "2", "--seeds",
                              "42", "--platform", "cpu", "--sign",
                              "--compare"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "headline hb-8: seed 42: peak contacts" in out
    assert "compare parity plain-20: no TPU entry" in out
    assert out.count("signed off: ") == 2
    assert len(json.loads((tmp_path / "a.json").read_text())) == 2


def test_compare_line_reads_the_tpu_entry():
    entry = {"peak_contacts": 50, "peak_pairs": {"ss": 1, "sb": 2, "bb": 3},
             "steps": 600, "seeds": [42, 7]}
    e = dict(label="headline hb-8", signature="s", peak_contacts=40,
             peak_pairs={"ss": 4, "sb": 5, "bb": 6}, max_contacts=64,
             caps={"11": 96, "12": 96, "22": 48}, tpu=entry)
    assert capacity_audit.compare_line(e) == (
        "compare headline hb-8: contacts 40 (tpu 50, cap 64), ss 4 (tpu 1, "
        "cap 96), sb 5 (tpu 2, cap 96), bb 6 (tpu 3, cap 48); tpu audit 600 "
        "steps x 2 seeds")


def test_card_registry_is_a_clean_audit_of_registry_signatures():
    """``utils/audited_capacities_h100.json`` (the audit signed on the
    H100): every entry a signature of the TPU registry, its peaks within
    their caps, at least the TPU entry's horizon."""
    card = capacity_audit.load_registry(capacity_audit.CARD_REGISTRY)
    tpu = capacity_audit.load_registry()
    assert card
    for sig, entry in card.items():
        assert sig in tpu
        assert "H100" in entry["platform"]
        assert entry["steps"] >= tpu[sig]["steps"]
        assert entry["peak_contacts"] <= entry["max_contacts"]
        for name, key in zip(capacity_audit.BUCKET_NAMES, ("11", "12", "22")):
            assert entry["peak_pairs"][name] <= entry["caps"][key]
