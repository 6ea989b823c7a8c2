"""The port's bench, ``rl_ode_physics_tpu_torch/bench.py``, against the
repository's ``bench.py``.

``bench_config`` must equal ``bench.bench_config`` field by field, with no
``BENCH_*`` variable set and under each of the script's configuration
overrides in turn, and ``capacity_signature`` must agree; ``require_audit``
reads the card's sign-off (``utils/audited_capacities_h100.json``): the
default 64-slot schedule (576 substeps) passes under both policies, 512
slots refuse as unaudited, a 672-substep schedule as too shallow.
``_measure`` on the CPU (16 slots, 4 worlds, 3 warm-up launches and 1
timed launch of 8 substeps, past the bodies' landing) ends where the JAX
script's ``_measure`` ends, within ``tests/test_torch_step.py``'s atol
1e-4, with the same dynamic count, no overflow and live contact rows; capacities that drop contacts raise. ``main``
prints one JSON line on stdout with the JAX script's four keys and the
parity line on stderr.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_ode_physics_tpu_torch import bench
from rl_ode_physics_tpu_torch.utils import capacity_audit

from _torch_port import single_cpu_thread, to_numpy  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(n, parity) for n in (64, 512) for parity in (False, True)]
# each configuration override of bench.bench_config, one value apiece
OVERRIDES = {
    "BENCH_ITERS": "12", "BENCH_OMEGA": "1.1", "BENCH_BETA": "0.5",
    "BENCH_SOLVER": "pgs", "BENCH_SOLVER_UNROLL": "2",
    "BENCH_FRICTION": "0", "BENCH_CONTACTS": "96",
    "BENCH_MM_DTYPE": "bfloat16", "BENCH_SEL_DTYPE": "float32",
    "BENCH_TYPED": "0", "BENCH_CAPS": "80,80,40",
    "BENCH_PALLAS_COMPACT": "1", "BENCH_CM": "0", "BENCH_SOLVER_CM": "1",
    "BENCH_SAP": "16"}
# the default schedule's audited horizon: (3 timed + 3 warm-up) x 96
DEFAULT_HORIZON = 576
# tests/test_torch_step.py's tolerance, card or CPU against JAX
ATOL = 1e-4
SMALL = dict(num_worlds=4, num_bodies=16, substeps=2, launches=1, chunk=0)


@pytest.fixture
def jax_scripts(monkeypatch):
    """``bench`` and ``benchmarks/capacity_audit`` imported with every
    ``BENCH_*`` variable unset (``tests/test_torch_capacity_audit.py``'s
    way, without its ``BENCH_PALLAS_COMPACT=1``)."""
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.syspath_prepend(str(REPO / "benchmarks"))
    monkeypatch.syspath_prepend(str(REPO))
    for name in ("bench", "capacity_audit"):
        sys.modules.pop(name, None)
    import bench as jax_bench
    import capacity_audit as jax_audit
    return jax_bench, jax_audit


def _fields(cfg) -> dict:
    return {f.name: (v.value if hasattr(v, "value") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("override", [None] + sorted(OVERRIDES))
@pytest.mark.parametrize("n,parity", SHAPES)
def test_bench_config_matches_bench_py(jax_scripts, monkeypatch, n, parity,
                                       override):
    jax_bench, _ = jax_scripts
    if override is not None:
        monkeypatch.setenv(override, OVERRIDES[override])
    assert (_fields(bench.bench_config(n, parity=parity))
            == _fields(jax_bench.bench_config(n, parity=parity)))


@pytest.mark.parametrize("n,parity", SHAPES)
def test_capacity_signature_matches_jax(jax_scripts, n, parity):
    jax_bench, jax_audit = jax_scripts
    assert capacity_audit.capacity_signature(
        bench.bench_config(n, parity=parity), n) == (
        jax_audit.capacity_signature(jax_bench.bench_config(n, parity=parity),
                                     n))


@pytest.fixture
def no_bench_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)


@pytest.mark.parametrize("parity", [False, True])
def test_default_schedule_passes_the_card_audit(no_bench_env, parity):
    bench.require_audit(bench.bench_config(64, parity=parity), 64,
                        DEFAULT_HORIZON)


@pytest.mark.parametrize("parity", [False, True])
def test_512_slots_refuse_as_unaudited(no_bench_env, parity):
    with pytest.raises(RuntimeError, match="UNAUDITED capacity"):
        bench.require_audit(bench.bench_config(512, parity=parity), 512,
                            DEFAULT_HORIZON)


@pytest.mark.parametrize("parity", [False, True])
def test_deeper_schedule_refuses_as_too_shallow(no_bench_env, parity):
    """BENCH_STEPS=4: (4 + 3) x 96 = 672 substeps, past the card's 600."""
    with pytest.raises(RuntimeError, match="audit horizon too shallow"):
        bench.require_audit(bench.bench_config(64, parity=parity), 64,
                            (4 + bench.WARMUP_LAUNCHES) * 96)


def test_allow_unaudited_passes_and_warns(no_bench_env, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ALLOW_UNAUDITED", "1")
    bench.require_audit(bench.bench_config(512), 512, DEFAULT_HORIZON)
    assert "BENCH_ALLOW_UNAUDITED=1" in capsys.readouterr().err


def test_unroll_refuses(no_bench_env, monkeypatch):
    monkeypatch.setenv("BENCH_UNROLL", "4")
    with pytest.raises(ValueError, match="ROADMAP A2"):
        bench.main(["--device", "cpu"])


def test_donate_refuses(no_bench_env):
    with pytest.raises(ValueError, match="ROADMAP A2"):
        bench._measure(bench.bench_config(16), **SMALL, donate=True,
                       device="cpu")


def test_measure_matches_jax_measure(jax_scripts, monkeypatch):
    """Both scripts' ``_measure`` through the same launches, 8 substeps
    each, so that the run ends at substep 32, past the landing (substeps
    25-36): the final state within atol 1e-4, tick and overflow exact, the
    same dynamic count, and contact rows live in the last substep."""
    import rl_ode_physics_tpu.parallel.batch as jax_batch
    from chip_smoke import last_batches
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    from rl_ode_physics_tpu_torch.parallel import batch as t_batch
    from rl_ode_physics_tpu_torch.utils import bridge
    jax_bench, _ = jax_scripts
    compact = compaction_kernel.compact_rows_t
    live = []

    def recording(mask, payload_t, k, sel_dtype=None):
        live.append(int(mask.sum()))
        return compact(mask, payload_t, k, sel_dtype)

    monkeypatch.setattr(compaction_kernel, "compact_rows_t", recording)
    s = dict(SMALL, substeps=8)
    with last_batches(jax_batch) as ref_last, \
            last_batches(t_batch) as got_last:
        _, _, ref_dynamic = jax_bench._measure(
            jax_bench.bench_config(s["num_bodies"]), s["num_worlds"],
            s["num_bodies"], s["substeps"], s["launches"], s["chunk"], 1)
        value, dt, dynamic = bench._measure(
            bench.bench_config(s["num_bodies"]), **s, device="cpu")
    assert dynamic == ref_dynamic == s["num_bodies"] - 4
    assert value > 0 and dt > 0
    ticks = (bench.WARMUP_LAUNCHES + 1) * s["substeps"]
    assert len(live) == ticks and live[-1] > 0, live
    ref = to_numpy(ref_last[-1][0])
    got = bridge.world_to_numpy(got_last[-1][0])
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow"):
        assert np.array_equal(got[name], ref[name]), name
    assert int(got["tick"][0]) == ticks
    assert not got["overflow"].any()


def test_measure_raises_on_overflow(no_bench_env, monkeypatch):
    """4 contact rows at 16 slots: the bodies land at substeps 25-36 with
    12-13 contacts a world, so 4 launches of 8 substeps drop rows."""
    monkeypatch.setenv("BENCH_CONTACTS", "4")
    with pytest.raises(RuntimeError, match="contact capacity overflow"):
        bench._measure(bench.bench_config(16), **dict(SMALL, substeps=8),
                       device="cpu")


@pytest.fixture
def small_main(no_bench_env, monkeypatch, tmp_path):
    """``main``'s environment at the small shape, with the card's registry
    replaced by one that signs both 16-slot policies."""
    for key, value in (("BENCH_WORLDS", "2"), ("BENCH_BODIES", "16"),
                       ("BENCH_SUBSTEPS", "2"), ("BENCH_STEPS", "1")):
        monkeypatch.setenv(key, value)
    registry = {capacity_audit.capacity_signature(
        bench.bench_config(16, parity=parity), 16): {"steps": 600}
        for parity in (False, True)}
    path = tmp_path / "registry.json"
    path.write_text(json.dumps(registry))
    monkeypatch.setattr(capacity_audit, "CARD_REGISTRY", path)


def _jax_keys(jax_bench):
    cfg = jax_bench.bench_config(16)
    return set(jax_bench._result(cfg, 1.0, 1.0, 2, 16, 12, 2))


def test_main_prints_the_bench_line_and_parity(jax_scripts, small_main,
                                               capsys):
    jax_bench, _ = jax_scripts
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    (line,) = out.strip().splitlines()
    result = json.loads(line)
    assert set(result) == _jax_keys(jax_bench)
    assert result["unit"] == "body-steps/sec" and result["value"] > 0
    assert result["vs_baseline"] == result["value"] / 50e6
    assert "TF32 off" in result["metric"] and "unchunked" in result["metric"]
    (parity,) = [ln for ln in err.splitlines() if ln.startswith("# parity: ")]
    parity = json.loads(parity[len("# parity: "):])
    assert set(parity) == set(result)
    assert "20 solver iters" in parity["metric"]
    assert any(ln.startswith("# aux: ") for ln in err.splitlines())


def test_only_parity_prints_it_on_stdout(jax_scripts, small_main,
                                         monkeypatch, capsys):
    jax_bench, _ = jax_scripts
    monkeypatch.setenv("BENCH_ONLY", "parity")
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    (line,) = out.strip().splitlines()
    result = json.loads(line)
    assert set(result) == _jax_keys(jax_bench)
    assert "ODE QuickStep parity setting" in result["metric"]
    assert "# parity: " not in err


def test_settings_defaults_and_chunk(no_bench_env, monkeypatch):
    """The JAX script's schedule, but unchunked by default; a chunk that
    does not divide the batch falls back to none, as there."""
    assert bench.settings() == dict(num_worlds=8192, num_bodies=64,
                                    substeps=96, launches=3, chunk=0)
    assert bench.settings({"BENCH_CHUNK": "256"})["chunk"] == 256
    assert bench.settings({"BENCH_CHUNK": "300"})["chunk"] == 0


def test_main_needs_the_card_unless_asked(no_bench_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench.main([])
