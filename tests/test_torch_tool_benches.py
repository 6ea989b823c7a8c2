"""The port's benches and analysis tools against the JAX package's
scripts, on the CPU at small sizes: ``utils/capacity_peaks`` (the peaks
exactly, positions within 1e-5), ``utils/warmstart_curve`` (cold and warm
|Δλ| within 1e-5 absolute), ``utils/teapot_bench`` (its world and mesh
bit for bit the JAX script's construction, its mesh arguments),
``utils/rl_rollout_bench`` (the JSON keys, no overflow),
``utils/solver_iter`` (its JSON line's keys and iteration counts) and
``utils/profile_step`` (every row's source the first line of a function
of the port or ``?``, the per-file totals summing to the total).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.config import SolverKind as JaxSolverKind
from rl_ode_physics_tpu.core.state import BodyType as JaxBodyType
from rl_ode_physics_tpu.models.builder import WorldBuilder as JaxBuilder
from rl_ode_physics_tpu.ops import trimesh as jax_trimesh
from rl_ode_physics_tpu.utils.prng import RandStream as JaxRandStream
from rl_ode_physics_tpu_torch.core.config import SolverKind
from rl_ode_physics_tpu_torch.models.workloads import mesh_world, standin_mesh
from rl_ode_physics_tpu_torch.utils import (
    bridge, capacity_peaks, profile_step, rl_rollout_bench, solver_iter,
    teapot_bench, warmstart_curve)

from _torch_port import single_cpu_thread, to_numpy  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rl_ode_physics_tpu_torch"
# the keys of benchmarks/rl_rollout_bench.py's JSON line
ROLLOUT_KEYS = {"metric", "value", "unit", "body_steps_per_sec"}
# the keys of benchmarks/solver_iter.py's JSON line
SOLVER_ITER_KEYS = {"metric", "value", "unit", "per_batch_ms"}


def test_capacity_peaks_matches_jax_tool(monkeypatch, capsys):
    """mini-stack, 48 substeps: the JAX tool's line, the port's line."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    monkeypatch.setattr(sys, "argv", ["capacity_peaks.py", "mini-stack",
                                      "--substeps", "48", "--every", "48"])
    sys.modules.pop("capacity_peaks", None)
    import capacity_peaks as jax_tool
    jax_tool.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (got,) = capacity_peaks.run("mini-stack", 48, 48, device="cpu")
    for key in ("scene", "substep", "peak_pairs", "peak_contacts",
                "peak_pairs_by_type", "overflow"):
        assert got[key] == ref[key], key
    for key in ("y_min", "y_max", "fastest_m_per_s"):
        assert abs(got[key] - ref[key]) <= 1e-5, key


def _jax_warmstart_curve(kind, iterations, settle):
    """``benchmarks/warmstart_curve.py:main``'s loop for one solver, at
    ``settle`` substeps and the given iteration counts."""
    from rl_ode_physics_tpu.core.world import make_step_fn
    from rl_ode_physics_tpu.models import scenes
    from rl_ode_physics_tpu.ops import broadphase as bp
    from rl_ode_physics_tpu.ops import integrator
    from rl_ode_physics_tpu.ops import narrowphase as nph
    from rl_ode_physics_tpu.ops import solver as so
    from rl_ode_physics_tpu.ops import warmstart
    import jax

    cfg = JaxConfig(max_bodies=16, max_pair_candidates=64, max_contacts=64,
                    solver=kind)
    w0 = scenes.bench_world(cfg, num_bodies=10, seed=42)
    stepf = make_step_fn(cfg, substeps=1, donate=False)
    for _ in range(settle):
        w0 = stepf(w0)
    solve = so.solve_pgs if kind is JaxSolverKind.PGS else so.solve_jacobi

    # the script's eager contact phases under one jit (they read no solver
    # field, so ``cfg`` stands for each ``c``): op-by-op dispatch compiles
    # each operation apart, most of this comparison's time
    @jax.jit
    def contact_phases(w):
        contacts = nph.narrowphase(w, bp.broadphase(w, cfg), cfg)
        return contacts, integrator.apply_external_forces(w, cfg)

    out = []
    for iters in iterations:
        c = cfg.replace(solver_iterations=iters)
        warm_fn = jax.jit(warmstart.make_warm_step_fn(c))
        cache = warmstart.init_cache(c)
        w = w0
        for _ in range(warmstart_curve.WARM_STEPS):
            w, cache = warm_fn(w, cache)
        contacts, wf = contact_phases(w)
        _, lam_star = solve(wf, contacts, c.replace(
            solver_iterations=warmstart_curve.CONVERGED), return_lam=True)
        _, lam_cold = solve(wf, contacts, c, return_lam=True)
        lam0 = warmstart.match_lam(cache, contacts)
        _, lam_warm = solve(wf, contacts, c, lam0=lam0, return_lam=True)
        out.append((iters, float(np.abs(np.asarray(lam_cold - lam_star)).max()),
                    float(np.abs(np.asarray(lam_warm - lam_star)).max())))
    return out


@pytest.mark.parametrize("kind", ["pgs", "jacobi"])
def test_warmstart_curve_matches_jax(kind):
    """Cold and warm |Δλ| at 1 and 5 iterations after 24 settle substeps."""
    ref = _jax_warmstart_curve(JaxSolverKind(kind), (1, 5), 24)
    got = warmstart_curve.curve(SolverKind(kind), (1, 5), 24, device="cpu")
    assert [g[0] for g in got] == [r[0] for r in ref]
    np.testing.assert_allclose(np.array(got)[:, 1:], np.array(ref)[:, 1:],
                               rtol=0, atol=1e-5)


def test_solver_iter_line():
    """``utils/solver_iter`` at 2 worlds, one solve a sample: the JAX
    script's keys, metric, unit and iteration counts, and a finite,
    non-negative slope."""
    r = solver_iter.run(2, "cpu", solves=1)
    assert set(r) == SOLVER_ITER_KEYS
    assert r["metric"] == ("solver us/iter/world (2 worlds, 256-contact "
                           "buffers)")
    assert r["unit"] == "us/iteration/world"
    assert list(r["per_batch_ms"]) == [5, 10, 20, 40, 80]
    assert np.isfinite(r["value"]) and r["value"] >= 0


def test_teapot_world_and_mesh_match_jax_script():
    """``teapot_bench.py:37-60``'s construction on a small heightfield,
    field by field and bit for bit."""
    verts, tris = standin_mesh(cells=4)
    cfg = teapot_bench.teapot_config()
    jcfg = JaxConfig(max_bodies=16, max_pair_candidates=64,
                     max_contacts=128, max_contacts_per_pair=8,
                     enable_planes=False, enable_capsules=False)
    for f in ("max_bodies", "max_pair_candidates", "max_contacts",
              "max_contacts_per_pair", "enable_planes", "enable_capsules",
              "typed_buckets", "solver_iterations"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    top = float(verts[:, 1].max())
    b = JaxBuilder(jcfg, 0)
    mesh_slot = b.add_body_map((0, 0, 0), (0, 0, 0), (0, 0, 0))
    b.body_type[mesh_slot] = int(JaxBodyType.TRIMESH)
    rng = JaxRandStream(3)
    for _ in range(teapot_bench.NUM_BODIES - 1):
        b.add_body(JaxBodyType.SPHERE,
                   (rng.double(-1.5, 1.5), top + rng.double(0.5, 3.0),
                    rng.double(-1.5, 1.5)),
                   (0.25, 0.0, 0.0))
    ref_world = to_numpy(b.finish())
    ref_mesh = jax_trimesh.build_trimesh(verts, tris, slot=mesh_slot)

    world, mesh = mesh_world(cfg, verts, tris, "cpu")
    got = bridge.world_to_numpy(world, 0)
    for key in ref_world:
        assert np.array_equal(got[key], ref_world[key]), key
    assert mesh.slot == int(ref_mesh.slot)
    for key in ("v0", "e1", "e2", "normal"):
        assert np.array_equal(getattr(mesh, key).numpy(),
                              np.asarray(getattr(ref_mesh, key))), key


def _write_obj(path, verts, tris):
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


def test_teapot_bench_needs_a_mesh(tmp_path, capsys):
    """Neither ``--obj`` nor ``--standin``, or a missing file: an error
    that says so, and no stand-in swapped in; an OBJ file runs."""
    for argv in ([], ["--obj", str(tmp_path / "absent.obj")],
                 ["--obj", "x.obj", "--standin"]):
        with pytest.raises(SystemExit) as err:
            teapot_bench.main(argv + ["--device", "cpu"])
        assert "teapot_bench:" in str(err.value)
    assert "--standin" in str(pytest.raises(
        SystemExit, teapot_bench.main, ["--device", "cpu"]).value)
    obj = tmp_path / "small.obj"
    _write_obj(obj, *standin_mesh(cells=2))
    assert teapot_bench.main(["1", "--obj", str(obj), "--device",
                              "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "triangle_tests_per_sec",
            "card"} <= set(line)
    assert line["overflow"] == 0 and line["card"] == "cpu"


def test_rl_rollout_bench_keys(monkeypatch, capsys):
    """4 worlds, horizon 2: the JAX script's keys (and the card), no
    overflow (the bench raises on one)."""
    for key, value in dict(BENCH_WORLDS="4", BENCH_HORIZON="2",
                           BENCH_REPEATS="1").items():
        monkeypatch.setenv(key, value)
    assert rl_rollout_bench.main("cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == ROLLOUT_KEYS | {"card"}
    assert line["value"] > 0 and "4 worlds, horizon 2" in line["metric"]
    s = rl_rollout_bench.settings({"BENCH_WORLDS": "512"})
    assert (s["chunk"], s["max_contacts"], s["lidar_rays"]) == (256, 80, 16)


def test_profile_step_attributes_to_port_lines():
    """2 worlds x 1 substep on the CPU: the outermost PyTorch operations,
    each under the first line of a function of the port or ``?``; the
    per-file totals sum to the total."""
    r = profile_step.profile(2, 1, "bench", "cpu")
    assert r["rows"] and r["total_ms"] > 0
    assert abs(sum(r["by_file"].values()) - r["total_ms"]) <= 1e-9 * max(
        1.0, r["total_ms"])
    for row in r["rows"]:
        if row["source"] == "?":
            continue
        name, line = row["source"].rsplit(":", 1)
        text = (PORT / name).read_text().splitlines()
        line = int(line)
        assert 1 <= line <= len(text), row
        # the first line of the function's code: its def, or a decorator
        window = "\n".join(text[line - 1:line + 3])
        assert (row["function"].startswith("<")
                or f"def {row['function']}(" in window), row
    assert r["mapped_share"] > 0.9
    assert "per-file totals" in profile_step.report(r, top=5)
