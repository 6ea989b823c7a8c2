"""The port's last public names against the JAX package's, and the port's
isolation from the JAX package and the repository's scripts.

``utils/prng.MIX1``, ``MIX2`` and ``rand_color`` are held to the JAX
package's bit for bit; ``utils/profiling.phase_timings`` to the JAX
function's keys, with finite positive times; ``utils/profiling.trace``
writes a trace; ``rl_ode_physics_tpu_torch.utils`` re-exports ``quat``,
``transforms`` and ``prng`` as the JAX ``utils`` does, and its import
builds no kernel.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rl_ode_physics_tpu.utils as jax_utils
from rl_ode_physics_tpu.utils import prng as jax_prng
from rl_ode_physics_tpu.utils import profiling as jax_profiling
from rl_ode_physics_tpu.models import scenes as jax_scenes
import rl_ode_physics_tpu_torch.utils as t_utils
from rl_ode_physics_tpu_torch.models import scenes as t_scenes
from rl_ode_physics_tpu_torch.parallel.batch import replicate
from rl_ode_physics_tpu_torch.utils import prng as t_prng
from rl_ode_physics_tpu_torch.utils import profiling as t_profiling

from _torch_port import SMALL_BODIES, configs

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rl_ode_physics_tpu_torch"
# what no module of the port may import: JAX, the JAX package, and the
# repository's scripts
FORBIDDEN = {"jax", "jaxlib", "flax", "rl_ode_physics_tpu", "bench",
             "benchmarks", "chip_smoke"}
PHASE_KEYS = ("broadphase_ms", "narrowphase_ms", "forces_ms", "solve_ms",
              "integrate_ms", "total_ms")


def test_mix_constants_bitwise():
    for name in ("WEYL", "MIX1", "MIX2"):
        got, ref = getattr(t_prng, name), getattr(jax_prng, name)
        assert got == ref and got.dtype == ref.dtype, name


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 0xE120FC15, 2 ** 31,
                                  2 ** 32 - 1])
def test_rand_color_bitwise(seed):
    """Three draws a call, 32 calls in a row from each seed (tolerance:
    none, the values and states bit for bit)."""
    s_j, s_t = np.uint32(seed), np.uint32(seed)
    for _ in range(32):
        ref, s_j = jax_prng.rand_color(s_j)
        got, s_t = t_prng.rand_color(s_t)
        assert s_t == s_j and s_t.dtype == s_j.dtype
        for a, b in zip(got, ref):
            assert a == b and a.dtype == b.dtype


def test_rand_color_bitwise_on_arrays():
    seeds = np.random.default_rng(3).integers(0, 2 ** 32, 4096,
                                              dtype=np.uint32)
    ref, s_j = jax_prng.rand_color(seeds)
    got, s_t = t_prng.rand_color(seeds)
    assert np.array_equal(s_t, s_j)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_utils_reexports():
    assert t_utils.__all__ == jax_utils.__all__
    for name in jax_utils.__all__:
        module = getattr(t_utils, name)
        assert module.__name__ == f"rl_ode_physics_tpu_torch.utils.{name}"


def test_utils_import_builds_no_kernel():
    """Importing the subpackage calls neither the kernel build nor the
    library load (checked in a fresh process)."""
    code = (
        "import rl_ode_physics_tpu_torch.ops.kernel_build as kb\n"
        "def fail(*a, **k):\n"
        "    raise SystemExit('a kernel was built or loaded')\n"
        "kb.build = kb.load = fail\n"
        "import rl_ode_physics_tpu_torch.utils as u\n"
        "from rl_ode_physics_tpu_torch.utils import prng, quat, transforms\n"
        "assert u.prng is prng and u.quat is quat\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _small_states():
    jcfg, tcfg = configs()
    jw = jax_scenes.bench_world(jcfg, num_bodies=SMALL_BODIES)
    tw = t_scenes.bench_world(tcfg, num_bodies=SMALL_BODIES, device="cpu")
    return jcfg, tcfg, jw, tw


def test_phase_timings_keys_match_jax():
    """The JAX function's keys on a single world; the port's on a world and
    on a batch of 3, each time finite and positive, and the total their
    sum (to 1e-9 ms)."""
    jcfg, tcfg, jw, tw = _small_states()
    ref = jax_profiling.phase_timings(jw, jcfg, reps=1)
    assert tuple(ref) == PHASE_KEYS
    for state in (tw, replicate(tw, 3, device="cpu")):
        got = t_profiling.phase_timings(state, tcfg, reps=2)
        assert tuple(got) == tuple(ref)
        assert all(np.isfinite(v) and v > 0 for v in got.values()), got
        assert abs(got["total_ms"] - sum(
            v for k, v in got.items() if k != "total_ms")) < 1e-9


def test_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with t_profiling.trace(str(logdir)) as where:
        assert where == str(logdir)
        torch.ones(64).cumsum(0)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_isolated(path):
    """No module of the port imports JAX, the JAX package, ``bench``,
    ``benchmarks`` or ``chip_smoke``."""
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, (
            f"{path.relative_to(REPO)} imports {mod}")


def test_no_port_module_edits_sys_path():
    """The port reaches the repository's fixtures through
    ``models/workloads.py``, not by putting the checkout's root on
    ``sys.path``."""
    for path in PORT.rglob("*.py"):
        assert "sys.path.insert" not in path.read_text(), path
