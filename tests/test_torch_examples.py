"""The port's example programs (``rl_ode_physics_tpu_torch/examples``) run
as a user runs them, ``python -m ...`` with ``--device cpu`` at small
sizes; their printed lines are those of the JAX package's examples
(``tests/test_examples.py`` runs those)."""

import importlib
import inspect
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port import SUBPROCESS_ENV

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "rl_ode_physics_tpu_torch.examples"


def _run(args, timeout=240, module=True):
    cmd = [sys.executable] + (["-m", f"{PACKAGE}.{args[0]}"] if module
                              else [str(REPO / args[0])]) + list(args[1:])
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=str(REPO), env=SUBPROCESS_ENV)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_minimal_server_client_pair():
    port = _free_udp_port()
    server = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.minimal_server", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO), env=SUBPROCESS_ENV)
    try:
        out = _run(["minimal_client", str(port), "4"], timeout=60)
        assert "RECEIVED ID: 0" in out, out
        assert "roster size 1" in out, out
    finally:
        server.kill()
        server.wait()


def _numbers(line: str):
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", line)]


def test_articulated_prints_the_jax_examples_lines():
    got = _run(["articulated", "3", "--device", "cpu"]).splitlines()
    want = _run(["examples/articulated.py", "3"], timeout=300,
                module=False).splitlines()
    assert len(got) == len(want) == 4
    assert got[-1].startswith("DONE: arm swept")
    for g, w in zip(got, want):
        assert re.sub(r"[-+]?\d+\.\d+", "#", g) == re.sub(
            r"[-+]?\d+\.\d+", "#", w), (g, w)
        # printed at 2 decimals: the values within a printed step
        np.testing.assert_allclose(_numbers(g), _numbers(w), atol=0.011)


def test_rl_rollout_prints_env_steps():
    out = _run(["rl_rollout", "8", "3", "--device", "cpu"])
    assert "obs shape (8, 8, 13)" in out, out
    assert re.search(r"rollout: 3 control steps × 8 envs in [\d.]+s → "
                     r"[\d,]+ env-steps/sec", out), out
    heights = _numbers(out.splitlines()[-1])
    assert len(heights) == 2 and heights[0] <= heights[1]


def test_rl_training_prints_the_reward_curve():
    out = _run(["rl_training", "2", "--horizon", "4", "--device", "cpu"])
    lines = out.splitlines()
    assert [line.split()[:2] for line in lines[:2]] == [["iter", "0"],
                                                        ["iter", "1"]]
    assert all("mean reward" in line for line in lines[:2])
    assert lines[-1].startswith("first ") and "→ last" in lines[-1]


@pytest.mark.parametrize("name", ["rl_rollout", "articulated",
                                  "rl_training"])
def test_examples_default_to_the_card(name):
    main = importlib.import_module(f"{PACKAGE}.{name}").main
    assert inspect.signature(main).parameters["device"].default == "cuda"
