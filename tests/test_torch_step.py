"""The port's batched step against the JAX package's, and the port's
isolation from JAX.

2 worlds of the small bench configuration (16 slots, 12 bodies, bucket caps
(32, 32, 16), 32 contacts) step 8 substeps on each side from the same
settled state: pos/quat/linvel/angvel at atol 1e-4, tick and overflow
exact.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from rl_ode_physics_tpu.core.state import WorldState as JaxWorldState
from rl_ode_physics_tpu.parallel.batch import (
    make_batched_step_fn as jax_batched_step_fn, replicate as jax_replicate)
from rl_ode_physics_tpu_torch.core.config import SolverKind
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.parallel.batch import (
    make_batched_step_fn, replicate)
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import configs, settled_state, to_numpy

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
SUBSTEPS = 8


def _start(num_worlds=2):
    """The settled state replicated, each world's velocities perturbed
    differently: (JAX batch, numpy arrays of it)."""
    arrays = settled_state(30)
    jstate = JaxWorldState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = to_numpy(jax_replicate(jstate, num_worlds))
    rng = np.random.default_rng(8)
    dyn = batch["inv_mass"] > 0
    kick = rng.normal(scale=0.05, size=batch["linvel"].shape)
    batch["linvel"] = (batch["linvel"]
                       + np.where(dyn[..., None], kick, 0)).astype(np.float32)
    jbatch = JaxWorldState(**{k: jnp.asarray(v) for k, v in batch.items()})
    return jbatch, batch


@pytest.mark.parametrize("sel", ["bfloat16", "float32"])
def test_batched_step_matches_jax(sel):
    jcfg, tcfg = configs(selector_dtype=sel)
    jbatch, arrays = _start()
    tbatch = bridge.world_from_numpy(arrays, device="cpu")
    jfn = jax_batched_step_fn(jcfg, substeps=1, donate=False)
    tfn = make_batched_step_fn(tcfg, substeps=1, device="cpu")
    for _ in range(SUBSTEPS):
        jbatch = jfn(jbatch)
        tbatch = tfn(tbatch)
    ref, got = to_numpy(jbatch), bridge.world_to_numpy(tbatch)
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("tick", "overflow", "rng_state"):
        assert np.array_equal(got[name], ref[name]), name
    assert (got["tick"] == 30 + SUBSTEPS).all()


def test_substeps_and_chunks_equal_single_steps():
    _, tcfg = configs()
    _, arrays = _start(num_worlds=4)
    one = make_batched_step_fn(tcfg, substeps=1, device="cpu")
    ref = bridge.world_from_numpy(arrays, device="cpu")
    for _ in range(3):
        ref = one(ref)
    got = make_batched_step_fn(tcfg, substeps=3, chunk=2, device="cpu")(
        bridge.world_from_numpy(arrays, device="cpu"))
    ref, got = bridge.world_to_numpy(ref), bridge.world_to_numpy(got)
    for name in ref:
        assert np.array_equal(got[name], ref[name]), name


def test_step_fn_refuses_batch_on_other_device():
    _, tcfg = configs()
    fn = make_batched_step_fn(tcfg, substeps=1)       # made for the card
    batch = replicate(bridge.world_from_numpy(settled_state(30),
                                              device="cpu"), 2, device="cpu")
    with pytest.raises(ValueError):
        fn(batch)


@pytest.mark.parametrize("override", [dict(solver=SolverKind.PGS,
                                           solver_cm=True),
                                      dict(solver_cm=True),
                                      dict(solver=SolverKind.DANTZIG),
                                      dict(solver_matmul_dtype="bfloat16")])
def test_unported_pipelines_raise(override):
    """Every narrowphase pipeline steps, with the JACOBI and PGS solvers;
    what the port does not have yet (the DANTZIG solver, the
    component-major solver loop, bf16 solver products) raises when the
    step function is made."""
    _, tcfg = configs(**override)
    with pytest.raises(NotImplementedError):
        make_step_fn(tcfg)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_sources():
    files = sorted((REPO / "rl_ode_physics_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "rl_ode_physics_tpu"), (
            f"{path.relative_to(REPO)} imports {mod}")


def test_world_state_fields_match_jax():
    from rl_ode_physics_tpu_torch.core.state import WorldState
    assert ([f.name for f in dataclasses.fields(WorldState)]
            == [f.name for f in dataclasses.fields(JaxWorldState)])
