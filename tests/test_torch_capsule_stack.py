"""BASELINE config 2 (``capsule_stack_world(num_bodies=64, seed=7)``)
through the classic pipeline, the port's CPU step against the JAX
package's over the fall onto the pile.

Under ``EngineConfig(max_bodies=68, max_pair_candidates=192,
max_contacts=192)`` (the capsule-stack cell's configuration), 360 substeps
on each side: every dynamic body within 1e-3 (measured 1.2e-4; the pile's
collisions amplify roundoff, and the two sides part by 0.4 at 648
substeps), overflow 0 on both. By substep 360 the sphere of slot 6
(radius 0.16) has passed through the top of the floor slab (y = 0.5) on
both sides: its centre is below y = 0, inside the slab. The JAX package
sinks it as the port does, so this is a fault of the reference that the
port inherits (ROADMAP §C, C7), not one of the port.
"""

import jax
import numpy as np

from rl_ode_physics_tpu.core.config import EngineConfig as JaxConfig
from rl_ode_physics_tpu.core.world import make_step_fn as jax_make_step_fn
from rl_ode_physics_tpu.models import scenes as jax_scenes
from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.core.world import make_step_fn
from rl_ode_physics_tpu_torch.utils import bridge

from _torch_port import (  # noqa: F401  (an autouse fixture)
    single_cpu_thread, to_numpy)

CAPS = dict(max_bodies=68, max_pair_candidates=192, max_contacts=192)
SUBSTEPS = 360
ATOL = 1e-3
SLAB_TOP = 0.5          # the floor box: side 1.0, centre y = 0
SUNK_SLOT = 6


def test_capsule_stack_follows_jax_into_the_slab():
    jcfg, tcfg = JaxConfig(**CAPS), EngineConfig(**CAPS)
    w = jax_scenes.capsule_stack_world(jcfg, num_bodies=64, seed=7)
    tw = bridge.world_from_numpy(to_numpy(w), device="cpu")
    jstep = jax_make_step_fn(jcfg, substeps=1, donate=False)
    tstep = make_step_fn(tcfg, substeps=1)
    for _ in range(SUBSTEPS):
        w = jstep(w)
        tw = tstep(tw)
    jax.block_until_ready(w.pos)
    ref, got = to_numpy(w), bridge.world_to_numpy(tw, 0)
    dyn = ref["inv_mass"] > 0
    err = float(np.abs(got["pos"] - ref["pos"])[dyn].max())
    assert err <= ATOL, err
    assert int(ref["overflow"]) == int(got["overflow"]) == 0
    # the lowest dynamic body on each side is the slot-6 sphere, inside
    # the floor slab
    assert int(ref["body_type"][SUNK_SLOT]) == int(BodyType.SPHERE)
    radius = float(ref["size"][SUNK_SLOT, 0])
    for side in (ref, got):
        y = np.where(dyn, side["pos"][:, 1], np.inf)
        assert int(y.argmin()) == SUNK_SLOT
        assert y[SUNK_SLOT] + radius < SLAB_TOP
        assert y[SUNK_SLOT] < 0.0
    print(f"[capsule-stack] {SUBSTEPS} substeps: max abs pos err {err:.3e}; "
          f"slot {SUNK_SLOT} (sphere, r={radius:.3f}) at y="
          f"{ref['pos'][SUNK_SLOT, 1]:.4f} (JAX), "
          f"{got['pos'][SUNK_SLOT, 1]:.4f} (port), slab top {SLAB_TOP}")
