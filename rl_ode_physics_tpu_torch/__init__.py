"""PyTorch/CUDA port of ``rl_ode_physics_tpu``.

A second package beside the JAX one, which stays the reference: the same
``WorldState`` fields, step semantics and capacities, with a leading world
axis on every tensor and hand-written Hopper kernels where the JAX package
has Pallas ones. It imports ``torch`` and never ``jax`` or
``rl_ode_physics_tpu``. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU. It exports the names that the JAX
package exports; importing it builds no kernel.
"""

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import (
    BodyType,
    CollMask,
    WorldState,
    create_world,
)
from rl_ode_physics_tpu_torch.core.world import (
    add_body,
    add_body_map,
    add_force,
    add_torque,
    release_body,
    set_body_pose,
    set_body_surface,
    step,
    step_with_diagnostics,
    make_step_fn,
)
from rl_ode_physics_tpu_torch.ops.joints import (
    JointSet,
    empty_joints,
    add_ball,
    add_hinge,
    add_fixed,
    add_slider,
    add_universal,
    set_hinge_limits,
    set_hinge_motor,
    hinge_angle,
    slider_position,
    feedback as joint_feedback,
)
from rl_ode_physics_tpu_torch.ops.raycast import (
    RayHits,
    raycast,
    raycast_mesh,
)

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "SolverKind",
    "BodyType",
    "CollMask",
    "WorldState",
    "create_world",
    "add_body",
    "add_body_map",
    "add_force",
    "add_torque",
    "release_body",
    "set_body_pose",
    "set_body_surface",
    "step",
    "step_with_diagnostics",
    "make_step_fn",
    "JointSet",
    "empty_joints",
    "add_ball",
    "add_hinge",
    "add_fixed",
    "add_slider",
    "add_universal",
    "set_hinge_limits",
    "set_hinge_motor",
    "hinge_angle",
    "slider_position",
    "joint_feedback",
    "raycast",
    "raycast_mesh",
    "RayHits",
    "__version__",
]
