"""The substep: collide, apply forces, solve, integrate.

The port of ``rl_ode_physics_tpu/core/world.py:_step_impl`` (``:262-336``),
``step_with_diagnostics`` and ``_base_metrics`` (``:339-366``) and
``make_step_fn`` (``:369-410``, a CUDA graph a call on the card:
``utils/graphs.py``), every pipeline of the JAX step:
the dense pipeline, the typed narrowphase (component-major or row-major)
and the classic broadphase + narrowphase, each with an optional static
trimesh (the dense pipeline hands a mesh step to the classic one, as the
JAX step does) and an optional ``JointSet`` (``ops/joints.py``), whose
connected pairs every pair phase excludes and whose rows the solver
relaxes beside the contacts. Every function takes a batch of worlds
``(B, …)``; the JAX package's ``vmap`` is the leading world axis here, and
a diagnostics counter is a (B,) tensor, one value per world.

The body API of ``rl_ode_physics_tpu/core/world.py:52-226`` (``add_body``,
``add_body_map``, ``release_body``, ``set_body_pose``,
``set_body_surface``, ``add_force``, ``add_torque``) acts on every world of
the batch as ``jax.vmap`` of the JAX function does with the same arguments:
a value is given once for every world, or with a leading world axis. A slot
is written by a one-hot ``torch.where`` over the slot axis, so no function
reads a tensor back to the host.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import (
    U32_MASK, BodyType, CollMask, WorldState, box_mass, capsule_mass,
    default_mass, sphere_mass)
from rl_ode_physics_tpu_torch.ops import broadphase, dense, integrator
from rl_ode_physics_tpu_torch.ops import joints as joint_ops
from rl_ode_physics_tpu_torch.ops import narrowphase
from rl_ode_physics_tpu_torch.ops import solver as solver_ops
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh, mesh_narrowphase
from rl_ode_physics_tpu_torch.utils import graphs
from rl_ode_physics_tpu_torch.utils import quat as quat_m
from rl_ode_physics_tpu_torch.utils import tracing


# ---------------------------------------------------------------------------
# Body management
# ---------------------------------------------------------------------------

def _free_slot(state: WorldState):
    """(slot, found), each (B,): every world's lowest free slot, like the
    reference's linear scan (``src/main.c:696-699``), as an int32 that is
    -1 where the world is full. ``torch.argmax`` takes no bool tensor on
    CUDA, hence the uint8 mask."""
    free = (~state.active).to(torch.uint8)
    slot = torch.argmax(free, dim=-1).to(torch.int32)
    found = free.amax(-1) > 0
    return torch.where(found, slot, -1), found


def _slot_mask(state: WorldState, slot) -> torch.Tensor:
    """(B or 1, N) bool, true at ``slot`` (an int, or a (B,) tensor) of each
    world. A negative slot counts from the end, as a JAX index does."""
    n = state.num_slots
    ids = torch.arange(n, device=state.device)
    if isinstance(slot, int):
        return (ids == (slot + n if slot < 0 else slot))[None]
    slot = torch.as_tensor(slot, device=state.device).reshape(-1, 1)
    return ids == torch.where(slot < 0, slot + n, slot)


def _per_world(arr: torch.Tensor, value) -> torch.Tensor:
    """``value`` for a field like ``arr`` in its dtype, with a world axis:
    (B or 1, *per-slot shape)."""
    t = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    return t[None] if t.dim() == arr.dim() - 2 else t


def _set_slot(state: WorldState, mask: torch.Tensor, add: bool = False,
              **fields) -> WorldState:
    """Write (or, with ``add``, add) each field's value where ``mask``
    (B or 1, N) is true."""
    updates = {}
    for name, value in fields.items():
        arr = getattr(state, name)
        v = _per_world(arr, value).unsqueeze(1)
        m = mask.reshape(mask.shape + (1,) * (arr.dim() - 2))
        updates[name] = torch.where(m, arr + v if add else v, arr)
    return state.replace(**updates)


def add_body(state: WorldState, body_type, pos, size, quat=None, *,
             category=int(CollMask.OBJ),
             collide=int(CollMask.OBJ) | int(CollMask.MAP),
             kinematic=False, color=(255, 255, 255, 255),
             linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0),
             auto_mass: bool = False, density: float = 1.0):
    """Spawn a dynamic (or kinematic) body in every world; returns (state,
    slot), ``slot`` a (B,) int32 tensor, -1 in a world with no free slot,
    which is left untouched.

    Defaults mirror the reference's ``AddBody(…, CMASK_OBJ, CMASK_OBJ |
    CMASK_MAP, …)`` call (``src/main.c:181``): ODE's dBodyCreate default
    mass (m=1, I=identity); ``auto_mass=True`` computes the density-based
    mass of the body's shape instead.
    """
    slot, found = _free_slot(state)
    dtype, device = state.pos.dtype, state.device
    size = _per_world(state.size, size)                       # (B|1, 3)
    body_type = _per_world(state.body_type, body_type)        # (B|1,)
    if quat is None:
        quat = quat_m.identity(dtype, device)

    if auto_mass:
        m_s, i_s = sphere_mass(size[..., 0], density)
        m_b, i_b = box_mass(size, density)
        m_c, i_c = capsule_mass(size[..., 0], size[..., 1], density)
        is_s = body_type == int(BodyType.SPHERE)
        is_b = body_type == int(BodyType.BOX)
        mass = torch.where(is_s, m_s, torch.where(is_b, m_b, m_c))
        inertia = torch.where(is_s[..., None], i_s,
                              torch.where(is_b[..., None], i_b, i_c))
    else:
        mass, inertia = default_mass(dtype, device)

    if kinematic:
        inv_mass = torch.zeros_like(mass)
        inv_inertia = torch.zeros_like(inertia)
    else:
        inv_mass, inv_inertia = 1.0 / mass, 1.0 / inertia

    state = _set_slot(
        state, _slot_mask(state, slot) & found[:, None],
        pos=pos, quat=quat, size=size, linvel=linvel, angvel=angvel,
        force=(0.0, 0.0, 0.0), torque=(0.0, 0.0, 0.0),
        inv_mass=inv_mass, inv_inertia=inv_inertia, body_type=body_type,
        category=category, collide=collide, is_static=False,
        is_kinematic=bool(kinematic), color=color)
    return state, slot


def add_body_map(state: WorldState, pos, rot_euler, size,
                 color=(80, 80, 80, 255)):
    """Static box geom for the arena in every world — ``AddBodyMap``
    (``src/main.c:735``): ``is_static`` with zero inverse mass and inertia,
    oriented by Euler XYZ angles like ``GetTransformMatV``. Returns
    (state, slot) as ``add_body`` does."""
    slot, found = _free_slot(state)
    # the angles' quaternion is computed where they are given: a tuple on
    # the host, as WorldBuilder does, so a world on the card gets the bits
    # a world on the CPU gets
    q = quat_m.from_euler_xyz(torch.as_tensor(rot_euler,
                                              dtype=state.pos.dtype))
    state = _set_slot(
        state, _slot_mask(state, slot) & found[:, None],
        pos=pos, quat=q, size=size,
        linvel=(0.0, 0.0, 0.0), angvel=(0.0, 0.0, 0.0),
        force=(0.0, 0.0, 0.0), torque=(0.0, 0.0, 0.0),
        inv_mass=0.0, inv_inertia=(0.0, 0.0, 0.0),
        body_type=int(BodyType.BOX), category=int(CollMask.MAP),
        collide=int(CollMask.ALL) & U32_MASK, is_static=True,
        is_kinematic=False, color=color)
    return state, slot


def release_body(state: WorldState, slot) -> WorldState:
    """Free a slot (``ReleaseBody``, ``src/main.c:763``): type → NULL."""
    return _set_slot(state, _slot_mask(state, slot),
                     body_type=int(BodyType.NULL))


def set_body_pose(state: WorldState, slot, pos=None, quat=None,
                  linvel=None, angvel=None) -> WorldState:
    """dBodySetPosition/Rotation/LinearVel analog for one slot; used for
    kinematic bodies (player capsules) driven by external targets."""
    fields = dict(pos=pos, quat=quat, linvel=linvel, angvel=angvel)
    return _set_slot(state, _slot_mask(state, slot),
                     **{k: v for k, v in fields.items() if v is not None})


def set_body_surface(state: WorldState, slot, friction=None,
                     restitution=None) -> WorldState:
    """Per-body contact surface parameters (used when
    ``EngineConfig.per_body_surface`` is on)."""
    fields = dict(friction=friction, restitution=restitution)
    return _set_slot(state, _slot_mask(state, slot),
                     **{k: v for k, v in fields.items() if v is not None})


def add_force(state: WorldState, slot, force) -> WorldState:
    """dBodyAddForce analog (accumulator, cleared by the integrator)."""
    return _set_slot(state, _slot_mask(state, slot), add=True, force=force)


def add_torque(state: WorldState, slot, torque) -> WorldState:
    return _set_slot(state, _slot_mask(state, slot), add=True, torque=torque)


def step(state: WorldState, config: EngineConfig,
         trimesh: TriMesh | None = None, joints=None) -> WorldState:
    """One fixed substep for every world of the batch.

    Contacts come from the current positions; forces and gravity advance
    the velocities, the solver corrects them, positions integrate with the
    corrected velocities. Pairs and contacts dropped at a full capacity
    accumulate on ``state.overflow``. ``trimesh``: an optional static mesh,
    shared by every world, whose contacts merge into the same rows; its
    sweep runs the hand-written kernel on CUDA tensors. ``joints``: an
    optional ``ops.joints.JointSet`` of bilateral constraints.
    """
    config.validate()
    return _step_impl(state, config, trimesh, joints=joints)


def step_with_diagnostics(state: WorldState, config: EngineConfig,
                          trimesh: TriMesh | None = None, joints=None):
    """``step`` that also returns the per-tick counters of every world:
    (state, {name: (B,) tensor}). The same ``_step_impl`` as ``step``, so
    diagnostics never run another pipeline. Counters: ``num_pairs``,
    ``num_contacts``, ``pair_overflow``, ``contact_overflow`` (int32),
    ``max_penetration``, ``kinetic_energy`` (the state's dtype) and
    ``num_bodies`` (int32); with joints under JACOBI also
    ``joint_force_a``, ``joint_torque_a``, ``joint_force_b`` and
    ``joint_torque_b`` (B, J, 3), ODE's joint feedback."""
    config.validate()
    return _step_impl(state, config, trimesh, with_metrics=True,
                      joints=joints)


def _step_impl(state: WorldState, config: EngineConfig,
               trimesh: TriMesh | None, with_metrics: bool = False,
               joints=None):
    # the stage stamps (utils/tracing) launch nothing while tracing is off
    tracing.stamp("start")
    if config.dense_pipeline and trimesh is None:
        # the dense pipeline has its own positional solve and no joints
        manifold = dense.dense_narrowphase(state, config)
        _, _, depths, valid = manifold
        metrics = _pair_row_counters(
            state, with_metrics, num_pairs=valid, num_contacts=valid,
            group=config.max_contacts_per_pair)   # drops nothing
        tracing.stamp("collide")
        state = integrator.apply_external_forces(state, config)
        tracing.stamp("forces")
        state = dense.dense_solve(state, manifold, config)
        tracing.stamp("solve.iterate")
        state = integrator.integrate_positions(state, config)
        tracing.stamp("integrate")
        if not with_metrics:
            return state
        return state, _base_metrics(
            state, **metrics,
            max_penetration=torch.where(valid, depths, 0.0).flatten(1)
            .amax(1))

    exclude = None
    if joints is not None:
        exclude = joint_ops.connected_mask(joints, state.num_slots)
        tracing.stamp("joints")
    extra = None
    if trimesh is not None:
        extra = mesh_narrowphase(state, trimesh, config)
        tracing.stamp("mesh")
    if config.typed_buckets:
        # bucket drops are folded into contacts.overflow; the pair phase
        # and the narrowphase stamp their own stages, bucket by bucket
        contacts, num_pairs = narrowphase.narrowphase_typed(
            state, config, extra, exclude=exclude)
        pair_overflow = torch.zeros_like(state.overflow)
    else:
        cand = broadphase.broadphase(state, config, exclude=exclude)
        tracing.stamp("pairs")
        contacts = narrowphase.narrowphase(state, cand, config, extra)
        num_pairs, pair_overflow = cand.count, cand.overflow
    metrics = _pair_row_counters(
        state, with_metrics, num_pairs=num_pairs,
        num_contacts=contacts.count, pair_overflow=pair_overflow,
        contact_overflow=contacts.overflow)
    tracing.stamp("compact")
    joints_rows = None
    if joints is not None:
        joints_rows = joint_ops.joint_rows(state, joints, config)
        tracing.stamp("joints")
    # dropped pairs and rows accumulate on the state itself
    state = state.replace(
        overflow=state.overflow + contacts.overflow + pair_overflow)
    state = integrator.apply_external_forces(state, config)
    tracing.stamp("forces")
    joint_fb = None
    if (joints_rows is not None and with_metrics
            and config.solver is SolverKind.JACOBI):
        # joint feedback from the solved joint impulses
        state, jlam = solver_ops.solve_jacobi(
            state, contacts, config, joints_rows=joints_rows,
            return_joint_lam=True)
        joint_fb = joint_ops.feedback(joints_rows, jlam, config.dt)
    else:
        state = solver_ops.solve(state, contacts, config, joints_rows)
    tracing.stamp("solve.iterate")
    state = integrator.integrate_positions(state, config)
    tracing.stamp("integrate")
    if not with_metrics:
        return state
    metrics = _base_metrics(
        state, **metrics,
        max_penetration=torch.where(contacts.valid, contacts.depth,
                                    0.0).amax(1))
    if joint_fb is not None:
        metrics.update({f"joint_{k}": v for k, v in joint_fb.items()})
    return state, metrics


def _pair_row_counters(state: WorldState, with_metrics: bool, num_pairs,
                       num_contacts, pair_overflow=None,
                       contact_overflow=None, group: int = 1) -> dict:
    """A substep's pair and row counters, from the tensors its pipeline
    made: the pairs tested, the contact rows kept, and the pairs and rows
    dropped at a capacity (None: the pipeline drops none). While tracing
    is on they are summed over the worlds into its device counters
    (``pairs_tested``, ``contact_rows``, ``rows_dropped`` and
    ``world_substeps``, ``utils/tracing``); with ``with_metrics`` they are
    returned per world, (B,) int32, as ``step_with_diagnostics``'
    ``num_pairs``, ``num_contacts``, ``pair_overflow`` and
    ``contact_overflow``. One function for both, so the server's
    diagnostics and the trace cannot disagree. A count given as a bool
    mask (B, …, ``group``) counts the groups of its last axis that hold a
    set entry (the dense pipeline's manifolds); ``num_pairs`` may be an int
    (no bucket enabled), the same in every world."""
    b = state.num_worlds
    tracing.count("pairs_tested", num_pairs if torch.is_tensor(num_pairs)
                  else num_pairs * b, group)
    tracing.count("contact_rows", num_contacts,
                  also=("world_substeps", b))
    for dropped in (pair_overflow, contact_overflow):
        if dropped is not None:
            tracing.count("rows_dropped", dropped)
    if not with_metrics:
        return {}

    def per_world(x, g=1):
        if not torch.is_tensor(x):
            return torch.full_like(state.overflow, x)
        if x.dtype == torch.bool:
            return (x.any(-1) if g > 1 else x).flatten(1).sum(
                1, dtype=torch.int32)
        return x.to(torch.int32)

    zero = None
    if pair_overflow is None or contact_overflow is None:
        zero = torch.zeros_like(state.overflow)
    return dict(
        num_pairs=per_world(num_pairs, group),
        num_contacts=per_world(num_contacts),
        pair_overflow=zero if pair_overflow is None
        else per_world(pair_overflow),
        contact_overflow=zero if contact_overflow is None
        else per_world(contact_overflow))


def _base_metrics(state: WorldState, **counters):
    """The per-tick counters shared by every pipeline, per world: the
    kinetic energy of the dynamic bodies' linear motion and their count."""
    dyn = state.dynamic
    m = torch.where(state.inv_mass > 0,
                    1.0 / torch.clamp_min(state.inv_mass, 1e-30), 0.0)
    kinetic = 0.5 * torch.sum(
        m * torch.where(dyn, torch.sum(state.linvel ** 2, -1), 0.0), -1)
    counters.update(kinetic_energy=kinetic,
                    num_bodies=dyn.sum(-1, dtype=torch.int32))
    return counters


def make_step_fn(config: EngineConfig, substeps: int = 1,
                 donate: bool = True, trimesh: TriMesh | None = None,
                 joints=None):
    """A function state → state that runs ``substeps`` substeps, with
    ``trimesh`` as static scene geometry and ``joints`` as the joint table
    when given: the JAX ``make_step_fn``, parameters in its order.

    On a card the call is one CUDA graph launch (``utils/graphs.py``), the
    counterpart of the JAX ``jax.jit`` over ``lax.scan``; ``donate`` is
    JAX's buffer donation there: with ``donate=True`` the state is updated
    in the graph's buffers and the caller does not read the old handle
    again, with ``donate=False`` the input is left as it was and the result
    is a new state. Under every solver, DANTZIG included (its pivot loop
    is one hand kernel that reads nothing on the host), and with joints.
    On the CPU it is the eager loop."""
    config.validate()
    if substeps < 1:
        raise ValueError(f"substeps={substeps} must be at least 1")
    return graphs.StepFunction(
        lambda state: _step_impl(state, config, trimesh, joints=joints),
        substeps, None, donate, config, joints, closing_stamp="integrate")


def make_diagnostics_step_fn(config: EngineConfig):
    """``step_with_diagnostics`` as one graph launch on a card: a function
    state → (state, {name: (B,) tensor}), the JAX server's
    ``jax.jit(lambda s: step_with_diagnostics(s, cfg))``
    (``rl_ode_physics_tpu/net/server.py:79``), not donated as there: the
    state and the counters are new tensors at every call. Eager on the
    CPU, as ``make_step_fn``."""
    config.validate()
    return graphs.Graphed(
        lambda state, _: _step_impl(state, config, None, with_metrics=True),
        None, False, config, closing_stamp="integrate")
