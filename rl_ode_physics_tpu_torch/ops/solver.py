"""Contact solver: batched projected Jacobi with mass splitting, and
sequential projected Gauss-Seidel; the dispatch to the direct LCP solve.

The port of ``rl_ode_physics_tpu/ops/solver.py``: the Jacobi loop with
heavy-ball momentum in its row-major and component-major (``solver_cm``)
forms, with bf16 or float32 selector products; PGS in buffer row order
(ODE QuickStep's ordering, the conformance solver); μ=∞, finite μ and
per-body surface parameters; warm starting (``lam0``) and impulse outputs
(``return_lam``); joint rows (``ops/joints.py``) after each contact sweep;
``solve``, which also routes DANTZIG to ``ops/lcp.py``.

Per contact row (normal n, arms r_a/r_b, bodies a, b), in impulse space:
    v_n    = (v_b + w_b × r_b − v_a − w_a × r_a) · n
    target = max(erp/dt · depth, bounce · (−v_n⁰) if −v_n⁰ > bounce_vel)
    dλ     = ω · (target − v_n − (cfm/dt)·λ) / d,   λ ← max(λ + dλ, 0)
with two friction rows bounded by μ·λ_n. Each body's inverse mass is split
by the number of contacts touching it, which keeps the parallel update
from overshooting.

Contact↔body data movement is the one-hot selector product of the JAX
package, as ``torch.bmm``: the gather ``S @ vel`` and the scatter
``Sᵀ @ contrib``. Both are deterministic on the card, where an
``index_add_`` would sum in an order that changes from run to run. Their
operands are in ``solver_matmul_dtype`` and their results in the state's
dtype, as JAX's ``preferred_element_type``. A float32 matmul stays float32
on the card only with TF32 off, which is PyTorch's default; the solvers
raise if it was turned on.

PGS is sequential over rows: row i reads the velocities row i − 1 wrote.
Its rows are built batched; its sweeps, joint passes included, are one
launch of the hand kernel ``csrc/pgs_solve.cu`` on the card
(``ops/pgs_kernel.pgs_solve``), which finds each world's live rows on the
device, so a CUDA graph holds the solve. On the CPU they are the plain
version, ``pgs_sweeps_plain``: a Python loop, a few dozen operations on
(B,) tensors a row, that stops at the batch's last live row (one host
read): a dead row adds ``axis·0`` to the velocities, so the rows past it
change nothing while their geometry is finite.
"""

from __future__ import annotations

import math

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState, world_inv_inertia
from rl_ode_physics_tpu_torch.ops import joints as joint_ops
from rl_ode_physics_tpu_torch.ops import pgs_kernel
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts
from rl_ode_physics_tpu_torch.utils import tracing

_EPS = 1e-9


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _tangent_basis(n):
    """Deterministic orthonormal (t1, t2) completing normal n; (..., 3)."""
    ax = torch.argmin(torch.abs(n), dim=-1)
    e = torch.nn.functional.one_hot(ax, 3).to(n.dtype)
    t1 = _cross(n, e)
    t1 = t1 / torch.clamp_min(
        torch.sqrt(torch.sum(t1 * t1, dim=-1, keepdim=True)), _EPS)
    t2 = _cross(n, t1)
    return t1, t2


def _gather_body_features(state: WorldState, s_mat, kappa):
    """Per-contact body features for both sides via one selector product
    (B, 2C, N)·(B, N, 16)."""
    b, n = state.num_worlds, state.num_slots
    c = s_mat.shape[1] // 2
    inv_i = world_inv_inertia(state)                    # (B, N, 3, 3)
    # 1/mu rides the product instead of mu: 0·inf would be NaN
    inv_mu = 1.0 / torch.clamp_min(state.friction, _EPS)
    feats = torch.cat([
        state.pos,
        inv_i.reshape(b, n, 9),
        state.inv_mass[..., None],
        kappa[..., None],
        inv_mu[..., None],
        state.restitution[..., None],
    ], dim=-1)                                          # (B, N, 16)
    fh = torch.bmm(s_mat, feats)                        # (B, 2C, 16)
    return dict(
        pos_a=fh[:, :c, 0:3], pos_b=fh[:, c:, 0:3],
        inv_i_a=fh[:, :c, 3:12].reshape(b, c, 3, 3),
        inv_i_b=fh[:, c:, 3:12].reshape(b, c, 3, 3),
        inv_m_a=fh[:, :c, 12], inv_m_b=fh[:, c:, 12],
        kappa_a=fh[:, :c, 13], kappa_b=fh[:, c:, 13],
        inv_mu_a=fh[:, :c, 14], inv_mu_b=fh[:, c:, 14],
        bounce_a=fh[:, :c, 15], bounce_b=fh[:, c:, 15],
        inv_i=inv_i,
        s_mat=s_mat,
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) per-slot values at (B, C) slots → (B, C, ...)."""
    b, c = idx.shape
    flat = x.reshape(b, x.shape[1], -1)
    out = torch.gather(flat, 1, idx.to(torch.int64)[..., None].expand(
        b, c, flat.shape[-1]))
    return out.reshape((b, c) + x.shape[2:])


def _direct_body_features(state: WorldState, contacts: Contacts):
    """Per-contact body features by index: the PGS path's direct gathers
    (``_row_data`` of the JAX package without ``gathered``)."""
    inv_i = world_inv_inertia(state)                    # (B, N, 3, 3)
    vel = torch.cat([state.linvel, state.angvel], -1)   # (B, N, 6)
    a, b = contacts.a, contacts.b
    return dict(
        pos_a=_take(state.pos, a), pos_b=_take(state.pos, b),
        inv_i_a=_take(inv_i, a), inv_i_b=_take(inv_i, b),
        inv_m_a=_take(state.inv_mass, a), inv_m_b=_take(state.inv_mass, b),
        vel_a=_take(vel, a), vel_b=_take(vel, b),
        friction_a=_take(state.friction, a),
        friction_b=_take(state.friction, b),
        bounce_a=_take(state.restitution, a),
        bounce_b=_take(state.restitution, b),
        inv_i=inv_i,
    )


def _row_data(state: WorldState, contacts: Contacts, config: EngineConfig,
              gathered):
    """Per-row geometry, effective masses and rhs targets from the body
    features ``gathered`` by the selector product or, for PGS, by index."""
    dt = config.dt
    n = contacts.normal
    p = contacts.point
    c = n.shape[1]

    pos_a, pos_b = gathered["pos_a"], gathered["pos_b"]
    inv_i_a, inv_i_b = gathered["inv_i_a"], gathered["inv_i_b"]
    inv_m_a, inv_m_b = gathered["inv_m_a"], gathered["inv_m_b"]

    r_a = p - pos_a
    r_b = p - pos_b

    t1, t2 = _tangent_basis(n)

    def eff_mass(axis):
        rxn_a = _cross(r_a, axis)
        rxn_b = _cross(r_b, axis)
        ang_a = torch.sum(inv_i_a * rxn_a[..., None, :], dim=-1)
        ang_b = torch.sum(inv_i_b * rxn_b[..., None, :], dim=-1)
        return (
            inv_m_a + inv_m_b
            + torch.sum(rxn_a * ang_a, dim=-1)
            + torch.sum(rxn_b * ang_b, dim=-1)
        )

    cfm_term = config.cfm / dt
    d_n = eff_mass(n) + cfm_term
    d_t1 = eff_mass(t1) + cfm_term
    d_t2 = eff_mass(t2) + cfm_term

    # rhs: ERP bias capped by max_correcting_vel, bounce from pre-solve v_n
    if "vel_a" in gathered:
        vel_a, vel_b = gathered["vel_a"], gathered["vel_b"]
    else:
        vh = torch.bmm(gathered["s_mat"],
                       torch.cat([state.linvel, state.angvel], -1))
        vel_a, vel_b = vh[:, :c], vh[:, c:]
    va0 = vel_a[..., 0:3] + _cross(vel_a[..., 3:6], r_a)
    vb0 = vel_b[..., 0:3] + _cross(vel_b[..., 3:6], r_b)
    v0 = vb0 - va0
    v_n0 = torch.sum(v0 * n, dim=-1)

    bias = torch.clamp_max(config.erp * contacts.depth / dt,
                           config.max_correcting_vel)
    mu_row = None
    if config.per_body_surface:
        # pair mixing: min(friction), by index or via max of the shipped
        # inverses, and max(restitution)
        if "friction_a" in gathered:
            mu_row = torch.minimum(gathered["friction_a"],
                                   gathered["friction_b"])
        else:
            inv_mu = torch.maximum(gathered["inv_mu_a"], gathered["inv_mu_b"])
            mu_row = torch.where(inv_mu > _EPS,
                                 1.0 / torch.clamp_min(inv_mu, _EPS),
                                 torch.inf)
        bounce_row = torch.maximum(gathered["bounce_a"], gathered["bounce_b"])
    else:
        bounce_row = config.bounce
    bounce_target = torch.where(
        -v_n0 > config.bounce_vel, -bounce_row * v_n0, 0.0)
    target = torch.maximum(bias, bounce_target)
    target = torch.where(contacts.valid, target, 0.0)

    return dict(
        r_a=r_a, r_b=r_b, n=n, t1=t1, t2=t2,
        d_n=d_n, d_t1=d_t1, d_t2=d_t2,
        target=target, inv_i=gathered["inv_i"], mu=mu_row,
    )


def _half_row_selector(state: WorldState, contacts: Contacts):
    """One-hot half-row selector S (B, 2C, N) and contact counts κ (B, N).

    Rows 0..C−1 select contact i's body a, rows C..2C−1 its body b; rows of
    invalid contacts are zero.
    """
    n = state.num_slots
    body_of_half = torch.cat([contacts.a, contacts.b], dim=1)     # (B, 2C)
    valid_half = torch.cat([contacts.valid, contacts.valid], dim=1)
    cols = torch.arange(n, dtype=torch.int32, device=state.device)
    sel = ((body_of_half[..., None] == cols) & valid_half[..., None])
    s = sel.to(state.linvel.dtype)                                # (B, 2C, N)
    counts = torch.sum(s, dim=1)                                  # (B, N)
    kappa = torch.clamp_min(counts, 1.0)
    return s, kappa


def _cross_mat(r):
    zero = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([zero, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], zero, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], zero], -1),
    ], -2)


def _mm3(a, b):
    """(…,3,3)@(…,3,3) as a broadcast-sum."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def pack_solver_inputs(state: WorldState, contacts: Contacts,
                       config: EngineConfig):
    """Once-per-substep packed solver constants:

      s_mat   (B, 2C, N): one-hot half-row selector (a-rows ‖ b-rows)
      rowdata (B, C, 32): n t1 t2 | r×n per side/axis | d_n d_t1 d_t2
                          (mass-split, CFM-softened) | target | live
      halfop  (B, 2C, 16): impulse→Δv angular operator (row-major 9) |
                           signed inverse-mass scale | pad
      vel     (B, N, 8):  linvel ‖ angvel ‖ pad
    """
    f = state.linvel.dtype
    b = state.num_worlds
    c = contacts.a.shape[1]

    s_mat, kappa = _half_row_selector(state, contacts)
    gathered = _gather_body_features(state, s_mat, kappa)
    # split masses: each contact sees its bodies' inverse mass scaled by the
    # per-pair max count
    split = torch.maximum(gathered["kappa_a"], gathered["kappa_b"])

    rows = _row_data(state, contacts, config, gathered)
    cfm_term = config.cfm / config.dt
    d_n = (rows["d_n"] - cfm_term) * split + cfm_term
    d_t1 = (rows["d_t1"] - cfm_term) * split + cfm_term
    d_t2 = (rows["d_t2"] - cfm_term) * split + cfm_term

    r_a, r_b = rows["r_a"], rows["r_b"]
    n_ax, t1_ax, t2_ax = rows["n"], rows["t1"], rows["t2"]

    rowdata = torch.cat([
        n_ax, t1_ax, t2_ax,
        _cross(r_a, n_ax), _cross(r_b, n_ax),
        _cross(r_a, t1_ax), _cross(r_b, t1_ax),
        _cross(r_a, t2_ax), _cross(r_b, t2_ax),
        d_n[..., None], d_t1[..., None], d_t2[..., None],
        rows["target"][..., None],
        contacts.valid.to(f)[..., None],
    ], dim=-1)                                         # (B, C, 32)

    # constant per-half-row impulse→Δv operators:
    #   Δlin = ±inv_m·imp ;  Δang = invI·(r × ±imp) = ±(invI·[r]×)·imp
    ang_op_a = -_mm3(gathered["inv_i_a"], _cross_mat(r_a))   # (B, C, 3, 3)
    ang_op_b = _mm3(gathered["inv_i_b"], _cross_mat(r_b))
    ang_op = torch.cat([ang_op_a, ang_op_b], 1).reshape(b, 2 * c, 9)
    lin_sc = torch.cat(
        [-gathered["inv_m_a"], gathered["inv_m_b"]], dim=1)[..., None]
    halfop = torch.cat(
        [ang_op, lin_sc, torch.zeros((b, 2 * c, 6), dtype=f,
                                     device=state.device)], dim=-1)

    vel = torch.cat(
        [state.linvel, state.angvel,
         torch.zeros(state.linvel.shape[:-1] + (2,), dtype=f,
                     device=state.device)], dim=-1)   # (B, N, 8)
    extras = {"mu": rows["mu"]}          # per-row friction, or None
    return s_mat, rowdata, halfop, vel, extras


def _check_solver(state: WorldState) -> None:
    """Raise if TF32 products are on: the selector products of a float32
    solve must run in full float32."""
    if state.pos.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the "
                           "selector products must run in full float32")


def bf16_product_route(device) -> str:
    """How a product of two bf16 tensors is taken with a float32 result:
    ``"out_dtype"`` on CUDA (``torch.bmm(..., out_dtype=torch.float32)``,
    float32 accumulation) or ``"upcast"`` on the CPU, where that overload
    raises (both operands to float32 first: their products are exact in
    float32, so only the summation order differs)."""
    return "out_dtype" if torch.device(device).type == "cuda" else "upcast"


def _mm(a: torch.Tensor, b: torch.Tensor, f: torch.dtype) -> torch.Tensor:
    """``a @ b`` batched with operands of the solver's product dtype and the
    result in ``f``, as JAX's ``preferred_element_type=f``: a bf16 pair is
    not rounded to bf16, float32 operands of a float64 state give a float64
    result."""
    if a.dtype == b.dtype == f:
        return torch.bmm(a, b)
    if (a.dtype == torch.bfloat16 and f == torch.float32
            and bf16_product_route(a.device) == "out_dtype"):
        return torch.bmm(a, b, out_dtype=f)
    return torch.bmm(a.to(f), b.to(f))


def solve_jacobi(state: WorldState, contacts: Contacts,
                 config: EngineConfig, lam0=None, return_lam: bool = False,
                 joints_rows=None, return_joint_lam: bool = False):
    """Batched projected Jacobi with mass splitting, ``solver_iterations``
    sweeps. ``lam0``: (B, C, 3) initial impulses (normal, t1, t2), applied
    to the velocities up front (warm start); ``return_lam`` also returns
    the accumulated (B, C, 3) impulses. ``joints_rows``
    (``ops/joints.joint_rows``): a batched joint pass after each contact
    sweep; ``return_joint_lam`` returns its (B, R) impulses instead.

    ``solver_matmul_dtype="bfloat16"``: the selector, the velocities
    gathered and the impulses scattered are rounded to bf16, and the
    (2C, 8) response and J planes are stored in bf16; every product's
    result and every other value stays in the state's dtype.
    ``solver_cm``: the component-major loop, for a cold contact-only solve
    that returns no impulses (otherwise the row-major loop runs)."""
    if return_joint_lam and joints_rows is None:
        raise ValueError("return_joint_lam=True requires joints_rows")
    _check_solver(state)
    c = contacts.a.shape[1]
    f = state.linvel.dtype

    s_mat, rows, hop, vel0, extras = pack_solver_inputs(
        state, contacts, config)

    n_ax, t1_ax, t2_ax = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    rxa_n, rxb_n = rows[..., 9:12], rows[..., 12:15]
    rxa_1, rxb_1 = rows[..., 15:18], rows[..., 18:21]
    rxa_2, rxb_2 = rows[..., 21:24], rows[..., 24:27]
    d_n, d_t1, d_t2 = rows[..., 27:28], rows[..., 28:29], rows[..., 29:30]
    target = rows[..., 30:31]
    live = rows[..., 31:32] > 0.5
    h = hop[..., 0:9]
    lin_sc = hop[..., 9:10]

    omega = config.jacobi_omega
    cfm_term = config.cfm / config.dt
    mu_inf = math.isinf(config.mu)

    mm_dtype = getattr(torch, config.solver_matmul_dtype)
    s_mm = s_mat.to(mm_dtype)
    s_mm_t = s_mm.transpose(1, 2)
    # the loop's (2C, 8) planes are stored in bf16 with bf16 products
    plane_dt = mm_dtype if mm_dtype == torch.bfloat16 else f

    def _axis_contrib_op(axis_rows):
        """(B, C, 3) constraint axis → (B, 2C, 8) per-half-row Δv response
        per unit impulse magnitude."""
        ax_h = torch.cat([axis_rows, axis_rows], dim=1)          # (B, 2C, 3)
        ix, iy, iz = ax_h[..., 0:1], ax_h[..., 1:2], ax_h[..., 2:3]
        angx = h[..., 0:1] * ix + h[..., 1:2] * iy + h[..., 2:3] * iz
        angy = h[..., 3:4] * ix + h[..., 4:5] * iy + h[..., 5:6] * iz
        angz = h[..., 6:7] * ix + h[..., 7:8] * iy + h[..., 8:9] * iz
        return torch.cat(
            [lin_sc * ax_h, angx, angy, angz,
             torch.zeros_like(ax_h[..., 0:2])], dim=-1).to(plane_dt)

    def _axis_j_op(axis_rows, rxa, rxb):
        """(B, C, 3) axis + arm crosses → (B, 2C, 8) J-row weight planes."""
        z2 = torch.zeros_like(axis_rows[..., 0:2])
        w_a = torch.cat([-axis_rows, -rxa, z2], dim=-1)
        w_b = torch.cat([axis_rows, rxb, z2], dim=-1)
        return torch.cat([w_a, w_b], dim=1).to(plane_dt)

    k_op_n = _axis_contrib_op(n_ax)
    j_op_n = _axis_j_op(n_ax, rxa_n, rxb_n)
    if config.friction:
        k_op_1, k_op_2 = _axis_contrib_op(t1_ax), _axis_contrib_op(t2_ax)
        j_op_1 = _axis_j_op(t1_ax, rxa_1, rxb_1)
        j_op_2 = _axis_j_op(t2_ax, rxa_2, rxb_2)

    beta = float(config.jacobi_beta)
    momentum = beta != 0.0
    with_joints = joints_rows is not None
    tracing.stamp("solve.rows")

    def friction_bound(lam_n, mu):
        if config.per_body_surface:
            return torch.where(torch.isinf(mu),
                               torch.full_like(lam_n, torch.inf), mu * lam_n)
        if mu_inf:
            return torch.full_like(lam_n, torch.inf)
        return config.mu * lam_n

    def project(lam, dl, live_x, bound=None):
        """λ + dl clamped (at 0 for a normal row, within ±bound for a
        friction row) on the live rows: (the step taken, the new λ)."""
        new = (torch.clamp_min(lam + dl, 0.0) if bound is None
               else torch.clamp(lam + dl, -bound, bound))
        dl = torch.where(live_x, new - lam, 0.0)
        return dl, lam + dl

    if (config.solver_cm and not with_joints and lam0 is None
            and not return_lam):
        # component-major: contacts along the last axis, planes (8, 2C),
        # λ, d, target (1, C), the velocities (8, N); the same math
        def t(x):
            return x.transpose(1, 2).contiguous()

        d_n_t, target_t, live_t = t(d_n), t(target), t(live)
        j_t, k_t = [t(j_op_n)], [t(k_op_n)]
        if config.friction:
            d_t = (t(d_t1), t(d_t2))
            j_t += [t(j_op_1), t(j_op_2)]
            k_t += [t(k_op_1), t(k_op_2)]
        mu_t = t(extras["mu"][..., None]) if config.per_body_surface else None

        def dup_t(x):                                    # (B,1,C)→(B,1,2C)
            return torch.cat([x, x], dim=2)

        vel_t = t(vel0)                                  # (B, 8, N)
        zc = torch.zeros_like(target_t)
        lam = [zc] * (3 if config.friction else 1)
        prev = list(lam)
        for _ in range(config.solver_iterations):
            if momentum:
                mom = [beta * (x - p) for x, p in zip(lam, prev)]
                prev = list(lam)
            vh_t = _mm(vel_t.to(mm_dtype), s_mm_t, f)    # (B, 8, 2C)

            def rel(jt):
                r2 = torch.sum(jt * vh_t, 1, keepdim=True)   # (B, 1, 2C)
                return r2[..., :c] + r2[..., c:]

            dl = omega * (target_t - rel(j_t[0])
                          - cfm_term * lam[0]) / d_n_t
            if momentum:
                dl = dl + mom[0]
            dls = [None] * len(lam)
            dls[0], lam[0] = project(lam[0], dl, live_t)
            if config.friction:
                bound = friction_bound(lam[0], mu_t)
                for ax in (1, 2):
                    dl = omega * (-rel(j_t[ax])
                                  - cfm_term * lam[ax]) / d_t[ax - 1]
                    if momentum:
                        dl = dl + mom[ax]
                    dls[ax], lam[ax] = project(lam[ax], dl, live_t, bound)
            contrib = k_t[0] * dup_t(dls[0])
            for ax in range(1, len(lam)):
                contrib = contrib + k_t[ax] * dup_t(dls[ax])
            vel_t = vel_t + _mm(contrib.to(mm_dtype), s_mm, f)   # (B, 8, N)
        vel8 = t(vel_t)
        return state.replace(linvel=vel8[..., 0:3].contiguous(),
                             angvel=vel8[..., 3:6].contiguous())

    def scatter_dl(dl_n, dl_1=None, dl_2=None):
        """Per-axis impulse magnitudes (B, C, 1) → (B, N, 8) Δvel."""
        def dup(x):
            return torch.cat([x, x], dim=1)                     # (B, 2C, 1)
        contrib = k_op_n * dup(dl_n)
        if dl_1 is not None:
            contrib = contrib + k_op_1 * dup(dl_1) + k_op_2 * dup(dl_2)
        return _mm(s_mm_t, contrib.to(mm_dtype), f)              # (B, N, 8)

    def rel(j_op, vh):
        """Per-row relative velocity, halves folded: (B, C, 1)."""
        r2 = torch.sum(j_op * vh, -1, keepdim=True)             # (B, 2C, 1)
        return r2[:, :c] + r2[:, c:]

    zero = torch.zeros(contacts.valid.shape + (1,), dtype=f,
                       device=state.device)
    if lam0 is None:
        l_n = l_1 = l_2 = zero
    else:
        # warm start: the cached impulses go through the same scatter
        l_n, l_1, l_2 = (torch.where(contacts.valid, lam0[..., j].to(f),
                                     0.0)[..., None] for j in range(3))
        if config.friction:
            vel0 = vel0 + scatter_dl(l_n, l_1, l_2)
        else:
            vel0 = vel0 + scatter_dl(l_n)
    vel, lam_n, lam_t1, lam_t2 = vel0, l_n, l_1, l_2
    pn, p1, p2 = l_n, l_1, l_2
    if with_joints:
        jlam = torch.zeros_like(joints_rows["rhs"])
    for _ in range(config.solver_iterations):
        if momentum:
            # heavy-ball: extrapolate with the previous accepted step before
            # projecting
            mom_n, mom_1, mom_2 = (beta * (lam_n - pn), beta * (lam_t1 - p1),
                                   beta * (lam_t2 - p2))
            pn, p1, p2 = lam_n, lam_t1, lam_t2
        else:
            mom_n = mom_1 = mom_2 = 0.0

        vh = _mm(s_mm, vel.to(mm_dtype), f)                     # (B, 2C, 8)

        dl_n = omega * (target - rel(j_op_n, vh)
                        - cfm_term * lam_n) / d_n + mom_n
        dl_n, lam_n = project(lam_n, dl_n, live)

        if config.friction:
            bound = friction_bound(
                lam_n, extras["mu"][..., None] if config.per_body_surface
                else None)
            dl_1 = omega * (-rel(j_op_1, vh)
                            - cfm_term * lam_t1) / d_t1 + mom_1
            dl_1, lam_t1 = project(lam_t1, dl_1, live, bound)
            dl_2 = omega * (-rel(j_op_2, vh)
                            - cfm_term * lam_t2) / d_t2 + mom_2
            dl_2, lam_t2 = project(lam_t2, dl_2, live, bound)
            dv = scatter_dl(dl_n, dl_1, dl_2)
        else:
            dv = scatter_dl(dl_n)

        vel = vel + dv
        if with_joints:
            # the bilateral rows after each contact sweep
            vel, jlam = joint_ops.joint_iteration(vel, joints_rows, jlam,
                                                  omega, cfm_term)

    out = state.replace(linvel=vel[..., 0:3].contiguous(),
                        angvel=vel[..., 3:6].contiguous())
    if return_joint_lam:
        return out, jlam
    if return_lam:
        return out, torch.cat([lam_n, lam_t1, lam_t2], dim=-1)
    return out


def live_row_bound(valid: torch.Tensor) -> int:
    """One past the last row that is live in some world of the batch: the
    rows a sequential sweep must visit. One host read."""
    c = valid.shape[1]
    if c == 0:
        return 0
    last = torch.arange(1, c + 1, device=valid.device) * valid.any(0)
    return int(last.max())


def pgs_params(config: EngineConfig) -> dict:
    """The scalar parameters of a PGS solve under ``config``, as
    ``pgs_sweeps_plain`` and ``ops/pgs_kernel.pgs_solve`` take them."""
    return dict(iterations=config.solver_iterations, omega=config.sor_omega,
                cfm_term=config.cfm / config.dt, friction=config.friction,
                mu=config.mu, per_body_surface=config.per_body_surface)


def pgs_sweeps_plain(vel, lam, rows, joints_rows=None, *, iterations: int,
                     omega: float, cfm_term: float, friction: bool = True,
                     mu: float = math.inf, per_body_surface: bool = False):
    """The plain version of ``ops/pgs_kernel.pgs_solve``: ``iterations``
    sweeps in buffer row order, a Python loop over rows on (B,) tensors,
    batched over worlds. ``vel`` (B, N, 6); ``lam`` (B, C, 3) the starting
    impulses; ``rows`` the contact row table (``pgs_inputs``), or None
    with ``lam`` for the joint passes alone; ``joints_rows``
    (``ops/joints.joint_rows``): a sequential joint pass after each
    contact sweep. Each sweep stops at ``live_row_bound`` of the rows, and
    the joint passes visit ``live_joint_rows``: rows past them are dead in
    every world, and a dead row changes nothing. Those are host reads, so
    this loop is for the CPU. Returns (vel', lam'), lam' None without
    contact rows."""
    rows_bound = 0 if rows is None else live_row_bound(rows["valid"])

    def by_row(x):
        """(B, C, ...) → (C, B, ...), so that row i is a view."""
        return x.transpose(0, 1).contiguous()

    if rows_bound:
        a_r, b_r = by_row(rows["a"].to(torch.int64)), by_row(
            rows["b"].to(torch.int64))
        live_r = by_row(rows["valid"])
        r_a, r_b = by_row(rows["r_a"]), by_row(rows["r_b"])
        im_a, im_b = by_row(rows["inv_m_a"]), by_row(rows["inv_m_b"])
        ii_a, ii_b = by_row(rows["inv_i_a"]), by_row(rows["inv_i_b"])
        axes = [by_row(rows[k]) for k in ("n", "t1", "t2")]
        d_r = [by_row(rows[k]) for k in ("d_n", "d_t1", "d_t2")]
        target_r = by_row(rows["target"])
        mu_r = by_row(rows["mu"]) if per_body_surface else None
    ar = torch.arange(vel.shape[0], device=vel.device)
    mu_inf = math.isinf(mu)

    vel = vel.clone()                                   # (B, N, 6), updated
    if lam is not None:
        lam = lam.permute(2, 1, 0).contiguous()         # (3, C, B)
        lam_n, lam_t1, lam_t2 = lam[0], lam[1], lam[2]

    def rel_v(i, axis):
        va = vel[ar, a_r[i]]
        vb = vel[ar, b_r[i]]
        va = va[:, 0:3] + _cross(va[:, 3:6], r_a[i])
        vb = vb[:, 0:3] + _cross(vb[:, 3:6], r_b[i])
        return torch.sum((vb - va) * axis, -1)

    def apply_pair(i, axis, dlam):
        imp = axis * dlam[:, None]
        for body, r, im, ii, sgn_imp in ((a_r[i], r_a[i], im_a[i], ii_a[i],
                                          -imp),
                                         (b_r[i], r_b[i], im_b[i], ii_b[i],
                                          imp)):
            ang = torch.sum(ii * _cross(r, sgn_imp)[:, None, :], -1)
            vel[ar, body] += torch.cat([im[:, None] * sgn_imp, ang], -1)

    def friction_row(i, axis, d, lam_t, bound):
        dls = omega * (0.0 - rel_v(i, axis) - cfm_term * lam_t[i]) / d[i]
        new_l = torch.clamp(lam_t[i] + dls, -bound, bound)
        dls = torch.where(live_r[i], new_l - lam_t[i], 0.0)
        lam_t[i] += dls
        apply_pair(i, axis, dls)

    if joints_rows is not None:
        jlam = torch.zeros_like(joints_rows["rhs"])
        visit = joint_ops.live_joint_rows(joints_rows)
        pad = torch.zeros_like(vel[..., :2])

    for _ in range(iterations):
        for i in range(rows_bound):
            # normal row (the residual includes ODE's CFM softening −cfm/h·λ)
            n_i = axes[0][i]
            dlam = omega * (target_r[i] - rel_v(i, n_i)
                            - cfm_term * lam_n[i]) / d_r[0][i]
            new_lam = torch.clamp_min(lam_n[i] + dlam, 0.0)
            dlam = torch.where(live_r[i], new_lam - lam_n[i], 0.0)
            lam_n[i] += dlam
            apply_pair(i, n_i, dlam)

            # friction rows (target velocity 0, bound μ·λ_n)
            if friction:
                if per_body_surface:
                    mu_i = mu_r[i]
                    bound = torch.where(torch.isinf(mu_i),
                                        torch.full_like(mu_i, torch.inf),
                                        mu_i * lam_n[i])
                elif mu_inf:
                    bound = torch.full_like(lam_n[i], torch.inf)
                else:
                    bound = mu * lam_n[i]
                friction_row(i, axes[1][i], d_r[1], lam_t1, bound)
                friction_row(i, axes[2][i], d_r[2], lam_t2, bound)
        if joints_rows is not None:
            # the bilateral rows after each contact sweep, sequential like
            # it: the batched pass diverges on chains that share a body
            vel8, jlam = joint_ops.joint_iteration_seq(
                torch.cat([vel, pad], -1), joints_rows, jlam, omega,
                cfm_term, visit)
            vel = vel8[..., 0:6].contiguous()

    if lam is None:
        return vel, None
    return vel, lam.permute(2, 1, 0).contiguous()


def pgs_inputs(state: WorldState, contacts: Contacts, config: EngineConfig,
               lam0=None):
    """What the sweeps of a PGS solve start from, built batched: (vel
    (B, N, 6), lam (B, C, 3), the row table: (B, C, ...) tensors of
    ``_row_data`` and ``_direct_body_features`` as ``pgs_sweeps_plain`` and
    the kernel take them). With ``lam0`` (B, C, 3), the cached impulses of
    the live rows are applied to the velocities up front (warm start) and
    are ``lam``."""
    feats = _direct_body_features(state, contacts)
    rows = _row_data(state, contacts, config, feats)
    bsz, c = contacts.a.shape
    vel = torch.cat([state.linvel, state.angvel], -1)   # (B, N, 6)
    if lam0 is None:
        lam = torch.zeros((bsz, c, 3), dtype=vel.dtype, device=state.device)
    else:
        # one-hot products spread the impulses over the bodies
        lam = torch.where(contacts.valid[..., None], lam0.to(vel.dtype),
                          0.0)                                 # (B, C, 3)
        imp = (rows["n"] * lam[..., 0:1] + rows["t1"] * lam[..., 1:2]
               + rows["t2"] * lam[..., 2:3])
        n_slots = state.num_slots
        for sign, body, r, im, ii in (
                (-1.0, contacts.a, rows["r_a"], feats["inv_m_a"],
                 feats["inv_i_a"]),
                (1.0, contacts.b, rows["r_b"], feats["inv_m_b"],
                 feats["inv_i_b"])):
            dlin = sign * im[..., None] * imp
            torque = sign * _cross(r, imp)
            dang = torch.sum(ii * torque[..., None, :], -1)
            oh_t = torch.nn.functional.one_hot(
                body.to(torch.int64), n_slots).to(vel.dtype).transpose(1, 2)
            vel = vel + torch.cat([torch.bmm(oh_t, dlin),
                                   torch.bmm(oh_t, dang)], -1)
    table = {k: rows[k] for k in ("r_a", "r_b", "n", "t1", "t2", "d_n",
                                  "d_t1", "d_t2", "target", "mu")}
    table.update({k: feats[k] for k in ("inv_m_a", "inv_m_b", "inv_i_a",
                                        "inv_i_b")})
    table.update(a=contacts.a, b=contacts.b, valid=contacts.valid)
    return vel, lam, table


def solve_pgs(state: WorldState, contacts: Contacts, config: EngineConfig,
              lam0=None, return_lam: bool = False, joints_rows=None):
    """Sequential projected Gauss-Seidel (SOR) in buffer row order, ODE
    QuickStep's ordering: ``solver_iterations`` sweeps, each row seeing the
    velocities the rows before it wrote; batched over worlds.

    ``lam0``: (B, C, 3) initial impulses, applied to the velocities up
    front (warm start); ``return_lam`` also returns the accumulated
    (B, C, 3) impulses. ``joints_rows`` (``ops/joints.joint_rows``): a
    sequential joint pass after each contact sweep. The rows are built
    batched (``pgs_inputs``); the sweeps are ``ops/pgs_kernel.pgs_solve``:
    one launch of the hand kernel on the card, the plain loop
    (``pgs_sweeps_plain``) on the CPU."""
    _check_solver(state)
    vel, lam, table = pgs_inputs(state, contacts, config, lam0)
    tracing.stamp("solve.rows")
    vel, lam = pgs_kernel.pgs_solve(vel, lam, table, joints_rows,
                                    **pgs_params(config))
    out = state.replace(linvel=vel[..., 0:3].contiguous(),
                        angvel=vel[..., 3:6].contiguous())
    if return_lam:
        return out, lam
    return out


def solve(state: WorldState, contacts: Contacts,
          config: EngineConfig, joints_rows=None) -> WorldState:
    """The contact solve of one substep: JACOBI, PGS or DANTZIG. With
    ``joints_rows``, DANTZIG's direct contact solve is followed by
    ``solver_iterations`` sequential joint passes at ω = 1."""
    if config.solver is SolverKind.PGS:
        return solve_pgs(state, contacts, config, joints_rows=joints_rows)
    if config.solver is SolverKind.DANTZIG:
        # imported here: ops/lcp builds on this module's row data
        from rl_ode_physics_tpu_torch.ops.lcp import solve_dantzig
        state = solve_dantzig(state, contacts, config)
        if joints_rows is not None:
            # iterative bilateral relaxation after the direct contact
            # solve: the joint passes alone, at ω = 1
            vel, _ = pgs_kernel.pgs_solve(
                torch.cat([state.linvel, state.angvel], -1), None, None,
                joints_rows, **dict(pgs_params(config), omega=1.0))
            state = state.replace(linvel=vel[..., 0:3].contiguous(),
                                  angvel=vel[..., 3:6].contiguous())
        return state
    return solve_jacobi(state, contacts, config, joints_rows=joints_rows)
