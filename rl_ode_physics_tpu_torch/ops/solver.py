"""Contact solver: batched projected Jacobi with mass splitting.

The port of the JACOBI path of ``rl_ode_physics_tpu/ops/solver.py``
(``:54-190``, ``:334-545``, ``:636-765``): the row-major iteration loop with
heavy-ball momentum, μ=∞ or finite μ, and per-body surface parameters.

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
``index_add_`` would sum in an order that changes from run to run. A
float32 matmul stays float32 on the card only with TF32 off, which is
PyTorch's default; ``solve_jacobi`` raises if it was turned on.
"""

from __future__ import annotations

import math

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
from rl_ode_physics_tpu_torch.core.state import WorldState, world_inv_inertia
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts

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


def _row_data(state: WorldState, contacts: Contacts, config: EngineConfig,
              gathered):
    """Per-row geometry, effective masses and rhs targets from the
    selector-gathered body features."""
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
    vh = torch.bmm(gathered["s_mat"],
                   torch.cat([state.linvel, state.angvel], -1))
    va0 = vh[:, :c, 0:3] + _cross(vh[:, :c, 3:6], r_a)
    vb0 = vh[:, c:, 0:3] + _cross(vh[:, c:, 3:6], r_b)
    v0 = vb0 - va0
    v_n0 = torch.sum(v0 * n, dim=-1)

    bias = torch.clamp_max(config.erp * contacts.depth / dt,
                           config.max_correcting_vel)
    mu_row = None
    if config.per_body_surface:
        # pair mixing: min(friction) via max of the shipped inverses,
        # max(restitution)
        inv_mu = torch.maximum(gathered["inv_mu_a"], gathered["inv_mu_b"])
        mu_row = torch.where(inv_mu > _EPS,
                             1.0 / torch.clamp_min(inv_mu, _EPS), torch.inf)
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


def solve_jacobi(state: WorldState, contacts: Contacts,
                 config: EngineConfig, lam0=None, return_lam: bool = False,
                 joints_rows=None):
    """Batched projected Jacobi with mass splitting, ``solver_iterations``
    sweeps of the row-major loop. Warm starting (``lam0``), impulse outputs
    (``return_lam``), joints and the component-major loop (``solver_cm``)
    are not ported and raise."""
    if lam0 is not None or return_lam:
        raise NotImplementedError("warm starting and impulse outputs are "
                                  "not ported")
    if joints_rows is not None:
        raise NotImplementedError("joint rows are not ported")
    if config.solver_cm:
        raise NotImplementedError("the component-major solver loop "
                                  "(solver_cm) is not ported")
    if config.solver_matmul_dtype != "float32":
        raise NotImplementedError(
            f"solver_matmul_dtype={config.solver_matmul_dtype!r}: the port "
            f"runs the selector products in float32")
    if state.pos.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the "
                           "selector products must run in full float32")
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

    s_mm = s_mat
    s_mm_t = s_mm.transpose(1, 2)

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
             torch.zeros_like(ax_h[..., 0:2])], dim=-1)

    k_op_n = _axis_contrib_op(n_ax)
    if config.friction:
        k_op_1 = _axis_contrib_op(t1_ax)
        k_op_2 = _axis_contrib_op(t2_ax)

    def _axis_j_op(axis_rows, rxa, rxb):
        """(B, C, 3) axis + arm crosses → (B, 2C, 8) J-row weight planes."""
        z2 = torch.zeros_like(axis_rows[..., 0:2])
        w_a = torch.cat([-axis_rows, -rxa, z2], dim=-1)
        w_b = torch.cat([axis_rows, rxb, z2], dim=-1)
        return torch.cat([w_a, w_b], dim=1)

    j_op_n = _axis_j_op(n_ax, rxa_n, rxb_n)
    if config.friction:
        j_op_1 = _axis_j_op(t1_ax, rxa_1, rxb_1)
        j_op_2 = _axis_j_op(t2_ax, rxa_2, rxb_2)

    def scatter_dl(dl_n, dl_1=None, dl_2=None):
        """Per-axis impulse magnitudes (B, C, 1) → (B, N, 8) Δvel."""
        def dup(x):
            return torch.cat([x, x], dim=1)                     # (B, 2C, 1)
        contrib = k_op_n * dup(dl_n)
        if dl_1 is not None:
            contrib = contrib + k_op_1 * dup(dl_1) + k_op_2 * dup(dl_2)
        return torch.bmm(s_mm_t, contrib)                       # (B, N, 8)

    def rel(j_op, vh):
        """Per-row relative velocity, halves folded: (B, C, 1)."""
        r2 = torch.sum(j_op * vh, -1, keepdim=True)             # (B, 2C, 1)
        return r2[:, :c] + r2[:, c:]

    beta = float(config.jacobi_beta)
    momentum = beta != 0.0

    zero = torch.zeros(contacts.valid.shape + (1,), dtype=f,
                       device=state.device)
    vel, lam_n, lam_t1, lam_t2 = vel0, zero, zero, zero
    pn = p1 = p2 = zero
    for _ in range(config.solver_iterations):
        if momentum:
            # heavy-ball: extrapolate with the previous accepted step before
            # projecting
            mom_n, mom_1, mom_2 = (beta * (lam_n - pn), beta * (lam_t1 - p1),
                                   beta * (lam_t2 - p2))
            pn, p1, p2 = lam_n, lam_t1, lam_t2
        else:
            mom_n = mom_1 = mom_2 = 0.0

        vh = torch.bmm(s_mm, vel)                               # (B, 2C, 8)

        dl_n = omega * (target - rel(j_op_n, vh)
                        - cfm_term * lam_n) / d_n + mom_n
        new_n = torch.clamp_min(lam_n + dl_n, 0.0)
        dl_n = torch.where(live, new_n - lam_n, 0.0)
        lam_n = lam_n + dl_n

        if config.friction:
            if config.per_body_surface:
                mu_c = extras["mu"][..., None]                  # (B, C, 1)
                bound = torch.where(torch.isinf(mu_c),
                                    torch.full_like(lam_n, torch.inf),
                                    mu_c * lam_n)
            elif mu_inf:
                bound = torch.full_like(lam_n, torch.inf)
            else:
                bound = config.mu * lam_n
            dl_1 = omega * (-rel(j_op_1, vh)
                            - cfm_term * lam_t1) / d_t1 + mom_1
            new_1 = torch.clamp(lam_t1 + dl_1, -bound, bound)
            dl_1 = torch.where(live, new_1 - lam_t1, 0.0)
            lam_t1 = lam_t1 + dl_1

            dl_2 = omega * (-rel(j_op_2, vh)
                            - cfm_term * lam_t2) / d_t2 + mom_2
            new_2 = torch.clamp(lam_t2 + dl_2, -bound, bound)
            dl_2 = torch.where(live, new_2 - lam_t2, 0.0)
            lam_t2 = lam_t2 + dl_2
            dv = scatter_dl(dl_n, dl_1, dl_2)
        else:
            dv = scatter_dl(dl_n)

        vel = vel + dv

    return state.replace(linvel=vel[..., 0:3].contiguous(),
                         angvel=vel[..., 3:6].contiguous())


def solve(state: WorldState, contacts: Contacts,
          config: EngineConfig, joints_rows=None) -> WorldState:
    """The contact solve of one substep. The port has JACOBI only."""
    if config.solver is not SolverKind.JACOBI:
        raise NotImplementedError(
            f"solver {config.solver.value!r} is not ported (JACOBI only)")
    return solve_jacobi(state, contacts, config, joints_rows=joints_rows)
