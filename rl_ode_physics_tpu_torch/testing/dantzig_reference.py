"""Plain float64 reference of ODE's ``dWorldStep`` contact solve.

The reference server steps its world with ``dWorldStep`` (ODE's big-matrix
stepper, ``ode/src/step.cpp``), whose contact LCP ODE solves with
Dantzig's principal pivoting (``dSolveLCP``, ``ode/src/lcp.cpp``). This file
solves the same LCP in plain PyTorch, float64, with that pivot rule, so
that the port's DANTZIG solver (Murty block pivoting in ``ops/lcp.py`` and
the hand kernel ``csrc/lcp_pivot.cu``) is held to an independent solve. It
imports nothing of ``ops/``; the collision and the row data come from the
NumPy referee (``testing/referee.py``).

The LCP, in impulse units, one normal and two friction rows a contact:

    w = A λ + b,   A = J M⁻¹ Jᵀ + (cfm/dt)·I,   b = J v − target
    normal rows:    0 ≤ λ ⊥ w ≥ 0
    friction rows:  free (μ = dInfinity, the reference's NearCallback):
                    w = 0

``solve_lcp`` follows ``dSolveLCP``: the free rows are solved first (ODE's
"nub"), then the other rows are added one at a time in their order. A row
whose w ≥ 0 at λ = 0 joins the set N at its bound; otherwise its λ is
driven up while every clamped row (set C) keeps w = 0, until its own w
reaches 0 (it joins C), a clamped normal row's λ reaches 0 (that row
moves to N) or a row of N reaches w = 0 (it moves to C). A is positive
definite (CFM), so the solution is unique and every drive ends.

Departures from ODE, none of which changes the solution:

* The whole world is one LCP. ``dWorldStep`` forms one LCP an island of
  bodies joined by contacts; A is block diagonal over islands (a static or
  kinematic body has M⁻¹ = 0 and joins none), so λ is the same.
* Rows are ordered [normal | t1 | t2] over the contacts, as the port
  orders them; ODE orders them contact by contact and moves the free rows
  to the front. The free rows go first here too.
* Impulses, not forces: ODE solves for f with the right side c/h −
  J(v/h + M⁻¹f_ext) and CFM as cfm/h on A's diagonal; λ = h·f solves the
  system above with v the velocity after the external forces.
* The clamped block is factored anew (Cholesky) at each drive step, where
  ODE updates its LDLᵀ factors a row at a time: other roundoff, the same
  solution.
* The step ratios are compared with a relative tolerance (``_RTOL``)
  where ODE compares with zero, so that a roundoff of a row already at its
  bound does not reverse the drive.
* The contacts, the tangent basis and the targets are the port's
  documented conventions, as the referee computes them, not ODE's
  ``dCollide``.

``check_kkt`` computes the solve's own KKT residuals and raises above
``KKT_TOL``: every returned λ has passed it.
"""

from __future__ import annotations

import numpy as np
import torch

from rl_ode_physics_tpu_torch.testing import referee as R

# relative tolerance of a drive's step ratios
_RTOL = 1e-12
# the largest KKT residual a solve may leave, relative to the system's
# scale (``kkt_residual``); roundoff of a well-solved system is ~1e-15
KKT_TOL = 1e-9
# drive steps a row may take before the solve is declared stuck
_MAX_DRIVE = 10_000


def _solve(a, idx, rhs):
    """A[idx, idx]⁻¹ rhs by Cholesky (A is positive definite)."""
    if len(idx) == 0:
        return rhs.new_zeros((0,))
    sub = a[idx][:, idx]
    fac = torch.linalg.cholesky(sub)
    return torch.cholesky_solve(rhs[:, None], fac)[:, 0]


def solve_lcp(a: torch.Tensor, b: torch.Tensor,
              free: torch.Tensor) -> torch.Tensor:
    """λ (R,) of w = A λ + b with 0 ≤ λ ⊥ w ≥ 0 on the rows where ``free``
    is false and w = 0 where it is true, by ``dSolveLCP``'s pivoting. A
    (R, R) float64, symmetric positive definite; b (R,); ``free`` (R,)
    bool. Checked by ``check_kkt`` before it is returned."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    n = b.shape[0]
    free_list = [int(i) for i in torch.nonzero(free).flatten()]
    lam = torch.zeros(n, dtype=torch.float64)
    clamped = list(free_list)            # set C: w = 0
    at_bound = []                        # set N: λ = 0, w ≥ 0
    if clamped:
        lam[clamped] = _solve(a, clamped, -b[clamped])
    for i in (int(k) for k in torch.nonzero(~free).flatten()):
        w = a @ lam + b
        if w[i] >= 0.0:
            at_bound.append(i)
            continue
        for _ in range(_MAX_DRIVE):
            # the direction: λ_i up by 1, the clamped rows keep w = 0
            d = torch.zeros(n, dtype=torch.float64)
            d[i] = 1.0
            cl = torch.tensor(clamped, dtype=torch.int64)
            nb = torch.tensor(at_bound, dtype=torch.int64)
            if clamped:
                d[cl] = -_solve(a, clamped, a[cl, i])
            dw = a @ d
            w = a @ lam + b
            step, leave, kind = float(-w[i] / dw[i]), i, "self"
            # a clamped normal row whose λ falls to 0
            falls = ~free[cl] & (d[cl] < -_RTOL * float(torch.abs(d).max()))
            if bool(falls.any()):
                s = torch.where(falls, torch.clamp_min(-lam[cl] / d[cl], 0.0),
                                torch.inf)
                k = int(torch.argmin(s))
                if float(s[k]) < step:
                    step, leave, kind = float(s[k]), clamped[k], "clamped"
            # a row at its bound whose w falls to 0
            rises = dw[nb] < -_RTOL * float(torch.abs(dw).max())
            if bool(rises.any()):
                s = torch.where(rises, torch.clamp_min(-w[nb] / dw[nb], 0.0),
                                torch.inf)
                k = int(torch.argmin(s))
                if float(s[k]) < step:
                    step, leave, kind = float(s[k]), at_bound[k], "bound"
            lam = lam + step * d
            if kind == "self":
                clamped.append(i)
                break
            if kind == "clamped":
                clamped.remove(leave)
                lam[leave] = 0.0
                at_bound.append(leave)
            else:
                at_bound.remove(leave)
                clamped.append(leave)
        else:
            raise RuntimeError(f"row {i}: the drive did not end in "
                               f"{_MAX_DRIVE} steps")
    # the last clamped set's own solve: λ_C exact to roundoff, λ_N = 0
    lam = torch.zeros(n, dtype=torch.float64)
    if clamped:
        lam[clamped] = _solve(a, clamped, -b[clamped])
    check_kkt(a, b, lam, free)
    return lam


def kkt_residual(a: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                 free: torch.Tensor) -> float:
    """The largest KKT violation of λ, relative to the system's scale:
    |w| on free rows; λ < 0, w < 0 and min(λ, w) (complementarity) on the
    others; w over max(|b|, |A| |λ|), λ over max |λ|."""
    if b.numel() == 0:
        return 0.0
    w = a @ lam + b
    l_scale = max(float(torch.abs(lam).max()), 1e-300)
    w_scale = max(float(torch.abs(b).max()),
                  float(torch.abs(a).sum(1).max()) * l_scale, 1e-300)
    wn, ln = w / w_scale, lam / l_scale
    parts = [torch.abs(wn[free]),
             torch.clamp_min(-ln[~free], 0.0),
             torch.clamp_min(-wn[~free], 0.0),
             torch.minimum(torch.abs(ln[~free]), torch.abs(wn[~free]))]
    return max([float(p.max()) for p in parts if p.numel()] + [0.0])


def check_kkt(a, b, lam, free, tol: float = KKT_TOL) -> None:
    """Raise where λ leaves a KKT residual above ``tol``."""
    res = kkt_residual(a, b, lam, free)
    if not res <= tol:
        raise ArithmeticError(f"KKT residual {res:.3e} above {tol:.0e}")


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _external_forces(w: dict, dt: float, gravity) -> list:
    """Gravity on the dynamic bodies and the gyroscopic term, in place, as
    the referee applies them; each body's world inverse inertia."""
    n = len(w["body_type"])
    g = np.asarray(gravity, np.float64)
    inv_i_world = [R.world_inv_inertia(w["quat"][i], w["inv_inertia"][i])
                   for i in range(n)]
    for i in range(n):
        if (w["body_type"][i] != R.NULL and not w["is_static"][i]
                and not w["is_kinematic"][i]):
            w["linvel"][i] = w["linvel"][i] + dt * g
        inv_diag = w["inv_inertia"][i]
        i_body = np.where(inv_diag > 0, 1.0 / np.maximum(inv_diag, 1e-30),
                          0.0)
        r = R.quat_to_matrix(w["quat"][i])
        i_world = r @ np.diag(i_body) @ r.T
        gyro = np.cross(w["angvel"][i], i_world @ w["angvel"][i])
        w["angvel"][i] = w["angvel"][i] + dt * (inv_i_world[i] @ (-gyro))
    return inv_i_world


def contact_lcp(w: dict, rows: list, inv_i_world: list, cfg):
    """(A, b, free, J M⁻¹) of a world's contact rows (the referee's
    ``_contacts``): A (R, R), b (R,), ``free`` (R,) bool, J M⁻¹ (R, N, 6),
    float64 tensors, R = 3C rows ordered [normal | t1 | t2]."""
    c, n = len(rows), len(w["body_type"])
    r_rows = 3 * c
    jac = np.zeros((r_rows, n, 6))
    target = np.zeros(r_rows)
    for k, (a, bb, p, nrm, depth) in enumerate(rows):
        r_a, r_b = p - w["pos"][a], p - w["pos"][bb]
        t1, t2 = R.tangent_basis(nrm)
        for blk, u in enumerate((nrm, t1, t2)):
            row = blk * c + k
            jac[row, a, 0:3] -= u
            jac[row, a, 3:6] -= np.cross(r_a, u)
            jac[row, bb, 0:3] += u
            jac[row, bb, 3:6] += np.cross(r_b, u)
        va0 = w["linvel"][a] + np.cross(w["angvel"][a], r_a)
        vb0 = w["linvel"][bb] + np.cross(w["angvel"][bb], r_b)
        v_n0 = float((vb0 - va0) @ nrm)
        bias = min(cfg.erp * depth / cfg.dt, cfg.max_correcting_vel)
        bounce = -cfg.bounce * v_n0 if -v_n0 > cfg.bounce_vel else 0.0
        target[k] = max(bias, bounce)
    j = torch.as_tensor(jac)
    inv_m = torch.as_tensor(np.asarray(w["inv_mass"], np.float64))
    inv_i = torch.as_tensor(np.stack(inv_i_world).astype(np.float64))
    jw = torch.cat([j[..., 0:3] * inv_m[None, :, None],
                    torch.einsum("rnk,nlk->rnl", j[..., 3:6], inv_i)], -1)
    a_mat = (jw.reshape(r_rows, 6 * n) @ j.reshape(r_rows, 6 * n).T
             + (cfg.cfm / cfg.dt) * torch.eye(r_rows, dtype=torch.float64))
    vel6 = torch.as_tensor(np.concatenate([w["linvel"], w["angvel"]], -1))
    b = j.reshape(r_rows, 6 * n) @ vel6.reshape(-1) - torch.as_tensor(target)
    free = torch.arange(r_rows) >= c
    if not cfg.friction:
        keep = ~free
        return a_mat[keep][:, keep], b[keep], free[keep], jw[keep]
    return a_mat, b, free, jw


def step(w: dict, cfg) -> dict:
    """One substep of world ``w`` (``referee.state_to_numpy``'s dict):
    collide, external forces, the direct solve, integrate, in the port's
    pipeline order, with ``cfg`` a ``referee.RefereeConfig`` whose μ is
    infinite."""
    if cfg.friction and not np.isinf(cfg.mu):
        raise NotImplementedError("the reference poses the μ = dInfinity "
                                  "surface: friction rows are free")
    w = {k: np.copy(v) for k, v in w.items()}
    rows = R._contacts(w, cfg)
    inv_i_world = _external_forces(w, cfg.dt, cfg.gravity)
    if rows:
        a_mat, b, free, jw = contact_lcp(w, rows, inv_i_world, cfg)
        lam = solve_lcp(a_mat, b, free)
        dv6 = torch.einsum("r,rnk->nk", lam, jw).numpy()
        w["linvel"] = w["linvel"] + dv6[:, 0:3]
        w["angvel"] = w["angvel"] + dv6[:, 3:6]
    for i in range(len(w["body_type"])):
        if w["body_type"][i] == R.NULL or w["is_static"][i]:
            continue
        w["pos"][i] = w["pos"][i] + cfg.dt * w["linvel"][i]
        omega_q = np.array([0.0, *w["angvel"][i]])
        q = w["quat"][i] + cfg.dt * 0.5 * R.quat_mul(omega_q, w["quat"][i])
        w["quat"][i] = q / max(np.linalg.norm(q), 1e-12)
    return w
