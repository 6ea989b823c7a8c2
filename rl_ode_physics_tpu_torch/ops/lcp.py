"""Direct LCP contact solver: the ``dWorldStep`` (Dantzig) conformance mode.

The port of ``rl_ode_physics_tpu/ops/lcp.py``: the exact solution of the
contact LCP in impulse space over the rows the iterative solvers use, one
normal and two friction rows a contact, R = 3C rows ordered
[normal | t1 | t2]:

    w = A λ + b,   A = J M⁻¹ Jᵀ + (cfm/dt)·I,   b = J v⁰ − target
    normal rows:    0 ≤ λ ⊥ w ≥ 0
    friction rows:  λ ∈ [−μ·λ_n, +μ·λ_n] (λ = lo ⟹ w ≥ 0, λ = hi ⟹ w ≤ 0,
                    interior ⟹ w = 0); μ = ∞ makes them bilateral rows

solved by Murty principal block pivoting extended to boxed rows: each
round is a masked dense solve of the active rows, clamped rows at their
bounds, then the active set and the bound sides flip where λ or w violate
them, until the set, the sides and the iterate are stable, for at most
``MAX_PIVOT_ROUNDS`` rounds. Block flips can cycle on a large pile; with
Júdice and Pires' safeguard a world whose count of moving rows has not
fallen below its least for ``STALL_ROUNDS`` rounds flips only its first
moving row (Murty's least-index rule, finite for the P-matrix that CFM
makes of the normal rows' Schur complement) until the count falls below
that least again. The safeguard holds only in a world whose bounds are
fixed, with no boxed row (every friction row bilateral, μ = ∞): a boxed
row's bounds ±μ·λ_n move with the iterate, the rule has no finiteness
there, and it cured some capped worlds and capped others that block
flips end, so such a world flips every moving row each round.

The JAX package runs the rounds in a ``lax.while_loop`` under ``vmap``: a
world that is done keeps its carry while the others go on. On the card the
port runs that loop as one hand kernel a solve
(``ops/lcp_kernel.lcp_pivot_solve``, ``csrc/lcp_pivot.cu``): each world to
its own fixed point, its active rows alone factored, nothing read back to
the host, so a CUDA graph holds a DANTZIG step. Its plain version,
``_pivot_solve`` here, which CPU tensors take, runs the rounds batched over
worlds, each world frozen (``torch.where`` on the whole carry) once it is
done or at the cap, and stops when every world is frozen: one host read of
"all frozen" a round. Its solves are ``torch.linalg.solve_ex`` with
``check_errors=False`` of each world's whole (3C × 3C) masked matrix. This
is the conformance path, not a throughput solver.
"""

from __future__ import annotations

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.core.state import WorldState, world_inv_inertia
from rl_ode_physics_tpu_torch.ops import lcp_kernel
from rl_ode_physics_tpu_torch.ops import solver as sol
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts
from rl_ode_physics_tpu_torch.utils import bounds, tracing

# Murty converges in at most #normal-rows flips for PD systems in exact
# arithmetic; finite-μ boxed rows add a geometric fixed-point tail
MAX_PIVOT_ROUNDS = 128
_TOL = 1e-10
# block rounds in a row that may leave a world's least count of moving rows
# where it was before the world takes single pivots (Júdice and Pires'
# safeguard of block principal pivoting; only in a world with no boxed row)
STALL_ROUNDS = 3


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(B, C) slots → (B, C, N) one-hot by comparison: an index outside
    0..N-1 gives a zero row."""
    cols = torch.arange(n, device=idx.device)
    return (idx[..., None].to(torch.int64) == cols).to(dtype)


def _build_lcp(state: WorldState, contacts: Contacts, config: EngineConfig):
    """Dense J·M⁻¹ (B, R, N, 6), A (B, R, R), b (B, R), valid and
    is_normal (B, R), μ per contact (B, C), for R = 3C rows ordered
    [normal | t1 | t2]."""
    f = state.linvel.dtype
    bsz, n = state.num_worlds, state.num_slots
    c = contacts.a.shape[1]
    r = 3 * c

    feats = sol._direct_body_features(state, contacts)
    rows = sol._row_data(state, contacts, config, feats)
    r_a, r_b = rows["r_a"], rows["r_b"]

    oh_a = _one_hot(contacts.a, n, f)                       # (B, C, N)
    oh_b = _one_hot(contacts.b, n, f)
    j_blocks = []
    for u in (rows["n"], rows["t1"], rows["t2"]):
        ja = torch.cat([u, sol._cross(r_a, u)], -1)         # (B, C, 6)
        jb = torch.cat([u, sol._cross(r_b, u)], -1)
        j_blocks.append(oh_b[..., None] * jb[:, :, None, :]
                        - oh_a[..., None] * ja[:, :, None, :])  # (B,C,N,6)
    j_full = torch.cat(j_blocks, 1)                         # (B, R, N, 6)

    inv_i = world_inv_inertia(state)                        # (B, N, 3, 3)
    jw_lin = j_full[..., 0:3] * state.inv_mass[:, None, :, None]
    jw_ang = torch.einsum("brnk,bnkl->brnl", j_full[..., 3:6], inv_i)
    jw = torch.cat([jw_lin, jw_ang], -1)                    # (B, R, N, 6)

    a_mat = torch.bmm(jw.reshape(bsz, r, n * 6),
                      j_full.reshape(bsz, r, n * 6).transpose(1, 2))
    a_mat = a_mat + (config.cfm / config.dt) * torch.eye(
        r, dtype=f, device=state.device)

    vel6 = torch.cat([state.linvel, state.angvel], -1)      # (B, N, 6)
    jv0 = torch.bmm(j_full.reshape(bsz, r, n * 6),
                    vel6.reshape(bsz, n * 6, 1))[..., 0]
    target = torch.cat([rows["target"],
                        torch.zeros((bsz, 2 * c), dtype=f,
                                    device=state.device)], 1)
    b = jv0 - target

    valid = contacts.valid.repeat(1, 3)
    is_normal = torch.zeros((bsz, r), dtype=torch.bool, device=state.device)
    is_normal[:, :c] = True
    # per-contact friction coefficient: pair-mixed per body, or the
    # surface's μ (the reference's dInfinity by default)
    mu_row = rows["mu"]
    if mu_row is None:
        mu_row = torch.full((bsz, c), config.mu, dtype=f,
                            device=state.device)
    return jw, a_mat, b, valid, is_normal, mu_row


def _pivot_solve(a_mat, b, valid, is_normal, friction: bool, mu_row=None):
    """Murty principal block pivoting with boxed friction rows, every world
    of the batch at once: λ (B, R) for rows [normal | t1 | t2], and each
    world's pivot rounds (B,) int32, those it takes alone (the batch runs
    its slowest world's; the host reads made are one more, up to the cap).
    The plain version of ``ops/lcp_kernel.lcp_pivot_solve``.

    ``mu_row``: (B, C) friction coefficient per contact (``inf`` = a
    bilateral row), or None (all ``inf``). Friction bounds ±μ·λ_n follow
    the iterate every round (ODE's findex)."""
    bsz, r = b.shape
    c = r // 3
    f = b.dtype
    eye = torch.eye(r, dtype=f, device=b.device).expand(bsz, r, r)

    toggled = valid & is_normal                  # unilateral normal rows
    fric = valid & ~is_normal if friction else torch.zeros_like(valid)
    if mu_row is None:
        mu3 = torch.full((bsz, r), torch.inf, dtype=f, device=b.device)
    else:
        mu3 = mu_row.to(f).repeat(1, 3)          # row i ↔ normal row i mod C
    bilateral = fric & torch.isinf(mu3)          # never clamped: always active
    boxed = fric & ~torch.isinf(mu3)

    def bounds(lam):
        """hi = μ·λ_n per friction row (lo = −hi); inf-safe."""
        lam_n3 = torch.clamp_min(lam[:, :c], 0.0).repeat(1, 3)
        return torch.where(torch.isinf(mu3), torch.inf, mu3 * lam_n3)

    def masked_solve(act, lam_clamp):
        """Active rows against A with the clamped rows at their values;
        identity rows return the clamp verbatim."""
        m = torch.where(act[:, :, None] & act[:, None, :], a_mat, eye)
        contrib = torch.bmm(a_mat, torch.where(act, 0.0, lam_clamp)[..., None])
        rhs = torch.where(act, -b - contrib[..., 0], lam_clamp)
        return torch.linalg.solve_ex(m, rhs[..., None],
                                     check_errors=False)[0][..., 0]

    def clamp_values(side, hi):
        v = torch.where(side < 0, -hi, torch.where(side > 0, hi, 0.0))
        return torch.where(boxed, v, 0.0)

    fp_tol = (1e3 * _TOL if f == torch.float64
              else 30 * torch.finfo(f).eps)
    act = bilateral | (toggled & (b < 0.0))      # warm guess: violating rows
    side = torch.zeros((bsz, r), dtype=torch.int32, device=b.device)
    lam = torch.zeros((bsz, r), dtype=f, device=b.device)
    done = torch.zeros((bsz,), dtype=torch.bool, device=b.device)
    rounds = torch.zeros((bsz,), dtype=torch.int32, device=b.device)
    # the safeguard: each world's least count of moving rows, and the
    # rounds since it last fell
    best = torch.full((bsz,), r + 1, dtype=torch.int32, device=b.device)
    stall = torch.zeros((bsz,), dtype=torch.int32, device=b.device)
    fixed = ~boxed.any(1)                        # the bounds never move
    cols = torch.arange(r, device=b.device)
    ran = 0
    while ran < MAX_PIVOT_ROUNDS and not bool(done.all()):
        running = ~done
        hi = bounds(lam)
        tiny = boxed & (hi < _TOL)        # bound collapsed (λ_n = 0)
        lam_new = masked_solve(act, clamp_values(side, hi))
        w = torch.bmm(a_mat, lam_new[..., None])[..., 0] + b

        # normal-row pivots (classic Murty)
        rm_n = act & toggled & (lam_new < -_TOL)
        add_n = ~act & toggled & (w < -_TOL)
        # boxed friction pivots: leave the box → clamp at the bound;
        # clamped with a violating w sign → release; clamped at 0 with a
        # live bound → enter
        go_lo = act & boxed & (lam_new < -hi - _TOL)
        go_hi = act & boxed & (lam_new > hi + _TOL)
        rel_lo = ~act & boxed & (side < 0) & (w < -_TOL) & ~tiny
        rel_hi = ~act & boxed & (side > 0) & (w > _TOL) & ~tiny
        rel_mid = ~act & boxed & (side == 0) & ~tiny

        new_act = ((act & ~rm_n & ~go_lo & ~go_hi & ~tiny)
                   | add_n | rel_lo | rel_hi | rel_mid | bilateral)
        new_side = torch.where(go_lo, -1, torch.where(go_hi, 1, side))
        new_side = torch.where(rel_lo | rel_hi | rel_mid, 0, new_side)
        new_side = torch.where(tiny, 1, new_side)    # sit at hi = 0
        new_side = torch.where(boxed, new_side, 0).to(torch.int32)

        moving = (new_act != act) | (new_side != side)
        count = moving.sum(1, dtype=torch.int32)
        moved = count > 0
        # block flips while the count keeps falling below its least, else
        # the first moving row alone (where the bounds are fixed)
        fell = count < best
        new_stall = torch.where(fell, 0, stall + 1)
        single = fixed & (new_stall >= STALL_ROUNDS)
        first = torch.argmax(moving.to(torch.int32), 1)
        flip = moving & (~single[:, None] | (cols == first[:, None]))
        new_act = torch.where(flip, new_act, act)
        new_side = torch.where(flip, new_side, side)
        # the bounds move with λ_n even at a stable set: the iterate itself
        # must be a fixed point (tolerance by dtype)
        lam_chg = torch.abs(lam_new - lam).amax(1)
        scale = 1.0 + torch.abs(lam_new).amax(1)
        new_done = ~moved & (lam_chg <= fp_tol * scale)

        keep = running[:, None]
        act = torch.where(keep, new_act, act)
        side = torch.where(keep, new_side, side)
        lam = torch.where(keep, lam_new, lam)
        best = torch.where(running, torch.minimum(best, count), best)
        stall = torch.where(running, new_stall, stall)
        done = torch.where(running, new_done, done)
        rounds += running.to(torch.int32)
        ran += 1
    # final consistent solve + projection on the converged set and bounds
    hi = bounds(lam)
    lam = masked_solve(act, clamp_values(side, hi))
    lam = torch.where(valid, lam, 0.0)
    lam = torch.where(toggled, torch.clamp_min(lam, 0.0), lam)
    lam = torch.where(boxed, torch.clamp(lam, -hi, hi), lam)
    return lam, rounds


def solve_dantzig(state: WorldState, contacts: Contacts,
                  config: EngineConfig) -> WorldState:
    """Exact contact solve (dWorldStep semantics) of every world: μ = ∞
    (bilateral friction rows), a finite global μ or per-body surfaces
    (boxed rows with ODE's findex coupling). The pivot loop is
    ``lcp_kernel.lcp_pivot_solve``: one launch of the hand kernel on the
    card, which reads nothing back to the host; the plain loop on the
    CPU. A world whose solve reaches ``MAX_PIVOT_ROUNDS`` holds an inexact
    λ: it adds 1 to that world's ``overflow``, as a dropped row does.
    While tracing is on the solve counts its rows and rounds
    (``_pivot_counters``)."""
    sol._check_solver(state)
    jw, a_mat, b, valid, is_normal, mu_row = _build_lcp(
        state, contacts, config)
    if not config.friction:
        # only the first C rows take part
        valid = valid & is_normal
    tracing.stamp("solve.rows")
    lam, rounds = lcp_kernel.lcp_pivot_solve(a_mat, b, valid, is_normal,
                                             config.friction, mu_row)
    capped = rounds >= MAX_PIVOT_ROUNDS
    _pivot_counters(lam, rounds, capped, valid, is_normal,
                    config.friction, mu_row)
    bsz, n = state.num_worlds, state.num_slots
    dv6 = torch.bmm(lam[:, None, :],
                    jw.reshape(bsz, lam.shape[1], n * 6)).reshape(bsz, n, 6)
    return state.replace(linvel=state.linvel + dv6[..., 0:3],
                         angvel=state.angvel + dv6[..., 3:6],
                         overflow=state.overflow + capped.to(torch.int32))


def _pivot_counters(lam, rounds, capped, valid, is_normal, friction: bool,
                    mu_row) -> None:
    """A solve's device counters (``utils/tracing``), summed over its
    worlds: the valid rows V, V² and V³ (a roofline's bytes and
    operations), the active rows of the last solve read from λ
    (``utils/bounds.lcp_active_rows``), the pivot rounds and the solves
    stopped at the cap. Made only while tracing is on."""
    def nvalid():
        return valid.sum(1, dtype=torch.int32)

    def cube():
        if lam.shape[1] ** 3 >= 2 ** 31:
            raise ValueError(f"R = {lam.shape[1]} rows: V³ of a world "
                             f"overflows its int32 count")
        return nvalid() ** 3

    tracing.count("lcp_valid_rows", nvalid)
    tracing.count("lcp_valid_rows_sq", lambda: nvalid() ** 2)
    tracing.count("lcp_valid_rows_cube", cube)
    tracing.count("lcp_active_rows", lambda: bounds.lcp_active_rows(
        lam, valid, is_normal, friction, mu_row).to(torch.int32))
    tracing.count("pivot_rounds", rounds)
    tracing.count("pivot_capped", capped)


def lcp_residuals(state: WorldState, contacts: Contacts,
                  config: EngineConfig, solved: WorldState):
    """The physical (unregularized) constraint residuals of a solved
    velocity state, per world: max |tangential velocity| on friction rows
    and max normal-target violation, each (B,). Diagnostic only: with CFM
    softening every correct solver leaves a (cfm/h)·λ residual."""
    feats = sol._direct_body_features(state, contacts)
    rows = sol._row_data(state, contacts, config, feats)
    vel = torch.cat([solved.linvel, solved.angvel], -1)
    va, vb = sol._take(vel, contacts.a), sol._take(vel, contacts.b)

    def rel(axis):
        pa = va[..., 0:3] + sol._cross(va[..., 3:6], rows["r_a"])
        pb = vb[..., 0:3] + sol._cross(vb[..., 3:6], rows["r_b"])
        return torch.sum((pb - pa) * axis, -1)

    valid = contacts.valid
    w_n = rel(rows["n"]) - rows["target"]
    w_t = torch.maximum(torch.abs(rel(rows["t1"])), torch.abs(rel(rows["t2"])))
    neg_w = torch.where(valid, torch.clamp_min(-w_n, 0.0), 0.0)
    fric = torch.where(valid, w_t, 0.0)
    return fric.amax(1), neg_w.amax(1)
