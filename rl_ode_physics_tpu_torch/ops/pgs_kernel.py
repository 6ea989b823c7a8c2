"""Sequential PGS on the card: the hand-written Hopper kernel.

``csrc/pgs_solve.cu`` runs every sweep of one projected Gauss-Seidel
solve, the joint rows' sequential passes included, for every world, in
one launch. It replaces no Pallas kernel: it is the port's form of the
JAX package's ``lax.scan`` over rows inside a ``lax.fori_loop`` over
sweeps (``rl_ode_physics_tpu/ops/solver.py:285,324``) and of
``joint_iteration_seq`` (``rl_ode_physics_tpu/ops/joints.py:525``). It is
built with ``nvcc`` for ``sm_90a`` (``-fmad=false``, so that it rounds as
PyTorch does) into a shared library with a plain C interface at first use
and loaded with ``ctypes`` (``ops/kernel_build.py``).

``pgs_solve`` launches the kernel for CUDA tensors, float32 or float64.
For CPU tensors, and only for those, it runs the kernel's plain version,
``ops/solver.py:pgs_sweeps_plain``, the Python row loop. ``pgs_solve.launches``
counts the kernel's launches. The wrapper packs the rows into one buffer
with the worlds innermost (``pack_rows``, ``pack_joint_rows``: the layout
the source note gives), and reads nothing back to the host, so a CUDA graph
can hold the launch.

``pgs_kernel_order`` is the kernel's loop transcribed to PyTorch over the
same packed buffers, batched over worlds as a warp runs them (a world's
skipped row is a masked lane); the CPU tests hold it to the plain version,
so that the kernel's arithmetic and packing are tested where there is no
card. It lies on no path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build

_LAUNCHERS = {torch.float32: "pgs_solve_launch",
              torch.float64: "pgs_solve_launch_f64"}
FLAGS = ("-fmad=false",)

# the velocities of a block's worlds share 48 KB of shared memory
SHARED_BYTES = 48 * 1024
ROW_FIELDS = 40
JOINT_FIELDS = 21

# friction_mode: no friction rows, μ = ∞, a global μ, a μ per row
NO_FRICTION, MU_INF, MU_GLOBAL, MU_PER_ROW = 0, 1, 2, 3

# the row table's (B, C, ...) entries that the kernel reads
ROW_KEYS = ("a", "b", "valid", "r_a", "r_b", "n", "t1", "t2", "d_n", "d_t1",
            "d_t2", "target", "mu", "inv_m_a", "inv_m_b", "inv_i_a",
            "inv_i_b")
JOINT_KEYS = ("a", "b", "live", "n", "wa", "wb", "inv_m_a", "inv_m_b",
              "ang_resp_a", "ang_resp_b", "d_seq", "rhs", "lob", "hib")
_ROW_SHAPES = dict(a=(), b=(), valid=(), r_a=(3,), r_b=(3,), n=(3,),
                   t1=(3,), t2=(3,), d_n=(), d_t1=(), d_t2=(), target=(),
                   mu=(), inv_m_a=(), inv_m_b=(), inv_i_a=(3, 3),
                   inv_i_b=(3, 3))
_JOINT_SHAPES = dict(a=(), b=(), live=(), n=(3,), wa=(3,), wb=(3,),
                     inv_m_a=(), inv_m_b=(), ang_resp_a=(3,),
                     ang_resp_b=(3,), d_seq=(), rhs=(), lob=(), hib=())


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("pgs_solve.cu", FLAGS)


# the library's C interface: launcher → argtypes
FUNCTIONS = {
    name: ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
           + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_void_p])
    for name in _LAUNCHERS.values()}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def friction_mode(friction: bool, mu: float, per_body_surface: bool) -> int:
    """The kernel's friction case, as the plain loop picks its bound."""
    if not friction:
        return NO_FRICTION
    if per_body_surface:
        return MU_PER_ROW
    return MU_INF if math.isinf(mu) else MU_GLOBAL


def max_slots(dtype: torch.dtype) -> int:
    """The most slots a world may have: its (N, 6) velocities fit the
    block's shared memory."""
    return SHARED_BYTES // (6 * torch.empty((), dtype=dtype).element_size())


def pack_rows(rows, dtype):
    """The contact row table (B, C, ...) → (rec (C, 40, B), idx (C, 3, B)
    int32): fields r_a r_b n t1 t2 | d_n d_t1 d_t2 target μ inv_m_a
    inv_m_b | inv_i_a inv_i_b (row-major), and a, b, live."""
    bsz, c = rows["a"].shape
    mu = rows.get("mu")
    if mu is None:
        mu = torch.zeros_like(rows["target"])
    scalars = torch.stack([rows["d_n"], rows["d_t1"], rows["d_t2"],
                           rows["target"], mu, rows["inv_m_a"],
                           rows["inv_m_b"]], -1)
    rec = torch.cat([rows["r_a"], rows["r_b"], rows["n"], rows["t1"],
                     rows["t2"], scalars,
                     rows["inv_i_a"].reshape(bsz, c, 9),
                     rows["inv_i_b"].reshape(bsz, c, 9)], -1).to(dtype)
    idx = torch.stack([rows["a"].to(torch.int32), rows["b"].to(torch.int32),
                       rows["valid"].to(torch.int32)], -1)
    return (rec.permute(1, 2, 0).contiguous(),
            idx.permute(1, 2, 0).contiguous())


def pack_joint_rows(rows, dtype):
    """The joint row table (``ops/joints.joint_rows``) → (jrec (R, 21, B),
    jidx (R, 3, B) int32): n wa wb | inv_m_a inv_m_b | ang_resp_a
    ang_resp_b | d_seq rhs lob hib, and a, b, live."""
    jrec = torch.cat([rows["n"], rows["wa"], rows["wb"],
                      torch.stack([rows["inv_m_a"], rows["inv_m_b"]], -1),
                      rows["ang_resp_a"], rows["ang_resp_b"],
                      torch.stack([rows["d_seq"], rows["rhs"], rows["lob"],
                                   rows["hib"]], -1)], -1).to(dtype)
    jidx = torch.stack([rows["a"].to(torch.int32), rows["b"].to(torch.int32),
                        rows["live"].to(torch.int32)], -1)
    return (jrec.permute(1, 2, 0).contiguous(),
            jidx.permute(1, 2, 0).contiguous())


def _tensors(vel, lam, rows, joints_rows):
    out = [vel] + ([] if lam is None else [lam])
    for table, keys in ((rows, ROW_KEYS), (joints_rows, JOINT_KEYS)):
        if table is not None:
            out += [table[k] for k in keys if table.get(k) is not None]
    return out


def _check(vel, lam, rows, joints_rows, mode, in_shared=True):
    """Raise on what the kernel does not take; ``in_shared``: also on a
    world too large for the block's shared memory (the plain version has
    no such limit)."""
    if vel.dtype not in _LAUNCHERS:
        raise TypeError(f"velocities of dtype {vel.dtype}: float32 or "
                        f"float64")
    if vel.dim() != 3 or vel.shape[2] != 6:
        raise ValueError(f"velocities of shape {tuple(vel.shape)}: expected "
                         f"(B, N, 6)")
    bsz, n = vel.shape[:2]
    if bsz == 0 or n == 0:
        raise ValueError("no worlds or no slots to solve")
    if in_shared and n > max_slots(vel.dtype):
        raise ValueError(f"{n} slots: the kernel keeps a world's (N, 6) "
                         f"velocities in shared memory, at most "
                         f"{max_slots(vel.dtype)} slots in {vel.dtype}")
    if (rows is None) != (lam is None):
        raise ValueError("contact rows and their impulses go together")
    if rows is None and joints_rows is None:
        raise ValueError("neither contact rows nor joint rows to solve")
    for table, shapes, what in ((rows, _ROW_SHAPES, "contact row"),
                                (joints_rows, _JOINT_SHAPES, "joint row")):
        if table is None:
            continue
        width = table["a"].shape[1] if table["a"].dim() == 2 else -1
        for key, tail in shapes.items():
            x = table.get(key)
            if x is None:
                if key == "mu" and mode != MU_PER_ROW:
                    continue
                raise ValueError(f"{what} table lacks {key!r}")
            if tuple(x.shape) != (bsz, width) + tail:
                raise ValueError(f"{what} {key!r} of shape "
                                 f"{tuple(x.shape)}: expected "
                                 f"{(bsz, width) + tail}")
            if x.is_floating_point() and x.dtype != vel.dtype:
                raise TypeError(f"{what} {key!r} of dtype {x.dtype}, "
                                f"velocities {vel.dtype}")
    if lam is not None:
        c = rows["a"].shape[1]
        if tuple(lam.shape) != (bsz, c, 3) or lam.dtype != vel.dtype:
            raise ValueError(f"impulses {tuple(lam.shape)} {lam.dtype}: "
                             f"expected {(bsz, c, 3)} {vel.dtype}")


def pack(vel, lam, rows, joints_rows):
    """The buffers of a launch: rec, idx, jrec, jidx, the velocities, λ as
    (3, C, B) and the joints' λ as (R, B), each a tensor of its own that
    the kernel updates in place."""
    f, dev = vel.dtype, vel.device
    bsz = vel.shape[0]
    if rows is None:
        rec = torch.empty((0, ROW_FIELDS, bsz), dtype=f, device=dev)
        idx = torch.empty((0, 3, bsz), dtype=torch.int32, device=dev)
        lam_k = torch.empty((3, 0, bsz), dtype=f, device=dev)
    else:
        rec, idx = pack_rows(rows, f)
        lam_k = lam.permute(2, 1, 0).contiguous()
    if joints_rows is None:
        jrec = torch.empty((0, JOINT_FIELDS, bsz), dtype=f, device=dev)
        jidx = torch.empty((0, 3, bsz), dtype=torch.int32, device=dev)
    else:
        jrec, jidx = pack_joint_rows(joints_rows, f)
    jlam = torch.zeros((jidx.shape[0], bsz), dtype=f, device=dev)
    vel_k = vel.contiguous().clone()
    return rec, idx, jrec, jidx, vel_k, lam_k, jlam


def launch(packed, *, iterations: int, omega: float, cfm_term: float,
           mode: int, mu: float) -> None:
    """One launch of the kernel on ``pack``'s buffers, on the current
    stream of their card: the velocities and impulses are updated in
    place. Counted in ``pgs_solve.launches``."""
    rec, idx, jrec, jidx, vel_k, lam_k, jlam = packed
    bsz, n = vel_k.shape[:2]
    run = getattr(_library(), _LAUNCHERS[vel_k.dtype])
    with torch.cuda.device(vel_k.device):
        stream = torch.cuda.current_stream(vel_k.device).cuda_stream
        err = run(rec.data_ptr(), idx.data_ptr(), idx.shape[0],
                  jrec.data_ptr(), jidx.data_ptr(), jidx.shape[0],
                  vel_k.data_ptr(), lam_k.data_ptr(), jlam.data_ptr(), bsz,
                  n, int(iterations), float(omega), float(cfm_term), mode,
                  float(mu), stream)
    if err != 0:
        raise RuntimeError(f"pgs_solve kernel launch failed: CUDA error "
                           f"{err}")
    pgs_solve.launches += 1


def pgs_solve(vel: torch.Tensor, lam, rows, joints_rows=None, *,
              iterations: int, omega: float, cfm_term: float,
              friction: bool = True, mu: float = math.inf,
              per_body_surface: bool = False):
    """``iterations`` sweeps of sequential PGS: vel (B, N, 6) float32 or
    float64, lam (B, C, 3) the starting impulses, ``rows`` the contact row
    table (``ROW_KEYS``, (B, C, ...); ``mu`` only with
    ``per_body_surface``), ``joints_rows`` ``ops/joints.joint_rows`` or
    None: a sequential joint pass after each contact sweep. ``rows`` and
    ``lam`` None: the joint passes alone (DANTZIG's, at ω = 1). Returns
    (vel', lam'), new tensors; lam' is None with no contact rows. The
    contract of ``ops/solver.py:pgs_sweeps_plain``."""
    mode = friction_mode(friction, mu, per_body_surface)
    devices = {t.device for t in _tensors(vel, lam, rows, joints_rows)}
    if len(devices) != 1:
        raise ValueError(f"tensors on {sorted(map(str, devices))}: the "
                         f"kernel takes them on one card, the plain version "
                         f"on the CPU")
    _check(vel, lam, rows, joints_rows, mode, in_shared=vel.is_cuda)
    if vel.device.type == "cpu":
        from rl_ode_physics_tpu_torch.ops import solver
        return solver.pgs_sweeps_plain(
            vel, lam, rows, joints_rows, iterations=iterations, omega=omega,
            cfm_term=cfm_term, friction=friction, mu=mu,
            per_body_surface=per_body_surface)
    if not vel.is_cuda:
        raise ValueError(f"tensors on {vel.device}: the kernel takes them "
                         f"on a card, the plain version on the CPU")
    packed = pack(vel, lam, rows, joints_rows)
    launch(packed, iterations=iterations, omega=omega, cfm_term=cfm_term,
           mode=mode, mu=mu)
    vel_k, lam_k = packed[4], packed[5]
    lam_out = None if rows is None else lam_k.permute(2, 1, 0).contiguous()
    return vel_k, lam_out


pgs_solve.launches = 0


def pgs_kernel_order(vel, lam, rows, joints_rows=None, *, iterations: int,
                     omega: float, cfm_term: float, friction: bool = True,
                     mu: float = math.inf, per_body_surface: bool = False):
    """``csrc/pgs_solve.cu``'s loop in PyTorch, on the kernel's own packed
    buffers: the contract of ``pgs_solve``, computed operation by operation
    in the kernel's order, batched over worlds as a warp's lanes (a world
    whose row is dead or past its last live row keeps its values, as a
    lane that skips it). Any device; it lies on no path."""
    mode = friction_mode(friction, mu, per_body_surface)
    _check(vel, lam, rows, joints_rows, mode)
    rec, idx, jrec, jidx, vel_k, lam_k, jlam = pack(vel, lam, rows,
                                                    joints_rows)
    f = vel.dtype
    bsz = vel.shape[0]
    ar = torch.arange(bsz, device=vel.device)
    # shared memory: [slot][component][world]
    sv = vel_k.permute(1, 2, 0).contiguous()

    def last_live(live):
        """(rows, B) live flags → one past each world's last live row."""
        k = torch.arange(live.shape[0] + 1, device=live.device)[:, None]
        first = torch.ones((1, live.shape[1]), dtype=live.dtype,
                           device=live.device)       # k = 0: none live
        on = torch.cat([first, live]) != 0
        return (k * on).amax(0)

    last, jlast = last_live(idx[:, 2]), last_live(jidx[:, 2])

    def at(body, k):
        return sv[body, k, ar]

    def add(on, body, k, x):
        sv[body, k, ar] = torch.where(on, at(body, k) + x, at(body, k))

    def cross_c(x1, y2, x2, y1):
        # the kernel's fma(x1, y2, −(x2·y1)): addcmul is one fused
        # multiply-add on the CPU
        return torch.addcmul(-(x2 * y1), x1, y2)

    def rel_v(a, b, ra, rb, ax):
        va = [at(a, k) for k in range(6)]
        vb = [at(b, k) for k in range(6)]
        va0 = va[0] + cross_c(va[4], ra[2], va[5], ra[1])
        va1 = va[1] + cross_c(va[5], ra[0], va[3], ra[2])
        va2 = va[2] + cross_c(va[3], ra[1], va[4], ra[0])
        vb0 = vb[0] + cross_c(vb[4], rb[2], vb[5], rb[1])
        vb1 = vb[1] + cross_c(vb[5], rb[0], vb[3], rb[2])
        vb2 = vb[2] + cross_c(vb[3], rb[1], vb[4], rb[0])
        return (((vb0 - va0) * ax[0] + (vb1 - va1) * ax[1])
                + (vb2 - va2) * ax[2])

    def push(on, body, r, im, ii, p):
        t0 = cross_c(r[1], p[2], r[2], p[1])
        t1 = cross_c(r[2], p[0], r[0], p[2])
        t2 = cross_c(r[0], p[1], r[1], p[0])
        for k in range(3):
            add(on, body, k, im * p[k])
        for k in range(3):
            add(on, body, 3 + k,
                (ii[3 * k] * t0 + ii[3 * k + 1] * t1) + ii[3 * k + 2] * t2)

    def apply_pair(on, a, b, ra, rb, im_a, im_b, ii_a, ii_b, ax, dl):
        p = [ax[k] * dl for k in range(3)]
        push(on, a, ra, im_a, ii_a, [-x for x in p])
        push(on, b, rb, im_b, ii_b, p)

    def clamp(x, lo, hi):
        x = torch.where(x < lo, lo, x)
        return torch.where(x > hi, hi, x)

    inf = torch.full((bsz,), math.inf, dtype=f, device=vel.device)
    for _ in range(iterations):
        for c in range(int(last.max())):
            on = (c < last) & (idx[c, 2] != 0)
            a, b = idx[c, 0].long(), idx[c, 1].long()
            fld = rec[c]
            ra, rb = [fld[k] for k in range(0, 3)], [fld[k] for k in range(3, 6)]
            nrm = [fld[k] for k in range(6, 9)]
            axes = ([fld[k] for k in range(9, 12)],
                    [fld[k] for k in range(12, 15)])
            im_a, im_b = fld[20], fld[21]
            ii_a = [fld[22 + k] for k in range(9)]
            ii_b = [fld[31 + k] for k in range(9)]
            ln = lam_k[0, c]
            dl = omega * ((fld[18] - rel_v(a, b, ra, rb, nrm)) - cfm_term * ln
                          ) / fld[15]
            x = ln + dl
            dl = torch.where(x < 0, torch.zeros_like(x), x) - ln
            ln = torch.where(on, ln + dl, ln)
            lam_k[0, c] = ln
            apply_pair(on, a, b, ra, rb, im_a, im_b, ii_a, ii_b, nrm, dl)
            if mode == NO_FRICTION:
                continue
            bound = inf
            if mode == MU_GLOBAL:
                bound = mu * ln
            elif mode == MU_PER_ROW:
                bound = torch.where(torch.isinf(fld[19]), inf, fld[19] * ln)
            for k in range(2):
                lt = lam_k[1 + k, c]
                ds = omega * ((0.0 - rel_v(a, b, ra, rb, axes[k]))
                              - cfm_term * lt) / fld[16 + k]
                ds = clamp(lt + ds, -bound, bound) - lt
                lam_k[1 + k, c] = torch.where(on, lt + ds, lt)
                apply_pair(on, a, b, ra, rb, im_a, im_b, ii_a, ii_b,
                           axes[k], ds)
        for r in range(int(jlast.max())):
            on = (r < jlast) & (jidx[r, 2] != 0)
            a, b = jidx[r, 0].long(), jidx[r, 1].long()
            g = jrec[r]
            jn = [g[k] for k in range(3)]
            s_lin = (((at(b, 0) - at(a, 0)) * jn[0]
                      + (at(b, 1) - at(a, 1)) * jn[1])
                     + (at(b, 2) - at(a, 2)) * jn[2])
            s_b = (at(b, 3) * g[6] + at(b, 4) * g[7]) + at(b, 5) * g[8]
            s_a = (at(a, 3) * g[3] + at(a, 4) * g[4]) + at(a, 5) * g[5]
            rel = (s_lin + s_b) - s_a
            lj = jlam[r]
            dl = omega * ((g[18] - rel) - cfm_term * lj) / g[17]
            dl = clamp(lj + dl, g[19], g[20]) - lj
            jlam[r] = torch.where(on, lj + dl, lj)
            for k in range(3):
                add(on, a, k, -g[9] * (jn[k] * dl))
            for k in range(3):
                add(on, a, 3 + k, -g[11 + k] * dl)
            for k in range(3):
                add(on, b, k, g[10] * (jn[k] * dl))
            for k in range(3):
                add(on, b, 3 + k, g[14 + k] * dl)

    vel_out = sv.permute(2, 0, 1).contiguous()
    lam_out = None if rows is None else lam_k.permute(2, 1, 0).contiguous()
    return vel_out, lam_out
