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
counts the kernel's launches. The kernel reads the row table where the
solver built it (the (B, C, ...) tensors of ``ROW_KEYS``, the (B, R, ...)
ones of ``JOINT_KEYS``), through one array of pointers (``POINTERS``); the
wrapper checks them, makes contiguous and casts only what is not already in
the layout the kernel reads (int32 bodies, bool flags), allocates the
outputs and reads nothing back to the host, so a CUDA graph can hold the
launch. Each world's first ``staged_rows`` live rows are staged in shared
memory once a solve, with its velocities where they fit (``max_slots``; a
larger world's are worked on in place in device memory, so no world is
refused for its slots); ``launch_shape`` sizes the launch from the shapes.

``pgs_kernel_order`` is the kernel's loop transcribed to PyTorch on the
same unpacked table: the staging order, the staged rows, the rows past
them read from the table, a row's bodies held as registers; batched over
worlds as the warps run them (a world's missing row is a masked lane). The
CPU tests hold it to the plain version, so that the kernel's arithmetic
and layout are tested where there is no card. It lies on no path.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build

_LAUNCHERS = {torch.float32: "pgs_solve_launch",
              torch.float64: "pgs_solve_launch_f64"}
FLAGS = ("-fmad=false",)

# shared memory a block may opt into on Hopper (227 KB); the velocities of
# one world, (N, 6), take at most 48 KB of it: a larger world's stay in
# device memory
SHARED_BYTES = 232_448
VELOCITY_BYTES = 48 * 1024
MAX_WORLDS = 8          # worlds a block: a warp each stages, one steps all
MIN_STAGED = 16         # rows a world stages at least, where it has them
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
# the kernel's array of pointers, in its order (csrc/pgs_solve.cu)
POINTERS = (ROW_KEYS + ("lam", "lam_out")
            + tuple("j_" + k for k in JOINT_KEYS) + ("jlam", "vel",
                                                     "vel_out"))
_ROW_SHAPES = dict(a=(), b=(), valid=(), r_a=(3,), r_b=(3,), n=(3,),
                   t1=(3,), t2=(3,), d_n=(), d_t1=(), d_t2=(), target=(),
                   mu=(), inv_m_a=(), inv_m_b=(), inv_i_a=(3, 3),
                   inv_i_b=(3, 3))
_JOINT_SHAPES = dict(a=(), b=(), live=(), n=(3,), wa=(3,), wb=(3,),
                     inv_m_a=(), inv_m_b=(), ang_resp_a=(3,),
                     ang_resp_b=(3,), d_seq=(), rhs=(), lob=(), hib=())
_LIVE_KEYS = ("valid", "live")


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("pgs_solve.cu", FLAGS)


# the library's C interface: function → argtypes
FUNCTIONS = {
    name: ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 8
           + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_void_p])
    for name in _LAUNCHERS.values()}
FUNCTIONS["pgs_solve_resources"] = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]


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


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def max_slots(dtype: torch.dtype) -> int:
    """The most slots a world may have for its (N, 6) velocities to be
    kept in ``VELOCITY_BYTES`` of the block's shared memory; a larger
    world's are worked on in place in device memory (the kernel's slower
    branch), and no world is refused for its slots."""
    return VELOCITY_BYTES // (6 * _size(dtype))


def _shared_slots(size: int, n: int) -> int:
    """The slots whose velocities a world keeps in shared memory: all N,
    or none past ``max_slots``."""
    return n if 6 * n * size <= VELOCITY_BYTES else 0


def _world_bytes(size: int, n: int, staged: int, staged_joints: int) -> int:
    """A world's stride in shared memory (``csrc/pgs_solve.cu:
    world_bytes``): its velocities (none past ``max_slots``), the staged
    rows' fields and impulses,
    their bodies and buffer rows and its 4 live counts, rounded up to 128
    bytes, and 16 more (the sweeping warp's lanes then reach their worlds'
    fields in distinct banks)."""
    t = size * (6 * _shared_slots(size, n) + staged * (ROW_FIELDS + 3)
                + staged_joints * (JOINT_FIELDS + 1))
    return -(-(t + 4 * (3 * staged + 2 * staged_joints + 4)) // 128) * 128 + 16


class LaunchShape(NamedTuple):
    worlds: int            # W, worlds a block
    staged: int            # S, live contact rows a world stages
    staged_joints: int     # S_j, live joint rows a world stages
    shared_bytes: int      # the block's dynamic shared memory


def launch_shape(dtype: torch.dtype, num_slots: int, contact_rows: int,
                 joint_rows: int = 0) -> LaunchShape:
    """The kernel's launch for worlds of ``num_slots`` slots, C =
    ``contact_rows`` and R = ``joint_rows``: ``MAX_WORLDS`` worlds a block
    (fewer where a world's velocities leave too little room), each world's
    share of ``SHARED_BYTES`` after its velocities staged with contact rows
    and joint rows (joint rows at most half of it where there are contact
    rows too). From the shapes alone: nothing is read on the host."""
    size = _size(dtype)
    vel = 6 * _shared_slots(size, num_slots) * size + 16  # and live counts
    row = (ROW_FIELDS + 3) * size + 12
    jrow = (JOINT_FIELDS + 1) * size + 8

    def stride_room(worlds):
        """A world's room for its velocities and rows: its share, less the
        stride's padding (128 + 16 bytes at most)."""
        return SHARED_BYTES // worlds // 128 * 128 - 128

    least = (vel + min(contact_rows, MIN_STAGED) * row
             + min(joint_rows, MIN_STAGED) * jrow)
    worlds = MAX_WORLDS
    while worlds > 1 and stride_room(worlds) < least:
        worlds -= 1
    room = stride_room(worlds) - vel
    staged_joints = min(joint_rows, max(room // 2 if contact_rows else room,
                                        0) // jrow)
    staged = min(contact_rows, max(room - staged_joints * jrow, 0) // row)
    shared = worlds * _world_bytes(size, num_slots, staged, staged_joints)
    return LaunchShape(worlds, staged, staged_joints, shared)


def staged_rows(dtype: torch.dtype, num_slots: int) -> int:
    """S: the most live contact rows a world stages in shared memory, for
    any count of contact rows and no joint rows; a world's live rows past
    it are read from device memory, in order."""
    return launch_shape(dtype, num_slots, 1 << 30).staged


def resources(dtype: torch.dtype) -> dict:
    """What the card says of the built kernel of ``dtype``: registers a
    thread, local bytes a thread (spills), the most threads a block and
    the dynamic shared memory it may take."""
    out = (ctypes.c_int * 4)()
    err = _library().pgs_solve_resources(int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"pgs_solve resources: CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1],
                max_threads=out[2], max_dynamic_shared=out[3])


def _tensors(vel, lam, rows, joints_rows):
    out = [vel] + ([] if lam is None else [lam])
    for table, keys in ((rows, ROW_KEYS), (joints_rows, JOINT_KEYS)):
        if table is not None:
            out += [table[k] for k in keys if table.get(k) is not None]
    return out


def _check(vel, lam, rows, joints_rows, mode):
    """Raise on what the kernel does not take."""
    if vel.dtype not in _LAUNCHERS:
        raise TypeError(f"velocities of dtype {vel.dtype}: float32 or "
                        f"float64")
    if vel.dim() != 3 or vel.shape[2] != 6:
        raise ValueError(f"velocities of shape {tuple(vel.shape)}: expected "
                         f"(B, N, 6)")
    bsz, n = vel.shape[:2]
    if bsz == 0 or n == 0:
        raise ValueError("no worlds or no slots to solve")
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


def _kernel_layout(key: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: contiguous, the bodies int32, the
    flags bool; the tensor itself where it already is."""
    if key in ("a", "b") and x.dtype != torch.int32:
        x = x.to(torch.int32)
    elif key in _LIVE_KEYS and x.dtype != torch.bool:
        x = x != 0
    return x.contiguous()


class Launch(NamedTuple):
    tensors: dict          # POINTERS' name → tensor, kept alive
    pointers: ctypes.Array
    num_worlds: int
    num_slots: int
    contact_rows: int
    joint_rows: int
    shape: LaunchShape


def prepare(vel, lam, rows, joints_rows, mode: int) -> Launch:
    """A launch on these tensors, checked by ``pgs_solve``: the table as
    the kernel reads it (``_kernel_layout``), and the outputs allocated:
    the velocities and impulses, and the joint rows' impulses past the
    staged ones (scratch)."""
    bsz, n = vel.shape[:2]
    c = 0 if rows is None else rows["a"].shape[1]
    r = 0 if joints_rows is None else joints_rows["a"].shape[1]
    t = {"vel": vel.contiguous()}
    t["vel_out"] = torch.empty_like(t["vel"])
    if rows is not None:
        t.update({k: _kernel_layout(k, rows[k]) for k in ROW_KEYS
                  if k != "mu" or mode == MU_PER_ROW})
        t["lam"] = lam.contiguous()
        t["lam_out"] = torch.empty_like(t["lam"])
    if joints_rows is not None:
        t.update({"j_" + k: _kernel_layout(k, joints_rows[k])
                  for k in JOINT_KEYS})
        t["jlam"] = torch.empty((bsz, r), dtype=vel.dtype, device=vel.device)
    pointers = (ctypes.c_void_p * len(POINTERS))(
        *[t[k].data_ptr() if k in t and t[k].numel() else None
          for k in POINTERS])
    return Launch(t, pointers, bsz, n, c, r,
                  launch_shape(vel.dtype, n, c, r))


def launch(run: Launch, *, iterations: int, omega: float, cfm_term: float,
           mode: int, mu: float):
    """One launch of the kernel on ``prepare``'s tensors, on the current
    stream of their card. Returns (vel', lam'), ``run``'s outputs; lam' is
    None without contact rows. Counted in ``pgs_solve.launches``."""
    vel = run.tensors["vel"]
    fn = getattr(_library(), _LAUNCHERS[vel.dtype])
    w, s, sj, _ = run.shape
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        err = fn(run.pointers, run.num_worlds, run.num_slots,
                 run.contact_rows, run.joint_rows, w, s, sj, int(iterations),
                 float(omega), float(cfm_term), mode, float(mu), stream)
    if err != 0:
        raise RuntimeError(f"pgs_solve kernel launch failed: CUDA error "
                           f"{err}")
    pgs_solve.launches += 1
    return run.tensors["vel_out"], run.tensors.get("lam_out")


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
    _check(vel, lam, rows, joints_rows, mode)
    if vel.device.type == "cpu":
        from rl_ode_physics_tpu_torch.ops import solver
        return solver.pgs_sweeps_plain(
            vel, lam, rows, joints_rows, iterations=iterations, omega=omega,
            cfm_term=cfm_term, friction=friction, mu=mu,
            per_body_surface=per_body_surface)
    if not vel.is_cuda:
        raise ValueError(f"tensors on {vel.device}: the kernel takes them "
                         f"on a card, the plain version on the CPU")
    return launch(prepare(vel, lam, rows, joints_rows, mode),
                  iterations=iterations, omega=omega, cfm_term=cfm_term,
                  mode=mode, mu=mu)


pgs_solve.launches = 0


def live_rows(live: torch.Tensor, cap: int):
    """``csrc/pgs_solve.cu:find_live``, the warp's scan of each world's
    (B, n) live flags 32 at a time: a live row's place is the live count of
    the chunks before it plus the live flags below it in its chunk (the
    ballot's prefix popc). Returns (row (B, cap) int64: the buffer rows of
    each world's first ``cap`` live rows, in buffer order, -1 past its
    count; count (B,): its live rows; past (B,): its first live row after
    them, n if none)."""
    bsz, n = live.shape
    dev = live.device
    row = torch.full((bsz, cap), -1, dtype=torch.int64, device=dev)
    count = torch.zeros(bsz, dtype=torch.int64, device=dev)
    past = torch.full((bsz,), n, dtype=torch.int64, device=dev)
    for base in range(0, n, 32):
        on = live[:, base:base + 32] != 0
        c = torch.arange(base, base + on.shape[1], device=dev).expand_as(on)
        pos = count[:, None] + torch.cumsum(on, 1) - on.long()
        put = on & (pos < cap)
        row[put.nonzero(as_tuple=True)[0], pos[put]] = c[put]
        past = torch.minimum(past, torch.where(on & (pos == cap), c,
                                               n).amin(1))
        count = count + on.sum(1)
    return row, count, past


def pgs_kernel_order(vel, lam, rows, joints_rows=None, *, iterations: int,
                     omega: float, cfm_term: float, friction: bool = True,
                     mu: float = math.inf, per_body_surface: bool = False,
                     staged: int | None = None,
                     staged_joints: int | None = None):
    """``csrc/pgs_solve.cu``'s loop in PyTorch, on the unpacked table: the
    contract of ``pgs_solve``, computed operation by operation in the
    kernel's order, batched over worlds as its warps. Each world's live
    rows in ``live_rows``' order; its first ``staged`` (``staged_joints``)
    gathered once, as the prologue stages them (default: the launch's S,
    S_j of ``launch_shape``), the rest read from the table in each sweep
    and their impulses updated in the output in place; a row's two bodies
    loaded once, updated as registers through its axes (where a = b the
    second starts from the first's result) and stored a first, b last. A
    world with no row j is a masked lane. Any device; it lies on no
    path."""
    mode = friction_mode(friction, mu, per_body_surface)
    _check(vel, lam, rows, joints_rows, mode)
    f, dev = vel.dtype, vel.device
    bsz, n = vel.shape[:2]
    c = 0 if rows is None else rows["a"].shape[1]
    r = 0 if joints_rows is None else joints_rows["a"].shape[1]
    shape = launch_shape(f, n, c, r)
    s_cap = min(shape.staged if staged is None else staged, c)
    sj_cap = min(shape.staged_joints if staged_joints is None
                 else staged_joints, r)
    ar = torch.arange(bsz, device=dev)
    sv = vel.clone()           # each world's velocities in shared memory
    inf = torch.full((bsz,), math.inf, dtype=f, device=dev)

    def cross_c(x1, y2, x2, y1):
        # the kernel's fma(x1, y2, −(x2·y1)): addcmul is one fused
        # multiply-add on the CPU
        return torch.addcmul(-(x2 * y1), x1, y2)

    def clamp(x, lo, hi):
        x = torch.where(x < lo, lo, x)
        return torch.where(x > hi, hi, x)

    def bodies(on, a, b):
        """A row's bodies (a masked lane's are slot 0) and their 12
        components, loaded once into registers."""
        a, b = torch.where(on, a, 0), torch.where(on, b, 0)
        return (a, b, [sv[ar, a, k] for k in range(6)],
                [sv[ar, b, k] for k in range(6)])

    def store(on, a, b, va, vb):
        for body, v in ((a, va), (b, vb)):             # b last
            for k in range(6):
                sv[ar, body, k] = torch.where(on, v[k], sv[ar, body, k])

    def rel_v(va, vb, ra, rb, ax):
        a0 = va[0] + cross_c(va[4], ra[2], va[5], ra[1])
        a1 = va[1] + cross_c(va[5], ra[0], va[3], ra[2])
        a2 = va[2] + cross_c(va[3], ra[1], va[4], ra[0])
        b0 = vb[0] + cross_c(vb[4], rb[2], vb[5], rb[1])
        b1 = vb[1] + cross_c(vb[5], rb[0], vb[3], rb[2])
        b2 = vb[2] + cross_c(vb[3], rb[1], vb[4], rb[0])
        return ((b0 - a0) * ax[0] + (b1 - a1) * ax[1]) + (b2 - a2) * ax[2]

    def impulse(r_, im, ii, p):
        t0 = cross_c(r_[1], p[2], r_[2], p[1])
        t1 = cross_c(r_[2], p[0], r_[0], p[2])
        t2 = cross_c(r_[0], p[1], r_[1], p[0])
        return ([im * p[k] for k in range(3)]
                + [(ii[3 * k] * t0 + ii[3 * k + 1] * t1) + ii[3 * k + 2] * t2
                   for k in range(3)])

    def add_pair(va, vb, same, da, db):
        """va + da, then vb + db; where a = b, b's sum starts from a's."""
        a1 = [x + d for x, d in zip(va, da)]
        twice = [x + d for x, d in zip(a1, db)]
        b1 = [x + d for x, d in zip(vb, db)]
        return ([torch.where(same, t, x) for t, x in zip(twice, a1)],
                [torch.where(same, t, x) for t, x in zip(twice, b1)])

    def apply_pair(va, vb, same, g, ax, dl):
        p = [ax[k] * dl for k in range(3)]
        return add_pair(va, vb, same,
                        impulse(g["r_a"], g["inv_m_a"], g["inv_i_a"],
                                [-x for x in p]),
                        impulse(g["r_b"], g["inv_m_b"], g["inv_i_b"], p))

    def contact(on, g, a, b, lam3):
        """One contact row, its fields g (B, ...) and impulses lam3 (three
        (B,)): returns the new impulses (a masked lane's unchanged)."""
        a, b, va, vb = bodies(on, a, b)
        same = a == b
        ln = lam3[0]
        dl = omega * ((g["target"] - rel_v(va, vb, g["r_a"], g["r_b"],
                                           g["n"]))
                      - cfm_term * ln) / g["d_n"]
        x = ln + dl
        dl = torch.where(x < 0, torch.zeros_like(x), x) - ln
        out = [ln + dl, lam3[1], lam3[2]]
        va, vb = apply_pair(va, vb, same, g, g["n"], dl)
        if mode != NO_FRICTION:
            bound = inf
            if mode == MU_GLOBAL:
                bound = mu * out[0]
            elif mode == MU_PER_ROW:
                bound = torch.where(torch.isinf(g["mu"]), inf,
                                    g["mu"] * out[0])
            for k, (ax, d) in enumerate(((g["t1"], g["d_t1"]),
                                         (g["t2"], g["d_t2"]))):
                lt = lam3[1 + k]
                ds = omega * ((0.0 - rel_v(va, vb, g["r_a"], g["r_b"], ax))
                              - cfm_term * lt) / d
                ds = clamp(lt + ds, -bound, bound) - lt
                out[1 + k] = lt + ds
                va, vb = apply_pair(va, vb, same, g, ax, ds)
        store(on, a, b, va, vb)
        return [torch.where(on, o, i) for o, i in zip(out, lam3)]

    def joint(on, g, a, b, lj):
        a, b, va, vb = bodies(on, a, b)
        same = a == b
        nrm, wa, wb = g["n"], g["wa"], g["wb"]
        s_lin = (((vb[0] - va[0]) * nrm[0] + (vb[1] - va[1]) * nrm[1])
                 + (vb[2] - va[2]) * nrm[2])
        s_b = (vb[3] * wb[0] + vb[4] * wb[1]) + vb[5] * wb[2]
        s_a = (va[3] * wa[0] + va[4] * wa[1]) + va[5] * wa[2]
        rel = (s_lin + s_b) - s_a
        dl = omega * ((g["rhs"] - rel) - cfm_term * lj) / g["d_seq"]
        dl = clamp(lj + dl, g["lob"], g["hib"]) - lj
        da = ([-g["inv_m_a"] * (nrm[k] * dl) for k in range(3)]
              + [-g["ang_resp_a"][k] * dl for k in range(3)])
        db = ([g["inv_m_b"] * (nrm[k] * dl) for k in range(3)]
              + [g["ang_resp_b"][k] * dl for k in range(3)])
        store(on, a, b, *add_pair(va, vb, same, da, db))
        return torch.where(on, lj + dl, lj)

    def record(table, keys, idx):
        """Row idx (B,) of each world from the (B, rows, ...) table: (B,)
        fields, a vector's and a matrix's as lists of components."""
        g = {}
        for k in keys:
            x = table[k][ar, idx.clamp_min(0)]
            g[k] = (x.reshape(bsz, -1).unbind(1) if x.dim() > 1 else x)
        return g

    def stage(table, keys, order, cap):
        """The first ``cap`` live rows of each world gathered once, as the
        prologue stages them: (B, cap, ...) tensors."""
        idx = order[:, :cap].clamp_min(0)
        return {k: table[k][ar[:, None], idx] for k in keys}

    row_keys = [k for k in ROW_KEYS[3:] if k != "mu" or mode == MU_PER_ROW]
    joint_keys = list(JOINT_KEYS[3:])
    tables = []
    if rows is not None:
        order, count, _ = live_rows(rows["valid"], c)
        lam_out = lam.clone()          # dead rows' impulses pass through
        st = stage(rows, row_keys + ["a", "b"], order, s_cap)
        slam = lam[ar[:, None], order[:, :s_cap].clamp_min(0)].clone()
        tables.append((rows, row_keys, order, count, s_cap, st, slam, lam_out,
                       contact))
    if joints_rows is not None:
        jorder, jcount, _ = live_rows(joints_rows["live"], r)
        jst = stage(joints_rows, joint_keys + ["a", "b"], jorder, sj_cap)
        jslam = torch.zeros((bsz, sj_cap, 1), dtype=f, device=dev)
        jl_out = torch.zeros((bsz, r, 1), dtype=f, device=dev)
        tables.append((joints_rows, joint_keys, jorder, jcount, sj_cap, jst,
                       jslam, jl_out, joint))

    def solve(fn, on, g, a, b, lam_k):
        """fn on impulses lam_k (B, k): the new (B, k)."""
        if fn is joint:
            return joint(on, g, a, b, lam_k[:, 0])[:, None]
        return torch.stack(contact(on, g, a, b, lam_k.unbind(1)), 1)

    for _ in range(iterations):
        for table, keys, order, count, cap, st, slam, out, fn in tables:
            held = count.clamp(max=cap)
            for j in range(int(held.max()) if cap else 0):
                g = {k: (st[k][:, j].reshape(bsz, -1).unbind(1)
                         if st[k].dim() > 2 else st[k][:, j]) for k in keys}
                slam[:, j] = solve(fn, j < held, g, st["a"][:, j].long(),
                                   st["b"][:, j].long(), slam[:, j])
            # the live rows past the staged ones, read in place, in order
            for j in range(cap, int(count.max()) if count.numel() else 0):
                on = j < count
                idx = torch.where(on, order[:, j], 0)
                g = record(table, keys, idx)
                out[ar, idx] = solve(fn, on, g, table["a"][ar, idx].long(),
                                     table["b"][ar, idx].long(),
                                     out[ar, idx])
    if rows is None:
        return sv, None
    _, _, order, count, cap, _, slam, lam_out, _ = tables[0]
    held = count.clamp(max=cap)
    for j in range(cap):
        on = (j < held)[:, None]
        idx = order[:, j].clamp_min(0)
        lam_out[ar, idx] = torch.where(on, slam[:, j], lam_out[ar, idx])
    return sv, lam_out
