"""DANTZIG's pivot loop on the card: the hand-written Hopper kernel.

``csrc/lcp_pivot.cu`` runs the whole Murty principal block pivoting of
every world's contact LCP, boxed friction rows included, in one launch a
solve: the warm guess, each world's rounds to its own fixed point or to
``MAX_PIVOT_ROUNDS``, the final solve and the projection. It replaces no
Pallas kernel: it is the port's form of the JAX package's
``lax.while_loop`` over pivot rounds (``rl_ode_physics_tpu/ops/lcp.py:206``),
which runs under ``jit`` and ``vmap`` on the device. It is built with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use and loaded with ``ctypes`` (``ops/kernel_build.py``).

``lcp_pivot_solve`` launches the kernel for CUDA tensors, float32 or
float64. For CPU tensors, and only for those, it runs the kernel's plain
version, ``ops/lcp.py:_pivot_solve``, the batched Python loop with a host
read a round. ``lcp_pivot_solve.launches`` counts the kernel's launches.
The wrapper checks its inputs, allocates the outputs (λ, each world's
rounds) and the slower branch's pool, and reads nothing back to the host,
so a CUDA graph can hold the launch.

The kernel solves only each world's active rows: an inactive or invalid
row of the plain version's masked matrix is the identity's, and so is its
column, so the active block's solve gives the same λ. A world stages its
valid rows' block of A in shared memory where it has at most
``STAGED_ROWS`` of them; a world with more works in one of ``POOL_WORLDS``
slots of device memory (``launch_shape``). What bounds it: each world's
dependent chain of pivot steps; its bytes (each world's valid block of A,
b, μ and flags in, λ and rounds out) and operations are a few
microseconds of the card's rates at dantzig-1024's shapes
(``utils/bounds.lcp_pivot_bound``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build

_LAUNCHERS = {torch.float32: "lcp_pivot_launch",
              torch.float64: "lcp_pivot_launch_f64"}
# the valid rows a world stages in shared memory: its work space then
# stays under 48 KB a block (``world_bytes``)
STAGED_ROWS = {torch.float32: 64, torch.float64: 48}
# device-memory slots of the worlds past STAGED_ROWS: at most this many
# are solved at once
POOL_WORLDS = 32

# the library's C interface: function → argtypes
FUNCTIONS = {
    name: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name in _LAUNCHERS.values()}
FUNCTIONS["lcp_pivot_resources"] = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("lcp_pivot.cu")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def world_bytes(dtype: torch.dtype, cap: int, staged: bool) -> int:
    """A world's work space for up to ``cap`` rows (``csrc/lcp_pivot.cu:
    world_bytes``): the active block's matrix at an odd row stride, with
    ``staged`` the copy of A's valid block too, 6 vectors of ``dtype``,
    3 of ints and 3 of bytes, rounded up to 16 bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    mat = cap * (cap | 1)
    total = size * ((2 if staged else 1) * mat + 6 * cap) + 4 * 3 * cap \
        + 3 * cap
    return -(-total // 16) * 16


class LaunchShape(NamedTuple):
    cap: int               # the most valid rows a world stages
    shared_bytes: int      # a block's dynamic shared memory
    pool_worlds: int       # device-memory slots (0: every world fits)
    slot_bytes: int        # one slot's bytes


def launch_shape(dtype: torch.dtype, num_worlds: int, rows: int
                 ) -> LaunchShape:
    """The launch for ``num_worlds`` worlds of R = ``rows`` rows, from the
    shapes alone: nothing is read on the host."""
    cap = min(rows, STAGED_ROWS[dtype])
    pool = min(num_worlds, POOL_WORLDS) if rows > cap else 0
    return LaunchShape(cap, world_bytes(dtype, cap, True), pool,
                       world_bytes(dtype, rows, False) if pool else 0)


def resources(dtype: torch.dtype) -> dict:
    """What the card says of the built kernel of ``dtype``: registers a
    thread, local bytes a thread (spills), the most threads a block and
    the dynamic shared memory it may take."""
    out = (ctypes.c_int * 4)()
    err = _library().lcp_pivot_resources(int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"lcp_pivot resources: CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1],
                max_threads=out[2], max_dynamic_shared=out[3])


def _check(a_mat, b, valid, is_normal, mu_row):
    """Raise on what the kernel does not take."""
    if a_mat.dtype not in _LAUNCHERS:
        raise TypeError(f"A of dtype {a_mat.dtype}: float32 or float64")
    if a_mat.dim() != 3 or a_mat.shape[1] != a_mat.shape[2]:
        raise ValueError(f"A of shape {tuple(a_mat.shape)}: expected "
                         f"(B, R, R)")
    bsz, r = a_mat.shape[:2]
    if bsz == 0 or r == 0 or r % 3:
        raise ValueError(f"A of shape {tuple(a_mat.shape)}: B > 0 worlds "
                         f"and R = 3C > 0 rows")
    if not a_mat.is_contiguous():
        raise ValueError("A must be contiguous: the kernel reads it where "
                         "it lies")
    for name, x in (("b", b), ("valid", valid), ("is_normal", is_normal)):
        if tuple(x.shape) != (bsz, r):
            raise ValueError(f"{name} of shape {tuple(x.shape)}: expected "
                             f"{(bsz, r)}")
    if b.dtype != a_mat.dtype:
        raise TypeError(f"b of dtype {b.dtype}, A {a_mat.dtype}")
    for name, x in (("valid", valid), ("is_normal", is_normal)):
        if x.dtype != torch.bool:
            raise TypeError(f"{name} of dtype {x.dtype}: bool")
    if mu_row is not None and tuple(mu_row.shape) != (bsz, r // 3):
        raise ValueError(f"mu_row of shape {tuple(mu_row.shape)}: expected "
                         f"{(bsz, r // 3)}")
    devices = {x.device for x in (a_mat, b, valid, is_normal, mu_row)
               if x is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on {sorted(map(str, devices))}: the "
                         f"kernel takes them on one card, the plain version "
                         f"on the CPU")


def launch(a_mat, b, valid, is_normal, friction: bool, mu_row=None):
    """One launch of the kernel on checked CUDA tensors, on the current
    stream of their card: (λ (B, R), rounds (B,) int32), new tensors.
    Counted in ``lcp_pivot_solve.launches``."""
    bsz, r = b.shape
    f = a_mat.dtype
    shape = launch_shape(f, bsz, r)
    dev = a_mat.device
    b = b.contiguous()
    valid, is_normal = valid.contiguous(), is_normal.contiguous()
    mu = None if mu_row is None else mu_row.to(f).contiguous()
    lam = torch.empty((bsz, r), dtype=f, device=dev)
    rounds = torch.empty((bsz,), dtype=torch.int32, device=dev)
    pool = locks = None
    if shape.pool_worlds:
        pool = torch.empty((shape.pool_worlds * shape.slot_bytes,),
                           dtype=torch.uint8, device=dev)
        locks = torch.zeros((shape.pool_worlds,), dtype=torch.int32,
                            device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = getattr(_library(), _LAUNCHERS[f])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(a_mat), ptr(b), ptr(valid), ptr(is_normal), ptr(mu),
                 ptr(lam), ptr(rounds), ptr(pool), ptr(locks), bsz, r,
                 shape.cap, shape.pool_worlds, int(bool(friction)), stream)
    if err != 0:
        raise RuntimeError(f"lcp_pivot kernel launch failed: CUDA error "
                           f"{err}")
    lcp_pivot_solve.launches += 1
    return lam, rounds


def lcp_pivot_solve(a_mat: torch.Tensor, b: torch.Tensor,
                    valid: torch.Tensor, is_normal: torch.Tensor,
                    friction: bool, mu_row=None):
    """Murty principal block pivoting with boxed friction rows of every
    world: A (B, R, R) float32 or float64, contiguous; b (B, R); valid and
    is_normal (B, R) bool; ``mu_row`` (B, C) the friction coefficient a
    contact (``inf``: a bilateral row) or None (all ``inf``). Returns
    (λ (B, R), each world's pivot rounds (B,) int32). The contract of
    ``ops/lcp.py:_pivot_solve``, its plain version, which CPU tensors
    take."""
    _check(a_mat, b, valid, is_normal, mu_row)
    if a_mat.device.type == "cpu":
        from rl_ode_physics_tpu_torch.ops import lcp
        return lcp._pivot_solve(a_mat, b, valid, is_normal, friction,
                                mu_row)
    if not a_mat.is_cuda:
        raise ValueError(f"tensors on {a_mat.device}: the kernel takes them "
                         f"on a card, the plain version on the CPU")
    return launch(a_mat, b, valid, is_normal, friction, mu_row)


lcp_pivot_solve.launches = 0
