"""DANTZIG's pivot loop on the card: the hand-written Hopper kernel.

``csrc/lcp_pivot.cu`` runs the whole Murty principal block pivoting of
every world's contact LCP, boxed friction rows included, with the
single-pivot safeguard (``ops/lcp.STALL_ROUNDS``) in worlds with no boxed
row, in a fixed number of launches a solve: the warm guess, each world's
rounds to its own fixed point or to ``MAX_PIVOT_ROUNDS``, the final solve
and the projection. It
replaces no Pallas kernel: it is the port's form of the JAX package's
``lax.while_loop`` over pivot rounds (``rl_ode_physics_tpu/ops/lcp.py:206``),
which runs under ``jit`` and ``vmap`` on the device. It is built with
``nvcc`` for ``sm_90a`` into a shared library a dtype with a plain C
interface at first use and loaded with ``ctypes``
(``ops/kernel_build.py``).

``lcp_pivot_solve`` launches the kernels for CUDA tensors, float32 or
float64. For CPU tensors, and only for those, it runs the kernel's plain
version, ``ops/lcp.py:_pivot_solve``, the batched Python loop with a host
read a round. ``lcp_pivot_solve.launches`` counts its calls on the card,
one a solve. The wrapper checks its inputs, allocates the outputs (λ, each
world's rounds) and the kernels' work space, and reads nothing back to the
host, so a CUDA graph can hold the solve.

The kernels solve only each world's active rows: an inactive or invalid
row of the plain version's masked matrix is the identity's, and so is its
column, so the active block's solve gives the same λ. A world's tier comes
from its valid count V, counted on the card (``tier_of``): up to
``STAGED_ROWS`` (32) a warp a world, a thread a valid row, its entries of
the active block in registers; up to ``MEDIUM_ROWS`` (64) the same on two
warps, persistent blocks that take the worlds past the stage from a
worklist; past that persistent blocks of 256 threads with the 227 KB
opt-in, the active block in shared memory up to ``shared_rows`` rows and
in a slot of device memory past them (a blocked elimination), the panel
and the world's vectors in the slot too where R is too large for them to
sit in shared memory (``far``): every R is solved. ``launch_shape`` sizes
all of it from the shapes alone. What bounds it: each world's chain of
pivot steps; its bytes and operations are a few microseconds of the
card's rates at dantzig-1024's shapes (``utils/bounds.lcp_pivot_bound``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build

# the library of each dtype is built from the one source with this flag
BUILD_FLAGS = {torch.float32: ("-DLCP_PIVOT_F64=0",),
          torch.float64: ("-DLCP_PIVOT_F64=1",)}
# the register tiers' most valid rows: a thread a row, its entries of the
# active block in registers; a warp a world (staged), two warps (medium)
STAGED_ROWS = 32
MEDIUM_ROWS = 64
# the medium tier's persistent blocks an SM (at least as many as fit)
MEDIUM_BLOCKS_PER_SM = 8
# the H100 SXM's SMs: the worklist tiers' persistent blocks are sized by it
SMS = 132
# a block's dynamic shared memory with the opt-in, and an SM's
MAX_SHARED = 232448
SM_SHARED = 233472
# the blocked elimination's panel columns and the trailing update's column
# tile; csrc/lcp_pivot.cu's kScratch, kCounters
PANEL = 32
TILE = 64
_SCRATCH = 64
# the most active rows the large tier eliminates in shared memory (its
# threads × the columns a thread updates in a step, exclusive)
_MAX_SHARED_ROWS = 255
_COUNTERS = 8
TIERS = ("staged", "medium", "large")

# a library's C interface: function → argtypes
FUNCTIONS = {
    "lcp_pivot_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "lcp_pivot_resources": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]}


def build(dtype: torch.dtype):
    """Compile the kernel library of ``dtype`` (once per source version)
    and return its path."""
    return kernel_build.build("lcp_pivot.cu", BUILD_FLAGS[dtype])


@functools.lru_cache(maxsize=None)
def _library(dtype: torch.dtype) -> ctypes.CDLL:
    return kernel_build.load(build(dtype), FUNCTIONS)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def vector_bytes(size: int, cap: int) -> int:
    """A large-tier block's vectors (``csrc/lcp_pivot.cu:vector_bytes``) in
    elements of ``size`` bytes: 8 of ``cap`` rows and 64 scratch elements,
    7 of ints and 64 scratch ints, 3 of bytes, each part rounded up to 16
    bytes."""
    return (_align16((8 * cap + _SCRATCH) * size)
            + _align16((7 * cap + _SCRATCH) * 4) + _align16(3 * cap))


def panel_elems(rows: int) -> int:
    """The blocked elimination's panel: ``rows`` rows of ``PANEL`` + 1
    elements, then a tile's U12 (``csrc/lcp_pivot.cu:panel_elems``)."""
    return rows * (PANEL + 1) + PANEL * TILE


def shared_bytes(size: int, rows: int, region: int, far: bool) -> int:
    """A large-tier block's shared memory: the region, then the vectors
    unless ``far`` (``csrc/lcp_pivot.cu:shared_bytes``)."""
    return _align16(region * size) + (0 if far else vector_bytes(size, rows))


def slot_bytes(size: int, rows: int, far: bool) -> int:
    """A large-tier block's slot of device memory: the trailing matrix R ×
    (R + 1), then the panel and the vectors where ``far``
    (``csrc/lcp_pivot.cu:slot_bytes``)."""
    return _align16(rows * (rows + 1) * size) + (
        _align16(panel_elems(rows) * size) + vector_bytes(size, rows)
        if far else 0)


def _rows_in(region: int, rows: int) -> int:
    """The most active rows (at most R) whose m × (m + 1) augmented matrix,
    at an odd row stride, fits ``region`` elements."""
    m = min(rows, _MAX_SHARED_ROWS)
    while m > 0 and m * ((m + 1) | 1) > region:
        m -= 1
    return m


class LaunchShape(NamedTuple):
    staged_rows: int       # the staged tier's most valid rows (cap_s)
    medium_rows: int       # the medium tier's most valid rows (0: none)
    medium_blocks: int     # its persistent blocks
    large_blocks: int      # the large tier's persistent blocks (0: none)
    large_bytes: int       # a large block's dynamic shared memory
    large_region: int      # elements of its elimination's region
    shared_rows: int       # the most active rows it eliminates in shared
    far: bool              # the panel and the vectors in the slot
    slot_bytes: int        # a large block's device-memory slot (0: none)
    launches: int          # kernel launches a solve, the memset included


def launch_shape(dtype: torch.dtype, num_worlds: int, rows: int
                 ) -> LaunchShape:
    """The launches for ``num_worlds`` worlds of R = ``rows`` rows, from
    the shapes alone: nothing is read on the host. The large tier keeps
    its panel and vectors in shared memory beside the region while they
    fit, else (``far``) in its slot, with all of shared memory for the
    region."""
    size = torch.empty((), dtype=dtype).element_size()
    cap_s = min(rows, STAGED_ROWS)
    if rows <= cap_s:
        return LaunchShape(cap_s, 0, 0, 0, 0, 0, 0, False, 0, 1)
    cap_m = min(rows, MEDIUM_ROWS)
    medium = (cap_m, min(num_worlds, MEDIUM_BLOCKS_PER_SM * SMS))
    if rows <= cap_m:
        return LaunchShape(cap_s, *medium, 0, 0, 0, 0, False, 0, 3)
    near = max(MAX_SHARED - vector_bytes(size, rows), 0) // size
    far = _rows_in(near, rows) < rows and (
        _rows_in(near, rows) < PANEL or panel_elems(rows) > near)
    region = MAX_SHARED // size if far else near
    nm = _rows_in(region, rows)
    slot = slot_bytes(size, rows, far) if nm < rows else 0
    return LaunchShape(cap_s, *medium, min(num_worlds, SMS),
                       shared_bytes(size, rows, region, far), region, nm,
                       far, slot, 4)


def tier_of(rows: int, valid_count: int) -> str:
    """The tier that takes a world of ``valid_count`` valid rows of R =
    ``rows``: "staged", "medium" or "large"."""
    if valid_count <= min(rows, STAGED_ROWS):
        return "staged"
    return "medium" if valid_count <= MEDIUM_ROWS else "large"


def boundary_counts(dtype: torch.dtype, rows: int) -> list:
    """The valid counts at each tier boundary of R = ``rows``: the stage's
    cap and one more, the medium tier's and one more, the large tier's
    shared rows (the most active rows it eliminates in shared memory) less
    and plus one, and every row valid."""
    shape = launch_shape(dtype, 1, rows)
    cuts = [shape.staged_rows, shape.staged_rows + 1, shape.medium_rows,
            shape.medium_rows + 1, shape.shared_rows - 1,
            shape.shared_rows + 1, rows]
    return sorted({v for v in cuts if 1 <= v <= rows})


def resources(dtype: torch.dtype) -> dict:
    """What the card says of each tier's built kernel of ``dtype``:
    registers a thread, local bytes a thread (spills), the most threads a
    block, the dynamic shared memory it may take and its static shared
    memory."""
    out = {}
    for which, tier in enumerate(TIERS):
        res = (ctypes.c_int * 5)()
        err = _library(dtype).lcp_pivot_resources(which, res)
        if err != 0:
            raise RuntimeError(f"lcp_pivot resources: CUDA error {err}")
        out[tier] = dict(registers=res[0], local_bytes=res[1],
                         max_threads=res[2], max_dynamic_shared=res[3],
                         static_shared=res[4])
    return out


def _check(a_mat, b, valid, is_normal, mu_row):
    """Raise on what the kernel does not take."""
    if a_mat.dtype not in BUILD_FLAGS:
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
    """The kernels of one solve on checked CUDA tensors, on the current
    stream of their card: (λ (B, R), rounds (B,) int32, the worklists'
    counters (``tier_counts``) or None where no world can pass the stage),
    new tensors. Counted once in ``lcp_pivot_solve.launches``."""
    bsz, r = b.shape
    f = a_mat.dtype
    shape = launch_shape(f, bsz, r)
    dev = a_mat.device
    b = b.contiguous()
    valid, is_normal = valid.contiguous(), is_normal.contiguous()
    mu = None if mu_row is None else mu_row.to(f).contiguous()
    lam = torch.empty((bsz, r), dtype=f, device=dev)
    rounds = torch.empty((bsz,), dtype=torch.int32, device=dev)
    counters = lists = slots = None
    if shape.medium_rows:
        work = torch.empty((_COUNTERS + 2 * bsz,), dtype=torch.int32,
                           device=dev)
        counters, lists = work[:_COUNTERS], work[_COUNTERS:]
    if shape.slot_bytes:
        slots = torch.empty((shape.large_blocks * shape.slot_bytes,),
                            dtype=torch.uint8, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _library(f).lcp_pivot_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(a_mat), ptr(b), ptr(valid), ptr(is_normal), ptr(mu),
                 ptr(lam), ptr(rounds), ptr(counters), ptr(lists),
                 ptr(slots), bsz, r, shape.staged_rows, shape.medium_rows,
                 shape.medium_blocks, shape.large_blocks, shape.large_region,
                 shape.shared_rows, int(shape.far), int(bool(friction)),
                 stream)
    if err != 0:
        raise RuntimeError(f"lcp_pivot kernel launch failed: CUDA error "
                           f"{err}")
    lcp_pivot_solve.launches += 1
    return lam, rounds, counters


def tier_counts(num_worlds: int, counters) -> dict:
    """The worlds each tier took in a solve on the card, and the solves of
    the large tier that took the blocked elimination, from the counters
    ``launch`` returned (a host read); every world staged where the solve
    needed no worklist (None)."""
    if counters is None:
        return dict(staged=num_worlds, medium=0, large=0, blocked_solves=0)
    medium, _, large, _, blocked = (int(x) for x in counters[:5].tolist())
    return dict(staged=num_worlds - medium - large, medium=medium,
                large=large, blocked_solves=blocked)


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
    return launch(a_mat, b, valid, is_normal, friction, mu_row)[:2]


lcp_pivot_solve.launches = 0
