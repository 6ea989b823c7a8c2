"""Device probes on the card: the hand-written Hopper kernels.

``csrc/device_probe.cu`` replaces the three Pallas TPU kernels of
``benchmarks/device_probe.py``: ``probe_kernel_matmuls`` (a world's
(8, 64)·(64, 384) product in 16 dependent steps a trip),
``probe_kernel_vpu`` (16 chained multiply-adds a trip over an (8, 384) or
(32, 384) array) and ``probe_mxu_peak`` (a chain of (256, 256) products).
The library is built with ``nvcc`` at first use (``ops/kernel_build.py``).

Each wrapper launches its kernel for CUDA tensors and counts the launch on
its ``launches`` attribute. For CPU tensors, and only for those, it runs
its plain version beside it, which ``chip_smoke.py`` also holds the kernel
to on the card: ``probe_vpu`` (multiply, then add) and ``probe_mxu`` at
A = 1, B = 1/16 bit for bit; ``probe_mxu`` on random inputs at
``MATMUL_RTOL`` (the products sum in another order); ``probe_matmuls`` by
``matmuls_agree``: its acc within ``MATMUL_ULPS`` float32 spacings and its
checksum at ``MATMUL_RTOL``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build

CHAIN = 16                  # dependent steps a trip (the TPU probes' chain)
ROWS, INNER, COLS = 8, 64, 384          # probe_matmuls' (8, 64)·(64, 384)
VPU_THREADS = 1024                      # probe_vpu's one block
MXU_N = 256                             # probe_mxu's (256, 256) matrices
MXU_CLUSTER = 16                        # probe_mxu's blocks, one an SM
# how closely the products match their plain versions on random inputs
MATMUL_RTOL = 1e-5
# probe_matmuls' acc, in float32 spacings at the plain value: each step
# rounds acc, and a product summed in another order moves it by one at times
MATMUL_ULPS = 4

FUNCTIONS = {
    "probe_matmuls_launch":
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "probe_vpu_launch":
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "probe_mxu_launch":
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p],
    "probe_mxu_cluster_info": [ctypes.c_void_p],
}


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("device_probe.cu")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def _check_cuda(*tensors) -> None:
    dev = tensors[0].device
    for x in tensors:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}: the kernel "
                             f"takes CUDA tensors on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"expected contiguous float32, got {x.dtype}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# probe_kernel_matmuls
# ---------------------------------------------------------------------------

def probe_matmuls_plain(vel: torch.Tensor, s: torch.Tensor, trips: int):
    """The plain version: ``trips`` × 16 steps of ``acc += (acc·S_w)[:, :64]
    · 1e-6`` per world → (acc (W, 8, 64), checksum (W,) f64: the sum of
    every step's 384 columns)."""
    acc = vel.clone()
    checksum = torch.zeros(vel.shape[0], dtype=torch.float64,
                           device=vel.device)
    for _ in range(trips * CHAIN):
        vh = torch.bmm(acc, s)                              # (W, 8, 384)
        checksum += vh.sum((1, 2), dtype=torch.float64)
        acc = acc + vh[..., :INNER] * 1e-6
    return acc, checksum


def matmuls_errors(vel: torch.Tensor, got, want) -> dict:
    """How far a run of ``probe_matmuls`` on ``vel`` lies from ``want``,
    the plain version's (acc, checksum) on the same inputs: ``ulps``, acc's
    largest error in float32 spacings at the plain value; ``increment``,
    the largest error of the accumulated increment acc - vel over the
    largest increment (what the products added, far smaller than acc);
    ``checksum``, the checksum's error relative to its size (at least 1).
    An error in the product's first 64 columns moves acc, and one in any
    column moves the checksum."""
    acc, checksum = got
    ref, ref_sum = want
    mag = ref.abs()
    spacing = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
    inc = ref - vel
    return dict(
        ulps=float(((acc - ref).abs() / spacing).max()),
        increment=float(((acc - vel) - inc).abs().max()
                        / inc.abs().max().clamp_min(1e-30)),
        checksum=float(((checksum - ref_sum).abs()
                        / ref_sum.abs().clamp_min(1.0)).max()))


def matmuls_agree(errors: dict) -> bool:
    """Whether ``matmuls_errors`` are within the kernel's tolerance."""
    return (errors["ulps"] <= MATMUL_ULPS
            and errors["checksum"] <= MATMUL_RTOL)


def probe_matmuls(vel: torch.Tensor, s: torch.Tensor, trips: int):
    """vel (W, 8, 64), s (W, 64, 384) f32 → (acc (W, 8, 64), checksum (W,)
    f64): one block a world, S_w in registers, acc double-buffered in
    shared memory, f32 FMAs: a thread for each column of acc summing all of
    k in order (acc bit for bit the plain version's where the plain product
    sums k in order), quads of threads for the other 320 columns (4
    columns × 16 values of k a thread, the parts summed by shuffles)."""
    if vel.device.type == "cpu" and s.device.type == "cpu":
        return probe_matmuls_plain(vel, s, trips)
    _check_cuda(vel, s)
    w = vel.shape[0]
    if vel.shape != (w, ROWS, INNER) or s.shape != (w, INNER, COLS):
        raise ValueError(f"vel {tuple(vel.shape)}, s {tuple(s.shape)}: "
                         f"expected (W, {ROWS}, {INNER}), (W, {INNER}, "
                         f"{COLS})")
    if w < 1 or trips < 0:
        raise ValueError(f"{w} worlds, {trips} trips")
    out = torch.empty_like(vel)
    checksum = torch.empty((w,), dtype=torch.float64, device=vel.device)
    err = _library().probe_matmuls_launch(
        vel.data_ptr(), s.data_ptr(), out.data_ptr(), checksum.data_ptr(), w,
        trips, _stream(vel.device))
    _raise_on(err, "probe_matmuls")
    probe_matmuls.launches += 1
    return out, checksum


# ---------------------------------------------------------------------------
# probe_kernel_vpu
# ---------------------------------------------------------------------------

def probe_vpu_plain(x: torch.Tensor, trips: int, fused: bool = False):
    """The plain version: ``trips`` × 16 steps of ``acc · 1.0000001 + 1e-9``
    in float32, multiply then add (``fused``: one rounding, as ``fmaf``)."""
    acc = x.clone()
    if fused:
        scale = torch.full_like(acc, 1.0000001)
        bias = torch.full_like(acc, 1e-9)
    for _ in range(trips * CHAIN):
        acc = (torch.addcmul(bias, acc, scale) if fused
               else acc * 1.0000001 + 1e-9)
    return acc


def probe_vpu(x: torch.Tensor, trips: int, fused: bool = False):
    """x of 3,072 or 12,288 f32 values (the TPU probe's (8, 384) and
    (32, 384)) → the chain's result, each value an independent chain in a
    register of one block's 1,024 threads. ``fused``: ``fmaf`` in place of
    the multiply, then add (another rounding; its time is what counts)."""
    if x.device.type == "cpu":
        return probe_vpu_plain(x, trips, fused)
    _check_cuda(x)
    per = x.numel() // VPU_THREADS
    if per not in (3, 12) or x.numel() != per * VPU_THREADS:
        raise ValueError(f"{x.numel()} values: 3,072 or 12,288")
    if trips < 0:
        raise ValueError(f"{trips} trips")
    out = torch.empty_like(x)
    err = _library().probe_vpu_launch(x.data_ptr(), out.data_ptr(), per,
                                      trips, int(fused), _stream(x.device))
    _raise_on(err, "probe_vpu")
    probe_vpu.launches += 1
    return out


# ---------------------------------------------------------------------------
# probe_mxu_peak
# ---------------------------------------------------------------------------

def probe_mxu_plain(a: torch.Tensor, b: torch.Tensor, steps: int):
    """The plain version: ``steps`` products ``acc ← (acc·B)·0.0625``."""
    acc = a
    for _ in range(steps):
        acc = (acc @ b) * 0.0625
    return acc


def mxu_cluster_info() -> dict:
    """``probe_mxu``'s cluster on the current card: its blocks and how many
    such clusters the card holds at once (``cudaOccupancyMaxActiveClusters``,
    0 when none can be placed)."""
    info = (ctypes.c_int * 2)()
    _raise_on(_library().probe_mxu_cluster_info(ctypes.addressof(info)),
              "probe_mxu_cluster_info")
    return dict(cluster=info[0], max_active_clusters=info[1])


def probe_mxu(a: torch.Tensor, b: torch.Tensor, steps: int):
    """a, b (256, 256) f32 → the chain's result, one cluster of 16 blocks on
    16 SMs: block (i, j) computes output tile (i, j) of 64 × 64 from B's
    column slab and acc's row band in its shared memory, and writes it into
    the next band of its row's 4 blocks through distributed shared memory.
    Raises where the card cannot place the cluster."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_mxu_plain(a, b, steps)
    _check_cuda(a, b)
    if a.shape != (MXU_N, MXU_N) or b.shape != (MXU_N, MXU_N):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: expected "
                         f"({MXU_N}, {MXU_N})")
    if steps < 1:
        raise ValueError(f"steps={steps}: at least 1")
    buf = torch.empty((2, MXU_N, MXU_N), dtype=torch.float32,
                      device=a.device)
    err = _library().probe_mxu_launch(a.data_ptr(), b.data_ptr(),
                                      buf.data_ptr(), steps,
                                      _stream(a.device))
    _raise_on(err, "probe_mxu")
    probe_mxu.launches += 1
    return buf[(steps - 1) % 2]


probe_matmuls.launches = 0
probe_vpu.launches = 0
probe_mxu.launches = 0
