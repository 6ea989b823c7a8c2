"""Contact-payload compaction on the card: the hand-written Hopper kernel.

``csrc/compact_rows.cu`` replaces the Pallas TPU kernel
``rl_ode_physics_tpu/ops/compaction_pallas.py:compact_rows_t_pallas``. It is
built with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, into ``build/kernels/`` at the root of the
checkout, and loaded with ``ctypes``. No PyTorch header is compiled, so the
build takes seconds.

``compact_rows_t`` launches the kernel for CUDA tensors. For CPU tensors,
and only for those, it runs the kernel's plain version,
``ops/compaction.py:compact_rows_t``, which ``chip_smoke.py`` also holds
the kernel to on the card. ``compact_rows_t.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from rl_ode_physics_tpu_torch.ops import compaction

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "compact_rows.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# the (D, k) output tile lives in static-size dynamic shared memory
_MAX_TILE_BYTES = 48 * 1024


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the compaction kernel is built "
                           "with the CUDA toolkit's nvcc")
    return str(path)


def build() -> Path:
    """Compile the kernel library (once per source version) and return its
    path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcompact_rows_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.compact_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def compact_rows_t(mask: torch.Tensor, payload_t: torch.Tensor, k: int,
                   sel_dtype=None):
    """mask (B, M) bool, payload_t (B, D, M) f32 → (rows_t (B, D, k) f32,
    valid (B, k) bool, count (B,) int32, overflow (B,) int32), the contract
    of ``ops/compaction.py:compact_rows_t``. ``sel_dtype=torch.bfloat16``
    rounds the payload to bf16 first."""
    if mask.device.type == "cpu" and payload_t.device.type == "cpu":
        return compaction.compact_rows_t(mask, payload_t, k, sel_dtype)
    if not mask.is_cuda or mask.device != payload_t.device:
        raise ValueError(f"mask on {mask.device}, payload on "
                         f"{payload_t.device}")
    if mask.dtype != torch.bool or payload_t.dtype != torch.float32:
        raise TypeError(f"expected bool mask and float32 payload, got "
                        f"{mask.dtype} and {payload_t.dtype}")
    if payload_t.dim() != 3 or mask.shape != (payload_t.shape[0],
                                              payload_t.shape[2]):
        raise ValueError(f"shapes mask {tuple(mask.shape)}, payload "
                         f"{tuple(payload_t.shape)}: expected (B, M) and "
                         f"(B, D, M)")
    if not (mask.is_contiguous() and payload_t.is_contiguous()):
        raise ValueError("mask and payload_t must be contiguous")
    if sel_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"sel_dtype {sel_dtype}: None, float32 or bfloat16")
    b, d, m = payload_t.shape
    if k < 1 or d * k * 4 > _MAX_TILE_BYTES:
        raise ValueError(f"k={k}, D={d}: the (D, k) f32 tile must fit in "
                         f"{_MAX_TILE_BYTES} bytes of shared memory")
    if b == 0:
        raise ValueError("no worlds to compact")

    rows_t = torch.empty((b, d, k), dtype=torch.float32, device=mask.device)
    valid = torch.empty((b, k), dtype=torch.bool, device=mask.device)
    count = torch.empty((b,), dtype=torch.int32, device=mask.device)
    overflow = torch.empty((b,), dtype=torch.int32, device=mask.device)
    lib = _library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compact_rows_launch(
            mask.data_ptr(), payload_t.data_ptr(), rows_t.data_ptr(),
            valid.data_ptr(), count.data_ptr(), overflow.data_ptr(),
            b, d, m, k, int(sel_dtype is torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: CUDA error "
                           f"{err}")
    compact_rows_t.launches += 1
    return rows_t, valid, count, overflow


compact_rows_t.launches = 0
