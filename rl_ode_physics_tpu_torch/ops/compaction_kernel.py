"""Contact-payload compaction on the card: the hand-written Hopper kernel.

``csrc/compact_rows.cu`` replaces the Pallas TPU kernel
``rl_ode_physics_tpu/ops/compaction_pallas.py:compact_rows_t_pallas``. It is
built with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use and loaded with ``ctypes`` (``ops/kernel_build.py``).

``compact_rows_t`` launches the kernel for CUDA tensors, float32 or
float64, at any k. For CPU tensors, and only for those, it runs the
kernel's plain version, ``ops/compaction.py:compact_rows_t``, which
``chip_smoke.py`` also holds the kernel to on the card, bit for bit.
``compact_rows_t.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rl_ode_physics_tpu_torch.ops import compaction, kernel_build

# the launcher for each payload dtype
_LAUNCHERS = {torch.float32: "compact_rows_launch",
              torch.float64: "compact_rows_launch_f64"}


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("compact_rows.cu")


# the library's C interface: launcher → argtypes
FUNCTIONS = {
    name: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name in _LAUNCHERS.values()}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def compact_rows_t(mask: torch.Tensor, payload_t: torch.Tensor, k: int,
                   sel_dtype=None):
    """mask (B, M) bool, payload_t (B, D, M) f32 or f64 → (rows_t (B, D, k)
    of the payload's dtype, valid (B, k) bool, count (B,) int32, overflow
    (B,) int32), the contract of ``ops/compaction.py:compact_rows_t``, for
    any k >= 1. ``sel_dtype`` rounds the payload first: to bf16, or to
    float32 (a change only for a float64 payload)."""
    if mask.device.type == "cpu" and payload_t.device.type == "cpu":
        return compaction.compact_rows_t(mask, payload_t, k, sel_dtype)
    if not mask.is_cuda or mask.device != payload_t.device:
        raise ValueError(f"mask on {mask.device}, payload on "
                         f"{payload_t.device}")
    if mask.dtype != torch.bool or payload_t.dtype not in _LAUNCHERS:
        raise TypeError(f"expected bool mask and float32 or float64 payload, "
                        f"got {mask.dtype} and {payload_t.dtype}")
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
    if k < 1:
        raise ValueError(f"k={k}: the kernel keeps at least 1 column")
    if b == 0 or d == 0:
        raise ValueError("no worlds or no payload rows to compact")

    if sel_dtype is torch.bfloat16:
        round_mode = 1
    elif sel_dtype is torch.float32 and payload_t.dtype == torch.float64:
        round_mode = 2
    else:
        round_mode = 0
    rows_t = torch.empty((b, d, k), dtype=payload_t.dtype, device=mask.device)
    valid = torch.empty((b, k), dtype=torch.bool, device=mask.device)
    count = torch.empty((b,), dtype=torch.int32, device=mask.device)
    overflow = torch.empty((b,), dtype=torch.int32, device=mask.device)
    launch = getattr(_library(), _LAUNCHERS[payload_t.dtype])
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            mask.data_ptr(), payload_t.data_ptr(), rows_t.data_ptr(),
            valid.data_ptr(), count.data_ptr(), overflow.data_ptr(),
            b, d, m, k, round_mode, stream)
    if err != 0:
        raise RuntimeError(f"compact_rows kernel launch failed: CUDA error "
                           f"{err}")
    compact_rows_t.launches += 1
    return rows_t, valid, count, overflow


compact_rows_t.launches = 0
