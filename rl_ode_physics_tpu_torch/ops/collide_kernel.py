"""The classic narrowphase's collide on the card: the hand-written Hopper
kernel.

``csrc/collide_pairs.cu`` computes every broadphase candidate's contact
manifold in one launch: each valid candidate runs only its own type pair's
kernel, in registers, with the two feature rows read where
``narrowphase._features`` wrote them. It replaces no Pallas kernel: the JAX
package's classic narrowphase is plain ``jnp``. It is built with ``nvcc``
for ``sm_90a`` (``-fmad=false``, so that it rounds as PyTorch does) into a
shared library with a plain C interface at first use and loaded with
``ctypes`` (``ops/kernel_build.py``).

``collide_pairs`` launches the kernel for CUDA tensors, float32 or float64,
at any k from 1 to 8. For CPU tensors, and only for those, it runs the
plain version, ``collide_pairs_plain``: the feature rows gathered and every
enabled pair kernel run through ``pair_kernels.collide_pair``, then masked
by the candidates' validity. ``collide_pairs.launches`` counts the
kernel's launches.

The two agree on every valid candidate: the same points, normals, depths
and validity (the card tests hold them to it). On an invalid candidate the
kernel runs no pair kernel and stores zeros; the plain version leaves what
the kernels computed there, with validity false. Neither is read: the
compaction keeps valid rows only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rl_ode_physics_tpu_torch.core.config import EngineConfig
from rl_ode_physics_tpu_torch.ops import kernel_build
from rl_ode_physics_tpu_torch.ops import pair_kernels as pk

# the launcher for each feature dtype
_LAUNCHERS = {torch.float32: "collide_pairs_launch",
              torch.float64: "collide_pairs_launch_f64"}
FLAGS = ("-fmad=false",)
MAX_K = 8


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("collide_pairs.cu", FLAGS)


# the library's C interface: launcher → argtypes
FUNCTIONS = {
    name: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    for name in _LAUNCHERS.values()}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def enabled_bits(config: EngineConfig) -> int:
    """The kernel's mask of enabled pair kernels: bit i for the i-th type
    pair of ``pair_kernels._PAIR_KERNELS``, set where ``_enabled_kernels``
    keeps it."""
    enabled = pk._enabled_kernels(config)
    return sum(1 << i for i, pair in enumerate(pk._PAIR_KERNELS)
               if pair in enabled)


def _check(feats, ia, ib, valid, k: int, config: EngineConfig) -> None:
    devices = {t.device for t in (feats, ia, ib, valid)}
    if len(devices) != 1:
        raise ValueError(f"tensors on {sorted(map(str, devices))}: expected "
                         f"one device")
    if feats.dtype not in _LAUNCHERS:
        raise TypeError(f"features {feats.dtype}: expected float32 or "
                        f"float64")
    if ia.dtype != torch.int32 or ib.dtype != torch.int32 or (
            valid.dtype != torch.bool):
        raise TypeError(f"expected int32 ia, ib and bool valid, got "
                        f"{ia.dtype}, {ib.dtype} and {valid.dtype}")
    if (feats.dim() != 3 or feats.shape[-1] != 11 or ia.dim() != 2
            or ia.shape[0] != feats.shape[0]
            or not ia.shape == ib.shape == valid.shape):
        raise ValueError(f"shapes feats {tuple(feats.shape)}, ia "
                         f"{tuple(ia.shape)}, ib {tuple(ib.shape)}, valid "
                         f"{tuple(valid.shape)}: expected (B, N, 11) and "
                         f"(B, CP)")
    if not all(t.is_contiguous() for t in (feats, ia, ib, valid)):
        raise ValueError("feats, ia, ib and valid must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel keeps 1 to {MAX_K} slots a pair")
    if not pk.manifolds_fit(pk._enabled_kernels(config), k):
        raise ValueError(f"an enabled pair kernel's manifold does not fit "
                         f"in K={k}")


def collide_pairs_plain(feats, ia, ib, valid, k: int, config: EngineConfig):
    """The plain version: ``collide_pair`` on the gathered feature rows with
    every kernel ``_enabled_kernels(config)`` keeps, validity masked by the
    candidates'."""
    points, normals, depths, mvalid = pk._collide_rows(
        pk._gather_rows(feats, ia), pk._gather_rows(feats, ib), k,
        pk._enabled_kernels(config))
    return points, normals, depths, mvalid & valid[..., None]


def collide_pairs(feats: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                  valid: torch.Tensor, k: int, config: EngineConfig):
    """feats (B, N, 11) f32 or f64 (``narrowphase._features``), ia, ib
    (B, CP) int32 and valid (B, CP) bool (``PairCandidates``) → (points
    (B, CP, k, 3), normals (B, CP, k, 3), depths (B, CP, k), valid
    (B, CP, k) bool) of the enabled pair kernels of ``config`` (its exact
    clip too), 1 <= k <= 8."""
    _check(feats, ia, ib, valid, k, config)
    if feats.device.type == "cpu":
        return collide_pairs_plain(feats, ia, ib, valid, k, config)
    if not feats.is_cuda:
        raise ValueError(f"tensors on {feats.device}: expected cpu or cuda")
    b, n, _ = feats.shape
    cp = ia.shape[1]
    dev = feats.device
    points = torch.empty((b, cp, k, 3), dtype=feats.dtype, device=dev)
    normals = torch.empty((b, cp, k, 3), dtype=feats.dtype, device=dev)
    depths = torch.empty((b, cp, k), dtype=feats.dtype, device=dev)
    out_valid = torch.empty((b, cp, k), dtype=torch.bool, device=dev)
    if b == 0 or cp == 0:
        return points, normals, depths, out_valid
    launch = getattr(_library(), _LAUNCHERS[feats.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            feats.data_ptr(), ia.data_ptr(), ib.data_ptr(), valid.data_ptr(),
            points.data_ptr(), normals.data_ptr(), depths.data_ptr(),
            out_valid.data_ptr(), b, n, cp, k, enabled_bits(config),
            int(config.exact_box_clip), stream)
    if err != 0:
        raise RuntimeError(f"collide_pairs kernel launch failed: CUDA error "
                           f"{err}")
    collide_pairs.launches += 1
    return points, normals, depths, out_valid


collide_pairs.launches = 0
