"""Sphere-to-triangle distances on the card: the hand-written Hopper kernels.

``csrc/sphere_mesh_d2.cu`` replaces the Pallas TPU kernels of
``rl_ode_physics_tpu/ops/pallas_kernels.py``: ``sphere_mesh_d2_tiles``
(phase 1 of ``ops/trimesh.mesh_narrowphase``, once per substep) and
``sphere_mesh_d2`` (``ops/trimesh.sphere_mesh_contacts``), which takes the
centres of a whole query in one launch: the batch axis that ``jax.vmap``
over the Pallas call adds. Both take float32 or float64 (one template
instance each). The library is built with ``nvcc`` at first use
(``ops/kernel_build.py``).

Each wrapper launches its kernel for CUDA tensors. For CPU tensors, and
only for those, it runs the kernel's plain version in ``ops/trimesh.py``,
which ``chip_smoke.py`` also holds the kernel to on the card, at rtol
``D2_RTOL``, atol ``D2_ATOL``: the kernels fuse multiply-adds and take
their reciprocals once per triangle, so they round otherwise than the
plain versions, and the tile minima feed only the cull of
``ops/trimesh.mesh_narrowphase``, which recomputes every contact from the
candidate triangles. In float64 the same holds at ``D2_RTOL_F64``,
``D2_ATOL_F64``. The ``launches`` attribute of each wrapper counts its
kernel's launches, float32 and float64 alike.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build, trimesh

MESH_TILE = trimesh.MESH_TILE
_MAX_TILES = 65535                  # both kernels' grid.y
# how closely the kernels match their plain versions, in float32 and in
# float64
D2_RTOL, D2_ATOL = 1e-5, 1e-6
D2_RTOL_F64, D2_ATOL_F64 = 1e-12, 1e-13
_SUFFIX = {torch.float32: "", torch.float64: "_f64"}


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("sphere_mesh_d2.cu")


# the library's C interface: launcher → argtypes
FUNCTIONS = {
    f"sphere_mesh_d2_{kind}_launch{suffix}":
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for kind in ("tiles", "batch") for suffix in _SUFFIX.values()}


def tolerance(dtype) -> tuple:
    """(rtol, atol) the kernels are held to their plain versions at."""
    if dtype == torch.float64:
        return D2_RTOL_F64, D2_ATOL_F64
    return D2_RTOL, D2_ATOL


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(points: torch.Tensor, tris) -> int:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    all float32 or all float64, and the triangle planes are (3, T) with T
    a positive multiple of 128; return T."""
    dev = points.device
    if points.dtype not in _SUFFIX:
        raise TypeError(f"expected float32 or float64, got {points.dtype}")
    for x in (points, *tris):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}: the kernel "
                             f"takes CUDA tensors on one device")
        if x.dtype != points.dtype or not x.is_contiguous():
            raise TypeError(f"expected contiguous {points.dtype}, got "
                            f"{x.dtype}")
    t = tris[0].shape[-1]
    for x in tris:
        if x.shape != (3, t):
            raise ValueError(f"triangle planes {tuple(x.shape)}: expected "
                             f"(3, {t})")
    if t == 0 or t % MESH_TILE:
        raise ValueError(f"T={t}: pad the mesh to a multiple of {MESH_TILE}")
    return t


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def sphere_mesh_d2_tiles(probes: torch.Tensor, v0t: torch.Tensor,
                         e1t: torch.Tensor, e2t: torch.Tensor) -> torch.Tensor:
    """(P, 3) probes, (3, T) triangle planes → (P, T/128): each probe's
    minimum squared distance to the triangles of each 128-triangle tile."""
    if _all_cpu(probes, v0t, e1t, e2t):
        return trimesh.sphere_mesh_d2_tiles_plain(probes, v0t, e1t, e2t)
    t = _check(probes, (v0t, e1t, e2t))
    if probes.dim() != 2 or probes.shape[1] != 3 or probes.shape[0] == 0:
        raise ValueError(f"probes {tuple(probes.shape)}: expected (P, 3), "
                         f"P >= 1")
    if t // MESH_TILE > _MAX_TILES:
        raise ValueError(f"{t // MESH_TILE} tiles: at most {_MAX_TILES}")
    p = probes.shape[0]
    out = torch.empty((p, t // MESH_TILE), dtype=probes.dtype,
                      device=probes.device)
    launch = getattr(_library(), "sphere_mesh_d2_tiles_launch"
                     + _SUFFIX[probes.dtype])
    with torch.cuda.device(probes.device):
        stream = torch.cuda.current_stream(probes.device).cuda_stream
        err = launch(
            probes.data_ptr(), v0t.data_ptr(), e1t.data_ptr(),
            e2t.data_ptr(), out.data_ptr(), p, t, stream)
    _raise_on(err, "sphere_mesh_d2_tiles")
    sphere_mesh_d2_tiles.launches += 1
    return out


def sphere_mesh_d2(centers: torch.Tensor, v0t: torch.Tensor,
                   e1t: torch.Tensor, e2t: torch.Tensor) -> torch.Tensor:
    """(C, 3) centres, (3, T) triangle planes → (C, T/128, 128) squared
    distances, one per centre and triangle, in one launch whatever C is; a
    (3,) centre → (T/128, 128)."""
    if _all_cpu(centers, v0t, e1t, e2t):
        return trimesh.sphere_mesh_d2_plain(centers, v0t, e1t, e2t)
    t = _check(centers, (v0t, e1t, e2t))
    single = centers.dim() == 1
    if (centers.dim() > 2 or centers.shape[-1] != 3
            or (not single and centers.shape[0] == 0)):
        raise ValueError(f"centers {tuple(centers.shape)}: expected (3,) or "
                         f"(C, 3), C >= 1")
    if t // MESH_TILE > _MAX_TILES:
        raise ValueError(f"{t // MESH_TILE} tiles: at most {_MAX_TILES}")
    c = 1 if single else centers.shape[0]
    out = torch.empty((c, t // MESH_TILE, MESH_TILE), dtype=centers.dtype,
                      device=centers.device)
    launch = getattr(_library(), "sphere_mesh_d2_batch_launch"
                     + _SUFFIX[centers.dtype])
    with torch.cuda.device(centers.device):
        stream = torch.cuda.current_stream(centers.device).cuda_stream
        err = launch(
            centers.data_ptr(), v0t.data_ptr(), e1t.data_ptr(),
            e2t.data_ptr(), out.data_ptr(), c, t, stream)
    _raise_on(err, "sphere_mesh_d2")
    sphere_mesh_d2.launches += 1
    return out[0] if single else out


sphere_mesh_d2_tiles.launches = 0
sphere_mesh_d2.launches = 0
