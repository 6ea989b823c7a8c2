"""Sphere-to-triangle distances on the card: the hand-written Hopper kernels.

``csrc/sphere_mesh_d2.cu`` replaces the Pallas TPU kernels of
``rl_ode_physics_tpu/ops/pallas_kernels.py``: ``sphere_mesh_d2_tiles``
(phase 1 of ``ops/trimesh.mesh_narrowphase``, once per substep) and
``sphere_mesh_d2`` (``ops/trimesh.sphere_mesh_contacts``). The library is
built with ``nvcc`` at first use (``ops/kernel_build.py``).

Each wrapper launches its kernel for CUDA tensors. For CPU tensors, and
only for those, it runs the kernel's plain version in ``ops/trimesh.py``,
which ``chip_smoke.py`` also holds the kernel to on the card, at rtol
``D2_RTOL``, atol ``D2_ATOL``: the kernels fuse multiply-adds and take
their reciprocals once per triangle, so they round otherwise than the
plain versions, and the tile minima feed only the cull of
``ops/trimesh.mesh_narrowphase``, which recomputes every contact from the
candidate triangles. The ``launches`` attribute of each wrapper counts its
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rl_ode_physics_tpu_torch.ops import kernel_build, trimesh

MESH_TILE = trimesh.MESH_TILE
_MAX_TILES = 65535                  # the tile kernel's grid.y
# how closely the kernels match their plain versions
D2_RTOL, D2_ATOL = 1e-5, 1e-6


def build():
    """Compile the kernel library (once per source version) and return its
    path."""
    return kernel_build.build("sphere_mesh_d2.cu")


# the library's C interface: launcher → argtypes
FUNCTIONS = {
    "sphere_mesh_d2_tiles_launch":
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "sphere_mesh_d2_launch":
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return kernel_build.load(build(), FUNCTIONS)


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(points: torch.Tensor, tris) -> int:
    """Raise unless every tensor is a contiguous f32 CUDA tensor on one
    device and the triangle planes are (3, T) with T a positive multiple
    of 128; return T."""
    dev = points.device
    for x in (points, *tris):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}: the kernel "
                             f"takes CUDA tensors on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"expected contiguous float32, got {x.dtype}")
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
    out = torch.empty((p, t // MESH_TILE), dtype=torch.float32,
                      device=probes.device)
    with torch.cuda.device(probes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().sphere_mesh_d2_tiles_launch(
            probes.data_ptr(), v0t.data_ptr(), e1t.data_ptr(),
            e2t.data_ptr(), out.data_ptr(), p, t, stream)
    _raise_on(err, "sphere_mesh_d2_tiles")
    sphere_mesh_d2_tiles.launches += 1
    return out


def sphere_mesh_d2(center: torch.Tensor, v0t: torch.Tensor, e1t: torch.Tensor,
                   e2t: torch.Tensor) -> torch.Tensor:
    """(3,) center, (3, T) triangle planes → (T/128, 128) squared
    distances, one per triangle."""
    if _all_cpu(center, v0t, e1t, e2t):
        return trimesh.sphere_mesh_d2_plain(center, v0t, e1t, e2t)
    t = _check(center, (v0t, e1t, e2t))
    if center.shape != (3,):
        raise ValueError(f"center {tuple(center.shape)}: expected (3,)")
    out = torch.empty((t // MESH_TILE, MESH_TILE), dtype=torch.float32,
                      device=center.device)
    with torch.cuda.device(center.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().sphere_mesh_d2_launch(
            center.data_ptr(), v0t.data_ptr(), e1t.data_ptr(),
            e2t.data_ptr(), out.data_ptr(), t, stream)
    _raise_on(err, "sphere_mesh_d2")
    sphere_mesh_d2.launches += 1
    return out


sphere_mesh_d2_tiles.launches = 0
sphere_mesh_d2.launches = 0
