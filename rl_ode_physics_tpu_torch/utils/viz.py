"""Minimal host-side visual debug dump (SURVEY.md §2b raylib row).

The port of ``rl_ode_physics_tpu/utils/viz.py``: one world of a batch
exports to Wavefront OBJ (one file per frame) for inspection in any mesh
viewer — the replacement for the reference's X-key collider-wireframe debug
view (``src/main.c:556-578``). Spheres become UV meshes, boxes oriented
cuboids, capsules two spheres along the capsule's axis.
"""

from __future__ import annotations

import numpy as np

from rl_ode_physics_tpu_torch.core.state import BodyType
from rl_ode_physics_tpu_torch.utils import quat as quat_m


def _uv_sphere(radius, lat=6, lon=8):
    verts, faces = [], []
    for i in range(lat + 1):
        theta = np.pi * i / lat
        for j in range(lon):
            phi = 2 * np.pi * j / lon
            verts.append([radius * np.sin(theta) * np.cos(phi),
                          radius * np.cos(theta),
                          radius * np.sin(theta) * np.sin(phi)])
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            faces.append([a, b, d])
            faces.append([a, d, c])
    return np.array(verts), np.array(faces)


_BOX_V = np.array([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5)
                   for sz in (-0.5, 0.5)])
_BOX_F = np.array([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
])


def dump_obj(state, path: str, include_static: bool = True,
             world: int = 0) -> int:
    """Write every active body of world ``world`` of a batch to an OBJ
    file; returns the number of bodies written."""
    pos = state.pos[world].cpu().numpy()
    rot = quat_m.to_matrix(state.quat[world].cpu()).numpy()
    size = state.size[world].cpu().numpy()
    types = state.body_type[world].cpu().numpy()
    static = state.is_static[world].cpu().numpy()

    lines = ["# rl_ode_physics_tpu_torch debug dump"]
    base = 1
    count = 0
    for i in range(pos.shape[0]):
        t = int(types[i])
        if t == int(BodyType.NULL) or t == int(BodyType.TRIMESH):
            continue
        if not include_static and static[i]:
            continue
        if t == int(BodyType.SPHERE):
            v, f = _uv_sphere(float(size[i, 0]))
        elif t == int(BodyType.BOX):
            v = _BOX_V * size[i]
            f = _BOX_F
        elif t == int(BodyType.CAPSULE):
            rad, length = float(size[i, 0]), float(size[i, 1])
            v, f = _uv_sphere(rad)
            v = np.concatenate([v + [0, 0, -length / 2],
                                v + [0, 0, length / 2]])
            f = np.concatenate([f, f + len(v) // 2])
        else:
            continue
        world_v = v @ rot[i].T + pos[i]
        lines.append(f"o body_{i}_type{t}")
        for p in world_v:
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
        for face in f:
            lines.append(
                f"f {base + face[0]} {base + face[1]} {base + face[2]}")
        base += len(world_v)
        count += 1

    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return count
