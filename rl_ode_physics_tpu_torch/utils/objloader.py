"""Minimal Wavefront OBJ loader (host-side, numpy).

The port's own copy of ``rl_ode_physics_tpu/utils/objloader.py``: it reads
a mesh asset such as the reference's ``res/teapot.obj`` for
``ops.trimesh.build_trimesh``. It supports ``v`` and ``f`` records; faces
with more than 3 vertices are fan-triangulated; negative indices and
``v/vt/vn`` forms are handled.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """→ (vertices (V, 3) float32, triangles (T, 3) int32)."""
    verts = []
    tris = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    s = tok.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):   # fan triangulation
                    tris.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(tris, np.int32))
