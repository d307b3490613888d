"""Minimal Wavefront OBJ mesh loading for collision assets: the port's own
copy of the JAX package's scene/obj_loader.py (numpy only).

The reference ships full FBX/OBJ/PLY asset importers (src/asset/*, ~5k
LoC) feeding the renderer; the only physics-relevant consumer is convex
hull generation from mesh vertices (bounding_hull_geometry::fromMesh,
bounding_volumes.cpp:1369-1452). This loader covers that slice: vertices
+ triangulated faces from OBJ text (the reference's OBJ path,
asset/obj.cpp, reads the same v/f records), enough to feed
SceneBuilder.add_hull_geometry_from_mesh and the debug renderer.
"""

from __future__ import annotations

import numpy as np


def load_obj(path_or_lines):
    """Parse an OBJ file (path, file object, or iterable of lines).

    Returns (vertices (V, 3) float32, faces (F, 3) int32): `v` records in
    file order; `f` records fan-triangulated (an n-gon becomes n-2 tris,
    same as the reference importer), 0-based, negative indices resolved
    OBJ-style (relative to the vertices seen so far). Normals/UVs/
    materials are render-only and skipped."""
    if isinstance(path_or_lines, (str, bytes)):
        with open(path_or_lines, "r", errors="replace") as f:
            lines = f.readlines()
    elif hasattr(path_or_lines, "read"):
        lines = path_or_lines.readlines()
    else:
        lines = list(path_or_lines)

    verts = []
    faces = []
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]),
                          float(parts[3])])
        elif parts[0] == "f" and len(parts) >= 4:
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):       # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("OBJ face index out of range")
    return v, f
