"""Host-side convex-hull topology derivation for the SAT/clip contact
paths (ops/kernels/cm_polytope.py and the hull recipes of
ops/kernels/csrc/fused_step.cu). numpy only; a copy of the JAX package's
scene/hull_topology.py with the same tolerances.

The reference stores triangulated hull faces plus half-edge adjacency
(bounding_volumes.h:196-231, fromMesh bounding_volumes.cpp:1369-1452) and
resolves hull contacts at runtime with GJK+EPA. This package instead
resolves polytope contacts with an exact SAT over {face normals of A,
face normals of B, edge-direction cross products} followed by
reference-face clipping — which needs, per hull, the MERGED (coplanar
triangles unified) polygon faces with ordered vertex loops, and the set
of unique edge directions. Those are static per hull geometry, so they
are derived here once at scene-build time (numpy) and baked into
HullGeometry as padded arrays.
"""

from __future__ import annotations

import numpy as np

# tolerances for merging coplanar triangles / deduping edge directions
_NORMAL_TOL = 1e-6
_OFFSET_TOL = 1e-6


def derive_hull_topology(vertices: np.ndarray, face_normals: np.ndarray,
                         face_offsets: np.ndarray):
    """vertices (V, 3); face_normals (F, 3) outward unit; face_offsets (F,)
    in n.x + d = 0 form (possibly one entry per triangle — coplanar
    duplicates are merged here, and each merged face collects ALL hull
    vertices lying on its plane, so triangle indices are not needed).

    Returns dict with:
      poly_normals (FU, 3)  unique outward face normals
      poly_offsets (FU,)    plane d per unique face
      loops        list[FU] of ordered vertex-index lists (CCW around the
                    outward normal)
      edge_dirs    (EU, 3)  unique edge directions (sign-deduped, unit)
    """
    verts = np.asarray(vertices, np.float64)
    fn = np.asarray(face_normals, np.float64)
    fo = np.asarray(face_offsets, np.float64)
    scale = float(np.max(np.abs(verts))) + 1.0

    # --- merge coplanar planes, collect on-plane vertices -------------------
    groups = []          # list of (normal, offset, set(vertex ids))
    for t in range(fn.shape[0]):
        n, d = fn[t], float(fo[t])
        if not any(np.dot(g[0], n) > 1.0 - _NORMAL_TOL
                   and abs(g[1] - d) < _OFFSET_TOL * scale for g in groups):
            on = np.abs(verts @ n + d) < _OFFSET_TOL * scale
            groups.append((n.copy(), d, set(np.nonzero(on)[0].tolist())))

    poly_normals, poly_offsets, loops = [], [], []
    for n, d, vids in groups:
        ids = np.asarray(sorted(vids), np.int64)
        pts = verts[ids]
        centroid = pts.mean(axis=0)
        # tangent frame; CCW ordering around the OUTWARD normal
        t1 = np.cross(n, [1.0, 0.0, 0.0])
        if np.dot(t1, t1) < 1e-12:
            t1 = np.cross(n, [0.0, 1.0, 0.0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        rel = pts - centroid
        ang = np.arctan2(rel @ t2, rel @ t1)
        order = np.argsort(ang)
        poly_normals.append(n)
        poly_offsets.append(d)
        loops.append(ids[order].tolist())

    # --- unique edge directions (from polygon boundaries) ------------------
    dirs = []
    for loop in loops:
        for i in range(len(loop)):
            a, b = loop[i], loop[(i + 1) % len(loop)]
            e = verts[b] - verts[a]
            ln = np.linalg.norm(e)
            if ln < 1e-12:
                continue
            e = e / ln
            if not any(abs(np.dot(e, d0)) > 1.0 - _NORMAL_TOL for d0 in dirs):
                dirs.append(e)
    edge_dirs = (np.stack(dirs, axis=0) if dirs
                 else np.zeros((1, 3), np.float64))

    return dict(poly_normals=np.stack(poly_normals, axis=0),
                poly_offsets=np.asarray(poly_offsets, np.float64),
                loops=loops, edge_dirs=edge_dirs)


def bake_topologies(topos, dtype=np.float32):
    """Pad a list of per-hull topology dicts to common capacities.

    Returns dict of arrays: poly_normals (H, FU, 3), poly_offsets (H, FU),
    poly_mask (H, FU), loop_pts (H, FU, LM, 3) — loop vertex POSITIONS
    (padded by repeating the last point), loop_len (H, FU) int32,
    edge_dirs (H, EU, 3), edge_mask (H, EU). `topos` items must also carry
    "vertices" (the hull's local vertex array) for loop_pts extraction.
    """
    H = len(topos)
    FU = max(max(t["poly_normals"].shape[0] for t in topos), 1)
    LM = max(max((len(l) for l in t["loops"]), default=1) for t in topos)
    EU = max(t["edge_dirs"].shape[0] for t in topos)
    poly_normals = np.zeros((H, FU, 3), dtype)
    poly_offsets = np.zeros((H, FU), dtype)
    poly_mask = np.zeros((H, FU), bool)
    loop_pts = np.zeros((H, FU, LM, 3), dtype)
    loop_len = np.zeros((H, FU), np.int32)
    edge_dirs = np.zeros((H, EU, 3), dtype)
    edge_mask = np.zeros((H, EU), bool)
    for i, t in enumerate(topos):
        verts = np.asarray(t["vertices"], np.float64)
        F = t["poly_normals"].shape[0]
        poly_normals[i, :F] = t["poly_normals"]
        poly_offsets[i, :F] = t["poly_offsets"]
        poly_mask[i, :F] = True
        for f, loop in enumerate(t["loops"]):
            pts = verts[np.asarray(loop, np.int64)]
            loop_pts[i, f, :len(loop)] = pts
            loop_pts[i, f, len(loop):] = pts[-1]
            loop_len[i, f] = len(loop)
        # padded face slots: repeat the first vertex so the (masked-out)
        # slots still hold finite data
        for f in range(F, FU):
            loop_pts[i, f, :] = verts[0] if len(verts) else 0.0
        E = t["edge_dirs"].shape[0]
        edge_dirs[i, :E] = t["edge_dirs"]
        edge_mask[i, :E] = True
    return dict(poly_normals=poly_normals, poly_offsets=poly_offsets,
                poly_mask=poly_mask, loop_pts=loop_pts, loop_len=loop_len,
                edge_dirs=edge_dirs, edge_mask=edge_mask)
