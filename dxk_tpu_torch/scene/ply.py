"""Minimal PLY mesh dump + load for collision/debug assets: the port's own
copy of the JAX package's scene/ply.py (numpy only).

The reference's PLY support is a binary debug-mesh dumper
(src/asset/ply.cpp:8-89, ``testDumpToPLY``: always-on
RGBA vertex colors, optional UVs/normals, ``binary_little_endian``
triangle lists). ``dump_ply`` reproduces that record layout byte-for-byte
so dumps open in the same external viewers; ``load_ply`` reads the subset
this writer emits plus plain ascii PLY, enough to round-trip debug dumps
and feed ``SceneBuilder.add_hull_geometry_from_mesh`` (the physics
consumer, bounding_volumes.cpp:1369-1452).
"""

from __future__ import annotations

import struct

import numpy as np


def dump_ply(path_or_file, positions, triangles, uvs=None, normals=None,
             color=(255, 255, 255)):
    """Write a binary_little_endian PLY like the reference's testDumpToPLY.

    positions (V, 3) float; triangles (F, 3) int; optional uvs (V, 2) and
    normals (V, 3); one flat RGB `color` for every vertex (alpha forced
    255, like the reference). Record layout matches ply.cpp:66-85:
    per-vertex [xyz][uv?][nxnynz?][rgba], per-face uchar 3 + 3x int32."""
    positions = np.asarray(positions, "<f4").reshape(-1, 3)
    triangles = np.asarray(triangles, "<i4").reshape(-1, 3)
    v, f = len(positions), len(triangles)
    uvs = None if uvs is None else np.asarray(uvs, "<f4").reshape(v, 2)
    normals = (None if normals is None
               else np.asarray(normals, "<f4").reshape(v, 3))

    header = ["ply", "format binary_little_endian 1.0",
              "comment scan3d-capture generated",
              f"element vertex {v}",
              "property float x", "property float y", "property float z"]
    if uvs is not None:
        header += ["property float texture_u", "property float texture_v"]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    header += ["property uchar red", "property uchar green",
               "property uchar blue", "property uchar alpha",
               f"element face {f}",
               "property list uchar int vertex_indices", "end_header", ""]

    rgba = struct.pack("<4B", *color, 255)
    out = bytearray("\n".join(header).encode("ascii"))
    for i in range(v):
        out += positions[i].tobytes()
        if uvs is not None:
            out += uvs[i].tobytes()
        if normals is not None:
            out += normals[i].tobytes()
        out += rgba
    for i in range(f):
        out += struct.pack("<B", 3) + triangles[i].tobytes()

    if hasattr(path_or_file, "write"):
        path_or_file.write(bytes(out))
    else:
        with open(path_or_file, "wb") as fh:
            fh.write(bytes(out))


_PROP_SIZE = {"float": 4, "float32": 4, "double": 8, "float64": 8,
              "int": 4, "int32": 4, "uint": 4, "uint32": 4,
              "short": 2, "int16": 2, "ushort": 2, "uint16": 2,
              "char": 1, "int8": 1, "uchar": 1, "uint8": 1}
_PROP_FMT = {"float": "f", "double": "d", "float32": "f", "float64": "d",
             "int": "i", "int32": "i", "uint": "I", "uint32": "I",
             "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
             "char": "b", "int8": "b", "uchar": "B", "uint8": "B"}


def load_ply(path_or_file):
    """Parse ascii or binary_little_endian PLY.

    Returns (vertices (V, 3) float32, faces (F, 3) int32). Extra vertex
    properties (uv/normal/color) are skipped; n-gon faces are
    fan-triangulated like the OBJ loader."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as fh:
            data = fh.read()
    if isinstance(data, str):
        data = data.encode("ascii")

    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError("not a PLY file")
    body = data[data.index(b"\n", end) + 1:]
    header = data[:end].decode("ascii", "replace").splitlines()

    fmt = "ascii"
    elements = []          # [name, count, [(kind, type..) per property]]
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3],
                                        parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")

    verts, faces = [], []

    def fan(idx):
        for k in range(1, len(idx) - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])

    if fmt == "ascii":
        toks = body.decode("ascii", "replace").split()
        pos = 0
        for name, count, props in elements:
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        n = int(float(toks[pos])); pos += 1
                        row.setdefault("_list", []).extend(
                            int(float(toks[pos + i])) for i in range(n))
                        pos += n
                    else:
                        row[p[2]] = float(toks[pos]); pos += 1
                if name == "vertex":
                    verts.append([row.get("x", 0.0), row.get("y", 0.0),
                                  row.get("z", 0.0)])
                elif name == "face" and "_list" in row:
                    fan(row["_list"])
    else:
        off = 0
        for name, count, props in elements:
            for _ in range(count):
                row, lst = {}, None
                for p in props:
                    if p[0] == "list":
                        n = struct.unpack_from(
                            "<" + _PROP_FMT[p[1]], body, off)[0]
                        off += _PROP_SIZE[p[1]]
                        lst = list(struct.unpack_from(
                            f"<{n}" + _PROP_FMT[p[2]], body, off))
                        off += n * _PROP_SIZE[p[2]]
                    else:
                        row[p[2]] = struct.unpack_from(
                            "<" + _PROP_FMT[p[1]], body, off)[0]
                        off += _PROP_SIZE[p[1]]
                if name == "vertex":
                    verts.append([row.get("x", 0.0), row.get("y", 0.0),
                                  row.get("z", 0.0)])
                elif name == "face" and lst is not None:
                    fan(lst)

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("PLY face index out of range")
    return v, f
