"""Port parity, modules scene/obj_loader.py and scene/ply.py (the port's own
numpy copies): load_obj on the JAX test's OBJ text
(tests/test_hull.py::test_obj_loader_feeds_hull_geometry), dump_ply's
bytes equal to the JAX package's for the same inputs (every optional
record), load_ply of binary and ascii files, and a hull built from a
loaded mesh equal in both packages' scenes. Host code on the same numpy
arrays: everything is held exactly."""
import io

import numpy as np
import pytest
import torch

from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene import obj_loader as jobj
from dxk_tpu.scene import ply as jply
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene import obj_loader as tobj
from dxk_tpu_torch.scene import ply as tply

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

CUBE_OBJ = """
# unit cube
v -1 -1 -1
v  1 -1 -1
v  1  1 -1
v -1  1 -1
v -1 -1  1
v  1 -1  1
v  1  1  1
v -1  1  1
f 1 2 3 4
f 5 8 7 6
f 1/1 5/2/3 6//4 2
f 2 6 7 3
f 3 7 8 4
f -8 -5 -1 -4
"""


def test_load_obj_and_hull():
    v, f = tobj.load_obj(io.StringIO(CUBE_OBJ))
    jv, jf = jobj.load_obj(io.StringIO(CUBE_OBJ))
    assert v.shape == (8, 3) and f.shape == (12, 3)
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert v.dtype == np.float32 and f.dtype == np.int32
    # from a list of lines too
    assert np.array_equal(tobj.load_obj(CUBE_OBJ.splitlines())[1], jf)
    with pytest.raises(ValueError):
        tobj.load_obj(["v 0 0 0", "f 1 2 3"])


def _hull_arrays(builder_cls, verts, **fin):
    b = builder_cls()
    hid = b.add_hull_geometry_from_mesh(verts)
    b.add_hull_collider(b.add_body(position=(0, 3.0, 0)), hid)
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (10, 1, 10))
    h = b.finalize(**fin).hulls
    return {k: np.asarray(getattr(h, k) if not isinstance(
        getattr(h, k), torch.Tensor) else getattr(h, k).numpy())
        for k in ("vertices", "vertex_mask", "face_normals",
                  "face_offsets", "face_mask")}


@pytest.mark.parametrize("kw", [{}, dict(uvs=True), dict(normals=True),
                                dict(uvs=True, normals=True)])
def test_dump_ply_bytes_equal(kw):
    rng = np.random.default_rng(3)
    V, F = 37, 50
    pos = rng.normal(size=(V, 3)).astype(np.float32)
    tris = rng.integers(0, V, (F, 3)).astype(np.int32)
    extra = {}
    if kw.get("uvs"):
        extra["uvs"] = rng.uniform(size=(V, 2)).astype(np.float32)
    if kw.get("normals"):
        extra["normals"] = rng.normal(size=(V, 3)).astype(np.float32)
    a, b = io.BytesIO(), io.BytesIO()
    tply.dump_ply(a, pos, tris, color=(10, 200, 30), **extra)
    jply.dump_ply(b, pos, tris, color=(10, 200, 30), **extra)
    assert a.getvalue() == b.getvalue()
    v, f = tply.load_ply(io.BytesIO(a.getvalue()))
    assert np.array_equal(v, pos) and np.array_equal(f, tris)
    jv, jf = jply.load_ply(io.BytesIO(a.getvalue()))
    assert np.array_equal(v, jv) and np.array_equal(f, jf)


def test_load_ply_ascii_and_path(tmp_path):
    text = "\n".join([
        "ply", "format ascii 1.0", "element vertex 5",
        "property float x", "property float y", "property float z",
        "property uchar red", "element face 2",
        "property list uchar int vertex_indices", "end_header",
        "0 0 0 1", "1 0 0 2", "1 1 0 3", "0 1 0 4", "0.5 0.5 1 5",
        "4 0 1 2 3", "3 0 1 4", ""])
    v, f = tply.load_ply(io.BytesIO(text.encode()))
    jv, jf = jply.load_ply(io.BytesIO(text.encode()))
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert f.shape == (3, 3)                     # a quad fans to two
    path = tmp_path / "mesh.ply"
    tply.dump_ply(str(path), v, f)
    v2, f2 = tply.load_ply(str(path))
    assert np.array_equal(v2, v) and np.array_equal(f2, f)
    with pytest.raises(ValueError):
        tply.load_ply(io.BytesIO(b"not a ply"))


def test_hull_from_loaded_mesh_equal():
    """The OBJ cube and a PLY round trip of a seeded point cloud, each
    baked into a hull by both packages' builders: equal tables."""
    v, _f = tobj.load_obj(io.StringIO(CUBE_OBJ))
    rng = np.random.default_rng(8)
    cloud = rng.normal(size=(24, 3)).astype(np.float32)
    buf = io.BytesIO()
    tply.dump_ply(buf, cloud, np.zeros((0, 3), np.int32))
    cloud2, _ = tply.load_ply(io.BytesIO(buf.getvalue()))
    for verts in (v, cloud2):
        got = _hull_arrays(SceneBuilder, verts, device="cpu")
        want = _hull_arrays(JaxSceneBuilder, verts)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
