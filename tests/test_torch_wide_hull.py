"""Port parity for hulls past the fused kernel's per-thread polytope
buffers (fused_step.MAX_HULL_VERTS = 32 vertices, MAX_HULL_LOOP = 16 loop
points): the hull of 64 points spread over a sphere (64 vertices) and a
24-sided prism (48 vertices, caps of 24 loop points), chip_smoke's
wide_hull_points. The plain versions of the box-hull and hull-hull recipes
(cm_polytope.py) against the JAX package's, run eagerly on seeded lanes,
each wide hull against a box and against a hull (the tetrahedron of the
hull pile; the prism's cases in tests/test_torch_wide_hull_prism.py), at
test_torch_hull.py's tolerance and with its checks: equal masks, live
points, depths and normals to 1e-5, misses and every SAT winner present;
and the cylinder-hull recipe on the 64-vertex hull, with
test_torch_shapes.py's checks. On the card chip_smoke.py's settle phase
holds the kernel, which keeps these hulls' buffers in its hull scratch,
against the plain version on a pile of each (wide_pile_builder), in the
averaged and the sequential solve; the g++ emulation does the same on the
CPU (tools/emulate_fused_step_cpu.py --only settle, and --library prepped
--only-scene wide)."""

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_hull as th
from dxk_tpu.ops.pallas import cm_polytope as jcp
from dxk_tpu_torch.ops.kernels import cm_polytope as tcp
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.scene import SceneBuilder

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). Every port test file spends that first call at import.
torch.sqrt(torch.ones(4096))

N = 128                    # lanes: the JAX recipes' cost here is per op


def _hull_lists(name):
    """A hull's local lists as test_torch_hull._hull_lists gives them."""
    pts = {**th._points(), **chip_smoke.wide_hull_points()}[name]
    b = SceneBuilder()
    b.add_hull_geometry_from_mesh(pts)
    h = b._bake_hulls(np.float32, torch.from_numpy)
    n = lambda x: x[0].numpy()
    return dict(verts=n(h.vertices), fn=n(h.face_normals),
                fo=n(h.face_offsets), fm=n(h.face_mask),
                pn=n(h.poly_normals), pm=n(h.poly_mask), loops=n(h.loop_pts),
                llen=n(h.loop_len), ed=n(h.edge_dirs), em=n(h.edge_mask))


@pytest.fixture(autouse=True)
def _lanes(monkeypatch):
    monkeypatch.setattr(th, "N", N)


def _poses(rng, reach):
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * rng.uniform(0.0, reach, (N, 1))).astype(np.float32)


def test_wide_hulls_exceed_the_per_thread_buffers():
    """The cloud's hull keeps all 64 points as vertices, the prism's caps
    are loops of 24 points; a scene of them takes the hull scratch."""
    cloud, prism = _hull_lists("cloud64"), _hull_lists("prism24")
    assert cloud["verts"].shape[0] == 64 > fs.MAX_HULL_VERTS
    assert int(prism["llen"].max()) == 24 > fs.MAX_HULL_LOOP
    tab = fs.FusedTables(chip_smoke.wide_pile_scene("cloud64", "cpu"), "cpu")
    assert tab.hull_dims[0] == 64 and tab.hull_dims[3] == 3
    assert fs.hull_lane_floats(tab) == 6 * 64 + 16 * 4
    assert fs.hull_scratch_shape(tab, 256, 8) == (256, tab.num_rows, 448)
    tab = fs.FusedTables(chip_smoke.wide_pile_scene("prism24", "cpu"), "cpu")
    assert tab.hull_dims[0] == 48 and tab.hull_dims[3] == 24
    assert fs.hull_scratch_shape(tab, 4096, 1) == (4096, tab.num_rows,
                                                   6 * 48 + 16 * 24)
    tab = fs.FusedTables(chip_smoke.wide_pile_scene("cloud64_cylinder",
                                                    "cpu"), "cpu")
    assert tab.has_shapes and tab.hull_dims[0] == 64
    assert fs.hull_scratch_shape(tab, 256, 8) == (256, tab.num_rows, 448)
    assert fs.hull_scratch_shape(
        fs.FusedTables(chip_smoke.pile_scene("cpu"), "cpu"), 256) is None


# the prism's cases are tests/test_torch_wide_hull_prism.py: each of its
# recipes' clips runs 24 loop points over 48 slots, op by op in JAX
@pytest.mark.parametrize("name", ["cloud64"])
def test_box_wide_hull_cm(name):
    """A box (half-extents 0.01-0.06 m, small enough for the hull's faces
    to win too) against the wide hull, 0-0.2 m apart at seeded poses."""
    rng = np.random.default_rng(5)
    h = _hull_lists(name)
    LM = max(4, h["loops"].shape[1])
    bc = _poses(rng, 0.2)
    bh = rng.uniform(0.01, 0.06, (N, 3)).astype(np.float32)
    bq, hq = th._rand_quats(rng, N), th._rand_quats(rng, N)
    hp = np.zeros((N, 3), np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jcp), ("torch", tcp)):
        hw = th._world(h, hp, hq, LM, lib)
        args = (th._lanes(bc, lib), th._lanes(bh, lib), th._lanes(bq, lib),
                hw, LM)
        out[lib] = (mod.box_hull_cm(*args, stats=stats) if lib == "torch"
                    else mod.box_hull_cm(*args))
    th._check_polytope(out, stats)


@pytest.mark.parametrize("pair", [("cloud64", "tetra")])
def test_wide_hull_hull_cm(pair):
    """The wide hull against the tetrahedron, as side A and as side B,
    0-0.25 m apart at seeded poses."""
    rng = np.random.default_rng(6)
    ha, hb = (_hull_lists(n) for n in pair)
    LM = max(ha["loops"].shape[1], hb["loops"].shape[1])
    pb = _poses(rng, 0.25)
    qa, qb = th._rand_quats(rng, N), th._rand_quats(rng, N)
    pa = np.zeros((N, 3), np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jcp), ("torch", tcp)):
        wa = th._world(ha, pa, qa, LM, lib)
        wb = th._world(hb, pb, qb, LM, lib)
        out[lib] = (mod.hull_hull_cm(wa, wb, stats=stats) if lib == "torch"
                    else mod.hull_hull_cm(wa, wb))
    th._check_polytope(out, stats)


def test_cylinder_wide_hull_cm(monkeypatch):
    """A cylinder (the cloud64_cylinder pile's pair) against the 64-vertex
    hull, 0-0.25 m apart at seeded poses and axes: identical hit masks, the
    contact of every hit lane within test_torch_shapes' TOL, lanes the
    distance gate finds touching and separated, hits and misses present."""
    import test_torch_shapes as ts
    monkeypatch.setattr(ts, "N", N)
    rng = np.random.default_rng(8)
    h = _hull_lists("cloud64")
    hl = rng.uniform(0.03, 0.1, N)
    cr = rng.uniform(0.04, 0.1, N).astype(np.float32)
    ax = ts._unit(rng, N)
    c = ts._unit(rng, N) * rng.uniform(0.0, 0.25, (N, 1))
    ca = (c - ax * hl[:, None]).astype(np.float32)
    cb = (c + ax * hl[:, None]).astype(np.float32)
    hq = ts._quats(rng, N)
    hp = np.zeros((N, 3), np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jcp), ("torch", tcp)):
        verts, _pl, _pv, faces, loops, llens, edges = ts._local(h, lib)
        hw = mod.hull_topology_world(ts._lanes(hp, lib), ts._lanes(hq, lib),
                                     verts, faces, loops, llens, edges)
        args = (ts._lanes(ca, lib), ts._lanes(cb, lib), ts._const(cr, lib),
                hw)
        out[lib] = (mod.cylinder_hull_cm(*args, stats=stats)
                    if lib == "torch" else mod.cylinder_hull_cm(*args))
    hit = ts._check_k(out["jax"], out["torch"])[:, 0]
    gate = ts._np(stats["gate"])
    counts = (int(gate.sum()), int((~gate).sum()), int(hit.sum()),
              int((~hit).sum()))
    assert min(counts) > 0, counts
