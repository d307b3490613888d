"""Port parity for the convex-hull modules of the ragdoll-settle slice:
scene/hull_topology.py, the hull parts of scene/builder.py (mass
properties, baking), ops/shapes.py (hull AABBs), and the plain versions of
the fused step's hull recipes: ops/kernels/gjk_distance.py (distance GJK),
cm_hull.py (capsule-hull) and cm_polytope.py (box-hull and hull-hull, SAT
+ clip).

Hulls: the 0.24 m debris cube of bench.py's config 3, the hull of 16
seeded points and the tetrahedron of chip_smoke.py's hull pile. The JAX
recipes run eagerly on 512 seeded lanes (no compiled program); each
recipe's lanes cover misses, shallow and deep contacts, and for the SAT
recipes face-A, face-B and edge winners, each counted and required."""
import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from dxk_tpu.ops.pallas import cm_hull as jch
from dxk_tpu.ops.pallas import cm_polytope as jcp
from dxk_tpu.ops.pallas import gjk_distance as jgjk
from dxk_tpu.ops.shapes import collider_aabbs as jax_aabbs
from dxk_tpu.ops.shapes import world_colliders as jax_world
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene import hull_topology as jtopo
from dxk_tpu_torch.ops import shapes as tshapes
from dxk_tpu_torch.ops.kernels import cm_hull as tch
from dxk_tpu_torch.ops.kernels import cm_polytope as tcp
from dxk_tpu_torch.ops.kernels import gjk_distance as tgjk
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene import hull_topology as ttopo

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

N = 512                    # lanes of the recipe tests
TOL = 1e-5                 # absolute, on points, depths and normals


def _points():
    """The three hulls' input points, as chip_smoke.pile_builder makes them."""
    h = chip_smoke.DEBRIS_HALF
    cube = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                     for z in (-h, h)])
    blob = np.random.default_rng(16).normal(size=(16, 3)) * 0.08
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 0.1
    return {"cube": cube, "blob": blob, "tetra": tet}


def _both_builders():
    """Each hull registered in both builders, with the builders."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    ids = {}
    for name, pts in _points().items():
        ids[name] = (jb.add_hull_geometry_from_mesh(pts),
                     tb.add_hull_geometry_from_mesh(pts))
    return jb, tb, ids


# ---------------------------------------------------------------------------
# topology, mass properties, AABBs


@pytest.mark.parametrize("name", ["cube", "blob", "tetra"])
def test_derive_hull_topology_equal(name):
    """Merged faces, loops and edge directions from the builder's vertices
    and face planes: equal arrays."""
    jb, tb, ids = _both_builders()
    j, t = ids[name]
    want = jtopo.derive_hull_topology(jb._hull_geoms[j], *jb._hull_faces[j])
    got = ttopo.derive_hull_topology(tb._hull_geoms[t], *tb._hull_faces[t])
    assert sorted(got) == sorted(want)
    assert got["loops"] == want["loops"]
    for k in ("poly_normals", "poly_offsets", "edge_dirs"):
        assert np.array_equal(got[k], want[k]), k
    if name == "cube":
        assert len(got["loops"]) == 6 and got["edge_dirs"].shape[0] == 3


def test_bake_topologies_equal():
    """The three hulls padded to common counts: equal arrays."""
    jb, tb, _ids = _both_builders()

    def topos(mod, b):
        out = []
        for v, (n, d) in zip(b._hull_geoms, b._hull_faces):
            t = mod.derive_hull_topology(v, n, d)
            t["vertices"] = v
            out.append(t)
        return mod.bake_topologies(out)
    want, got = topos(jtopo, jb), topos(ttopo, tb)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_hull_mass_properties():
    """Per-density mass, centre of gravity and inertia of each hull (the
    triangle covariance pass) to 1e-6 relative, and the baked bodies of a
    pile whose hulls sit off-centre and turned in their bodies."""
    jb, tb, _ids = _both_builders()
    for (mj, cj, ij), (mt, ct, it) in zip(jb._hull_props, tb._hull_props):
        assert abs(mt - mj) <= 1e-6 * abs(mj)
        assert np.abs(ct - cj).max() <= 1e-6 * max(np.abs(cj).max(), 1e-3)
        assert np.abs(it - ij).max() <= 1e-6 * np.abs(ij).max()
    q = np.array([0.2, -0.3, 0.1, 0.9])
    q /= np.linalg.norm(q)
    scenes = []
    for b in (jb, tb):
        for h in range(3):
            body = b.add_body(position=(h, 1.0, 0.0))
            b.add_hull_collider(body, h, position=(0.05, -0.02, 0.01),
                                rotation=q, density=700.0 + 100.0 * h)
        scenes.append(b.finalize() if b is jb else b.finalize(device="cpu"))
    jp, tp = scenes[0].body_params, scenes[1].body_params
    for f in ("inv_mass", "inv_inertia", "local_cog"):
        want = np.asarray(getattr(jp, f), np.float64)
        got = getattr(tp, f).numpy().astype(np.float64)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f


def test_collider_aabbs_with_hulls():
    """World AABBs of the hull pile (box ground, three hulls) on seeded
    poses: the rotated padded vertices' masked min/max, to 1e-6."""
    tscene = chip_smoke.pile_scene("cpu")
    jscene = chip_smoke.pile_builder(JaxSceneBuilder).finalize()
    st = chip_smoke.pile_poses(tscene, 4, seed=3)
    w = tshapes.world_colliders(tscene, st.pos, st.rot)
    mn, mx = tshapes.collider_aabbs(tscene, w)
    for e in range(4):
        jw = jax_world(jscene, jnp.asarray(st.pos[e].numpy()),
                       jnp.asarray(st.rot[e].numpy()))
        jmn, jmx = jax_aabbs(jscene, jw)
        assert np.abs(mn[e].numpy() - np.asarray(jmn)).max() <= 1e-6
        assert np.abs(mx[e].numpy() - np.asarray(jmx)).max() <= 1e-6
    assert float((mx - mn)[:, 1:, 1].min()) > 0.1      # the hulls' boxes


# ---------------------------------------------------------------------------
# the recipes on seeded lanes


def _hull_lists(name):
    """A hull's local lists (vertices, triangle planes, merged faces,
    loops, loop lengths, edges) as numpy, padded as in its own scene."""
    b = SceneBuilder()
    b.add_hull_geometry_from_mesh(_points()[name])
    h = b._bake_hulls(np.float32, torch.from_numpy)
    n = lambda x: x[0].numpy()
    return dict(verts=n(h.vertices), fn=n(h.face_normals),
                fo=n(h.face_offsets), fm=n(h.face_mask),
                pn=n(h.poly_normals), pm=n(h.poly_mask), loops=n(h.loop_pts),
                llen=n(h.loop_len), ed=n(h.edge_dirs), em=n(h.edge_mask))


def _lanes(x, lib):
    """Per-lane numpy (N, c) or (N,) -> a c-tuple of lanes, or one lane."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    if x.ndim == 2:
        return tuple(conv(np.ascontiguousarray(x[:, i]))
                     for i in range(x.shape[1]))
    return conv(x)


def _const(x, lib, dtype=None):
    x = np.broadcast_to(np.asarray(x), (N,))
    if lib == "jax":
        return jnp.asarray(np.array(x, dtype=dtype))
    return torch.from_numpy(np.array(x, dtype=dtype))


def _local(h, lib):
    """verts, planes, plane validity, faces, loops, loop lengths, edges as
    the recipes take them, every entry a lane of N."""
    v3 = lambda a: _lanes(np.broadcast_to(a, (N, 3)), lib)
    verts = [v3(v) for v in h["verts"]]
    planes = [(v3(n), _const(np.float32(o), lib))
              for n, o in zip(h["fn"], h["fo"])]
    pvalid = [_const(bool(m), lib) for m in h["fm"]]
    faces = [(v3(n), _const(bool(m), lib)) for n, m in zip(h["pn"], h["pm"])]
    loops = [tuple(v3(p) for p in lp) for lp in h["loops"]]
    llens = [_const(np.int32(n), lib) for n in h["llen"]]
    edges = [(v3(d), _const(bool(m), lib)) for d, m in zip(h["ed"], h["em"])]
    return verts, planes, pvalid, faces, loops, llens, edges


def _rand_quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _world(h, pos, quat, LM, lib):
    """A hull's world-space polytope lists at per-lane poses."""
    verts, _pl, _pv, faces, loops, llens, edges = _local(h, lib)
    loops = [tuple(lp) + (lp[-1],) * (LM - len(lp)) for lp in loops]
    mod = jcp if lib == "jax" else tcp
    return mod.hull_topology_world(_lanes(pos, lib), _lanes(quat, lib), verts,
                                   faces, loops, llens, edges)


def _np(x):
    if isinstance(x, (tuple, list)):
        return np.stack([_np(c) for c in x], -1)
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _differing(got, want, live, tol=TOL):
    """Lanes where a live value differs by more than tol."""
    d = np.abs(_np(got).astype(np.float64) - _np(want))
    if d.ndim > live.ndim:
        d = d.max(axis=-1)
    return np.nonzero(live & ~(d <= tol))[0].tolist()


def _capsules(rng, radius_scale):
    """Capsules around a hull at the origin: midpoints 0-0.25 m away in
    random directions, half-lengths 0.05-0.2 m, radii 0.02-0.07 m."""
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mid = d * rng.uniform(0.0, 0.25, (N, 1)) * radius_scale
    ax = rng.normal(size=(N, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    half = rng.uniform(0.05, 0.2, (N, 1))
    return ((mid - ax * half).astype(np.float32),
            (mid + ax * half).astype(np.float32),
            rng.uniform(0.02, 0.07, N).astype(np.float32))


@pytest.mark.parametrize("name", ["cube", "blob"])
def test_gjk_distance(name):
    """Segment vs hull distance GJK: distance and both witnesses to 1e-5,
    identical overlap flags, on separated and overlapping lanes."""
    h = _hull_lists(name)
    ca, cb, _r = _capsules(np.random.default_rng(1), 1.0)
    out = {}
    for lib, mod, chm in (("jax", jgjk, jch), ("torch", tgjk, tch)):
        verts = _local(h, lib)[0]
        out[lib] = mod.gjk_distance(chm.sup_segment, chm.sup_verts,
                                    (_lanes(ca, lib), _lanes(cb, lib)), verts)
    (jd, jqa, jqb, jo), (td, tqa, tqb, to) = out["jax"], out["torch"]
    assert np.array_equal(_np(to), _np(jo))
    every = np.ones(N, bool)
    for got, want in ((td, jd), (tqa, jqa), (tqb, jqb)):
        bad = _differing(got, want, every)
        assert not bad, f"lanes differ: {bad}"
    n_ov = int(_np(jo).sum())
    assert 0 < n_ov < N, n_ov


@pytest.mark.parametrize("name", ["cube", "blob"])
def test_capsule_hull_core(name):
    """Capsule vs hull (hull-local frame): identical hit masks; point,
    depth and normal of every hit lane to 1e-5; misses, shallow hits
    (distance GJK separated) and deep hits (the face-plane branch) all
    present."""
    h = _hull_lists(name)
    ca, cb, cr = _capsules(np.random.default_rng(2), 1.0)
    out, stats = {}, {}
    for lib, mod in (("jax", jch), ("torch", tch)):
        verts, planes, pvalid = _local(h, lib)[:3]
        args = (_lanes(ca, lib), _lanes(cb, lib), _const(cr, lib), verts,
                planes, pvalid)
        if lib == "torch":
            out[lib] = mod.capsule_hull_core(*args, stats=stats)
        else:
            out[lib] = mod.capsule_hull_core(*args)
    (jp, jdp, jn, jh), (tp, tdp, tn, th) = out["jax"], out["torch"]
    hit = _np(jh)
    assert np.array_equal(_np(th), hit)
    for got, want in ((tp, jp), (tdp, jdp), (tn, jn)):
        bad = _differing(got, want, hit)
        assert not bad, f"lanes differ: {bad}"
    deep = hit & _np(stats["overlap"])
    shallow = hit & ~_np(stats["overlap"])
    assert int((~hit).sum()) and int(deep.sum()) and int(shallow.sum()), (
        int((~hit).sum()), int(shallow.sum()), int(deep.sum()))


def _check_polytope(out, stats):
    """Identical masks; live points, depths and hit normals to 1e-5; misses
    and every SAT winner among the hits."""
    (jp, jd, jn, jm), (tp, td, tn, tm) = out["jax"], out["torch"]
    for k in range(4):
        live = _np(jm[k])
        assert np.array_equal(_np(tm[k]), live), k
        for got, want in ((tp[k], jp[k]), (td[k], jd[k])):
            bad = _differing(got, want, live)
            assert not bad, f"point {k}: lanes differ: {bad}"
    hit = _np(jm[0])
    bad = _differing(tn, jn, hit)
    assert not bad, f"normal: lanes differ: {bad}"
    which = _np(stats["which"])
    counts = [int((hit & (which == w)).sum()) for w in range(3)]
    assert int((~hit).sum()) > 0 and min(counts) > 0, (int((~hit).sum()),
                                                       counts)


def test_box_hull_cm():
    """Box vs the 16-point hull, both at seeded poses 0-0.3 m apart, box
    half-extents 0.03-0.25 m."""
    rng = np.random.default_rng(3)
    h = _hull_lists("blob")
    LM = max(4, h["loops"].shape[1])
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bc = (d * rng.uniform(0.0, 0.3, (N, 1))).astype(np.float32)
    bh = rng.uniform(0.03, 0.25, (N, 3)).astype(np.float32)
    bq, hq = _rand_quats(rng), _rand_quats(rng)
    hp = np.zeros((N, 3), np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jcp), ("torch", tcp)):
        hw = _world(h, hp, hq, LM, lib)
        args = (_lanes(bc, lib), _lanes(bh, lib), _lanes(bq, lib), hw, LM)
        out[lib] = (mod.box_hull_cm(*args, stats=stats) if lib == "torch"
                    else mod.box_hull_cm(*args))
    _check_polytope(out, stats)


def test_hull_hull_cm():
    """The 16-point hull vs the tetrahedron at seeded poses 0-0.25 m
    apart."""
    rng = np.random.default_rng(4)
    ha, hb = _hull_lists("blob"), _hull_lists("tetra")
    LM = max(ha["loops"].shape[1], hb["loops"].shape[1])
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pb = (d * rng.uniform(0.0, 0.25, (N, 1))).astype(np.float32)
    qa, qb = _rand_quats(rng), _rand_quats(rng)
    pa = np.zeros((N, 3), np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jcp), ("torch", tcp)):
        wa = _world(ha, pa, qa, LM, lib)
        wb = _world(hb, pb, qb, LM, lib)
        out[lib] = (mod.hull_hull_cm(wa, wb, stats=stats) if lib == "torch"
                    else mod.hull_hull_cm(wa, wb))
    _check_polytope(out, stats)
