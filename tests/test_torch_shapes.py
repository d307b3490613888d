"""Port parity for the sphere and cylinder slice: the cylinder parts of
scene/builder.py (colliders, mass properties), ops/shapes.py (cylinder
AABBs), the plain versions of the nine sphere and cylinder recipes of the
fused step (cm_narrowphase.py, cm_hull.sphere_hull_core,
cm_polytope.cylinder_hull_cm), and the plain version of the fused step on
the golden mixed-shape drop, the golden sphere bounce and chip_smoke.py's
sphere and cylinder check pile, against the JAX package.

The JAX recipes run eagerly on 512 seeded lanes each (no compiled program);
the lanes cover the cases of the JAX package's own tests of these recipes:
cap rings, lying tubes, tilted single points and rim overlaps of the
cylinder recipes, spheres inside and outside a hull, and the cylinder-hull
distance-GJK gate both ways, each counted and required. The scenes are
chip_smoke.py's copies, so the scenes the card runs are the ones held
against the JAX package here. The JAX fused step runs unbatched and
eagerly for one env, as in tests/test_torch_settle.py (a compiled JAX step
of a scene with hull and cylinder rows takes minutes to build on the
CPU), here op by op under jax.disable_jit(), which gives the same values
with less dispatch cost (about 15-25 s a step of the mixed drop or the
pile on the CPU)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.ops.pallas import cm_hull as jch
from dxk_tpu.ops.pallas import cm_narrowphase as jcm
from dxk_tpu.ops.pallas import cm_polytope as jcp
from dxk_tpu.ops.shapes import collider_aabbs as jax_aabbs
from dxk_tpu.ops.shapes import world_colliders as jax_world
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.ops import shapes as tshapes
from dxk_tpu_torch.ops.kernels import cm_hull as tch
from dxk_tpu_torch.ops.kernels import cm_narrowphase as tcm
from dxk_tpu_torch.ops.kernels import cm_polytope as tcp
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

N = 512                    # lanes of the recipe tests
TOL = 1e-5                 # absolute, on points, depths and normals
ITERS = 10
DT = 1.0 / 120.0
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


# ---------------------------------------------------------------------------
# lanes


def _lanes(x, lib):
    """Per-lane numpy (N, c) or (N,) -> a c-tuple of lanes, or one lane."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    if x.ndim == 2:
        return tuple(conv(np.ascontiguousarray(x[:, i]))
                     for i in range(x.shape[1]))
    return conv(x)


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


def _unit(rng, n=N):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _run_both(name, args, stats=None):
    """The JAX recipe and the port's on the same numpy lanes `args`."""
    out = {}
    for lib, mod in (("jax", jcm), ("torch", tcm)):
        a = [_lanes(x, lib) for x in args]
        if lib == "torch" and stats is not None:
            out[lib] = getattr(mod, name)(*a, stats=stats)
        else:
            out[lib] = getattr(mod, name)(*a)
    return out["jax"], out["torch"]


def _check_one(jout, tout):
    """A one-point recipe: identical hit masks; point, depth and normal of
    every hit lane within TOL. Returns the hit mask."""
    (jp, jd, jn, jh), (tp, td, tn, th) = jout, tout
    hit = _np(jh)
    assert np.array_equal(_np(th), hit)
    for got, want in ((tp, jp), (td, jd), (tn, jn)):
        bad = _differing(got, want, hit)
        assert not bad, f"lanes differ: {bad}"
    return hit


def _check_k(jout, tout):
    """A K-point recipe: identical masks point by point; live points and
    depths, and the normal of lanes with point 0 live, within TOL. Returns
    the masks (N, K)."""
    (jp, jd, jn, jm), (tp, td, tn, tm) = jout, tout
    for k in range(len(jm)):
        live = _np(jm[k])
        assert np.array_equal(_np(tm[k]), live), k
        for got, want in ((tp[k], jp[k]), (td[k], jd[k])):
            bad = _differing(got, want, live)
            assert not bad, f"point {k}: lanes differ: {bad}"
    bad = _differing(tn, jn, _np(jm[0]))
    assert not bad, f"normal: lanes differ: {bad}"
    return np.stack([_np(m) for m in jm], 1)


# ---------------------------------------------------------------------------
# the sphere recipes


def _spheres_and_segments(rng):
    """The JAX package's lane ranges (tests/test_cm_narrowphase.py:122-160):
    centres in [-1, 1]^3, segments up to 1.2 m per axis, radii 0.1-0.7."""
    sc = rng.uniform(-1, 1, (N, 3))
    sr = rng.uniform(0.1, 0.7, N)
    ca = rng.uniform(-1, 1, (N, 3))
    cb = ca + rng.uniform(-1.2, 1.2, (N, 3))
    cr = rng.uniform(0.1, 0.5, N)
    return sc, sr, ca, cb, cr


def test_sphere_sphere_cm():
    rng = np.random.default_rng(21)
    c1, c2 = rng.uniform(-1, 1, (N, 3)), rng.uniform(-1, 1, (N, 3))
    r1, r2 = rng.uniform(0.1, 0.8, N), rng.uniform(0.1, 0.8, N)
    c2[:8] = c1[:8]                  # coincident centres: the +Y fallback
    hit = _check_one(*_run_both("sphere_sphere_cm", (c1, r1, c2, r2)))
    assert 0 < hit.sum() < N


def test_sphere_capsule_cm():
    sc, sr, ca, cb, cr = _spheres_and_segments(np.random.default_rng(22))
    hit = _check_one(*_run_both("sphere_capsule_cm", (sc, sr, ca, cb, cr)))
    assert 0 < hit.sum() < N


def test_sphere_cylinder_cm():
    """Lateral hits (the sphere beside the body) and cap hits (beyond an
    end) both present."""
    sc, sr, ca, cb, cr = _spheres_and_segments(np.random.default_rng(23))
    hit = _check_one(*_run_both("sphere_cylinder_cm", (sc, sr, ca, cb, cr)))
    ab = cb - ca
    t = np.einsum("ij,ij->i", sc - ca, ab) / np.einsum("ij,ij->i", ab, ab)
    lateral = (t >= 0) & (t <= 1)
    assert (hit & lateral).sum() > 0 and (hit & ~lateral).sum() > 0


def test_sphere_box_cm():
    """Rotated boxes; centres outside and inside the box both hit."""
    rng = np.random.default_rng(24)
    sc, sr = rng.uniform(-1, 1, (N, 3)), rng.uniform(0.1, 0.7, N)
    bc, bh = rng.uniform(-0.5, 0.5, (N, 3)), rng.uniform(0.2, 1.0, (N, 3))
    bq = _quats(rng)
    (jp, jd, jn, jh), tout = _run_both("sphere_box_cm", (sc, sr, bc, bh, bq))
    hit = _check_one((jp, jd, jn, jh), tout)
    deep = _np(jd) > sr
    assert (hit & deep).sum() > 0 and (hit & ~deep).sum() > 0


def _hull_lists(points):
    """A hull's local lists (vertices, triangle planes, merged faces, loops,
    loop lengths, edges) as numpy, padded as in its own scene."""
    b = SceneBuilder()
    b.add_hull_geometry_from_mesh(points)
    h = b._bake_hulls(np.float32, torch.from_numpy)
    n = lambda x: x[0].numpy()
    return dict(verts=n(h.vertices), fn=n(h.face_normals),
                fo=n(h.face_offsets), fm=n(h.face_mask),
                pn=n(h.poly_normals), pm=n(h.poly_mask), loops=n(h.loop_pts),
                llen=n(h.loop_len), ed=n(h.edge_dirs), em=n(h.edge_mask))


def _const(x, lib, dtype=None):
    x = np.broadcast_to(np.asarray(x), (N,))
    if lib == "jax":
        return jnp.asarray(np.array(x, dtype=dtype))
    return torch.from_numpy(np.array(x, dtype=dtype))


def _local(h, lib):
    """Local hull lists as the recipes take them, every entry a lane of N."""
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


def test_sphere_hull_core():
    """Spheres around the golden hull (hull-local frame): misses, centres
    outside the hull (the distance GJK's shallow case) and inside it (the
    face-plane branch) all present."""
    h = _hull_lists(chip_smoke.GOLDEN_HULL)
    rng = np.random.default_rng(25)
    sc = (_unit(rng) * rng.uniform(0.0, 0.6, (N, 1))).astype(np.float32)
    sr = rng.uniform(0.02, 0.25, N).astype(np.float32)
    out, stats = {}, {}
    for lib, mod in (("jax", jch), ("torch", tch)):
        verts, planes, pvalid = _local(h, lib)[:3]
        args = (_lanes(sc, lib), _const(sr, lib), verts, planes, pvalid)
        out[lib] = (mod.sphere_hull_core(*args, stats=stats)
                    if lib == "torch" else mod.sphere_hull_core(*args))
    hit = _check_one(out["jax"], out["torch"])
    inside = _np(stats["overlap"])
    counts = (int((~hit).sum()), int((hit & ~inside).sum()),
              int((hit & inside).sum()))
    assert min(counts) > 0, counts


# ---------------------------------------------------------------------------
# the cylinder recipes


def test_capsule_cylinder_cm():
    """The JAX package's lanes (tests/test_cm_narrowphase.py:143-170):
    random pairs, 64 exactly parallel and 32 exactly antiparallel."""
    rng = np.random.default_rng(26)
    aa = rng.uniform(-1, 1, (N, 3))
    ab = aa + rng.uniform(-1.2, 1.2, (N, 3))
    ba = rng.uniform(-1, 1, (N, 3))
    bb = ba + rng.uniform(-1.2, 1.2, (N, 3))
    ar, br = rng.uniform(0.1, 0.6, N), rng.uniform(0.1, 0.6, N)
    bb[:64] = ba[:64] + (ab[:64] - aa[:64])
    bb[64:96] = ba[64:96] - (ab[64:96] - aa[64:96])
    m = _check_k(*_run_both("capsule_cylinder_cm", (aa, ab, ar, ba, bb, br)))
    assert m[:, 1].sum() > 0 and (m[:, 0] & ~m[:, 1]).sum() > 0


def _branch_counts(stats, masks):
    br = _np(stats["branch"])
    hit = masks[:, 0]
    return {k: int((hit & (br == i)).sum())
            for i, k in enumerate(("ring", "tube", "single"))}


def _tilt(rng, n, hi_deg, lo_deg=0.0):
    """Unit axes `lo_deg`-`hi_deg` degrees off +Y."""
    th = np.radians(rng.uniform(lo_deg, hi_deg, n))
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], 1)


def test_cylinder_box_cm():
    """Lanes in four groups of 128 (tests/test_cap_manifolds.py:46,
    tests/test_fused_solver.py:300-318): cylinders upright on a box's top
    face (cap ring), lying on it (tube clip), tilted 20-40 degrees onto it
    (single point), and random pairs at random rotations."""
    rng = np.random.default_rng(27)
    q = N // 4
    bc = np.zeros((N, 3))
    bh = np.tile([2.0, 0.5, 2.0], (N, 1))
    bq = np.tile([0.0, 0.0, 0.0, 1.0], (N, 1))
    r = rng.uniform(0.2, 0.5, N)
    hl = rng.uniform(0.2, 0.7, N)
    pen = rng.uniform(-0.01, 0.02, N)
    axis = np.zeros((N, 3))
    axis[:q] = _tilt(rng, q, 0.3)                             # upright
    lie = _unit(rng, q)
    lie[:, 1] = rng.normal(0, 0.002, q)
    axis[q:2 * q] = lie / np.linalg.norm(lie, axis=1, keepdims=True)
    axis[2 * q:3 * q] = _tilt(rng, q, 40.0, 20.0)
    c = np.zeros((N, 3))
    c[:, 0], c[:, 2] = rng.uniform(-1, 1, N), rng.uniform(-1, 1, N)
    low = hl * np.abs(axis[:, 1]) + r * np.sqrt(np.clip(1 - axis[:, 1] ** 2,
                                                        0, 1))
    c[:, 1] = 0.5 + low - pen
    c[3 * q:] = rng.uniform(-2.5, 2.5, (q, 3))
    axis[3 * q:] = _unit(rng, q)
    bh[3 * q:] = rng.uniform(0.2, 1.0, (q, 3))
    bq[3 * q:] = _quats(rng, q)
    aa, ab = c - axis * hl[:, None], c + axis * hl[:, None]
    stats = {}
    masks = _check_k(*_run_both("cylinder_box_cm", (aa, ab, r, bc, bh, bq),
                                stats))
    counts = _branch_counts(stats, masks)
    assert min(counts.values()) > 0 and (~masks[:, 0]).sum() > 0, counts


def test_cylinder_cylinder_cm():
    """Lanes in four groups of 128 (tests/test_cap_manifolds.py:16, :30,
    tests/test_fused_solver.py:321-345): coaxial stacks a few millimetres
    into each other (cap ring), side by side parallel with the rims
    overlapping (tube pair), crossing at random angles (single point), and
    random pairs."""
    rng = np.random.default_rng(28)
    q = N // 4
    ra, rb = rng.uniform(0.3, 0.5, N), rng.uniform(0.2, 0.4, N)
    la, lb = rng.uniform(0.6, 1.2, N), rng.uniform(0.6, 1.2, N)
    ax = _tilt(rng, N, 0.3)
    aa = np.zeros((N, 3))
    ab = aa + ax * la[:, None]
    pen = rng.uniform(-0.005, 0.02, N)
    off = rng.uniform(-0.1, 0.1, (N, 3)) * np.array([1, 0, 1])
    ba = ab - ax * pen[:, None] + off                          # stacked
    bb = ba + ax * lb[:, None]
    # side by side: the rims overlap by pen (a mostly lateral overlap)
    side = _unit(rng, q) * np.array([1, 0, 1])
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    s = slice(q, 2 * q)
    ba[s] = (side * (ra[s] + rb[s] - pen[s])[:, None]
             + ax[s] * rng.uniform(-0.2, 0.2, (q, 1)))
    bb[s] = ba[s] + ax[s] * lb[s, None]
    # crossing: b's axis horizontal, resting across a's top
    s = slice(2 * q, 3 * q)
    cross_ax = _unit(rng, q) * np.array([1, 0, 1])
    cross_ax /= np.linalg.norm(cross_ax, axis=1, keepdims=True)
    mid = ab[s] + np.array([0, 1, 0]) * (rb[s] - pen[s])[:, None] \
        + rng.uniform(-0.1, 0.1, (q, 3)) * np.array([1, 0, 1])
    ba[s] = mid - cross_ax * (lb[s] / 2)[:, None]
    bb[s] = mid + cross_ax * (lb[s] / 2)[:, None]
    s = slice(3 * q, N)
    aa[s] = rng.uniform(-1, 1, (q, 3))
    ab[s] = aa[s] + rng.uniform(-1.2, 1.2, (q, 3))
    ba[s] = rng.uniform(-1, 1, (q, 3))
    bb[s] = ba[s] + rng.uniform(-1.2, 1.2, (q, 3))
    stats = {}
    masks = _check_k(*_run_both("cylinder_cylinder_cm",
                                (aa, ab, ra, ba, bb, rb), stats))
    counts = _branch_counts(stats, masks)
    assert min(counts.values()) > 0 and (~masks[:, 0]).sum() > 0, counts


def test_cylinder_hull_cm():
    """Cylinders against a 0.8 m cube hull (tests/test_cm_polytope.py:74:
    lying on its top face) and against the golden hull at random poses
    near it (tests/test_cm_polytope.py:177): identical hit masks (the SAT
    and the distance-GJK gate together), the contact of every hit lane
    within TOL; lanes the gate finds touching and separated both
    present."""
    rng = np.random.default_rng(29)
    cube = np.array([[x, y, z] for x in (-0.4, 0.4) for y in (-0.4, 0.4)
                     for z in (-0.4, 0.4)])
    half = N // 2
    out, stats = {}, {}
    for part, (pts, seed) in enumerate(((cube, 0), (chip_smoke.GOLDEN_HULL,
                                                    1))):
        h = _hull_lists(pts)
        rng = np.random.default_rng(30 + seed)
        hl = rng.uniform(0.15, 0.4, N)
        cr = rng.uniform(0.1, 0.3, N).astype(np.float32)
        if part == 0:
            # lying on the cube's top face, 0-3 cm in, axis in the plane
            ax = _unit(rng) * np.array([1, 0, 1])
            ax /= np.linalg.norm(ax, axis=1, keepdims=True)
            c = np.zeros((N, 3))
            c[:, 0], c[:, 2] = rng.uniform(-0.3, 0.3, N), rng.uniform(-0.3,
                                                                      0.3, N)
            c[:, 1] = 0.4 + cr - rng.uniform(-0.01, 0.03, N)
            hq = np.tile([0.0, 0.0, 0.0, 1.0], (N, 1)).astype(np.float32)
        else:
            ax = _unit(rng)
            c = _unit(rng) * rng.uniform(0.0, 0.7, (N, 1))
            hq = _quats(rng)
        ca = (c - ax * hl[:, None]).astype(np.float32)
        cb = (c + ax * hl[:, None]).astype(np.float32)
        hp = np.zeros((N, 3), np.float32)
        for lib, mod in (("jax", jcp), ("torch", tcp)):
            verts, _pl, _pv, faces, loops, llens, edges = _local(h, lib)
            hw = mod.hull_topology_world(_lanes(hp, lib), _lanes(hq, lib),
                                         verts, faces, loops, llens, edges)
            args = (_lanes(ca, lib), _lanes(cb, lib), _const(cr, lib), hw)
            st = {}
            res = (mod.cylinder_hull_cm(*args, stats=st) if lib == "torch"
                   else mod.cylinder_hull_cm(*args))
            out.setdefault(lib, []).append(res)
            if lib == "torch":
                for k, v in st.items():
                    stats.setdefault(k, []).append(_np(v))
    gate = np.concatenate(stats["gate"])
    hits = []
    for part in range(2):
        hits.append(_check_k(out["jax"][part], out["torch"][part])[:, 0])
    hit = np.concatenate(hits)
    assert hits[0].sum() > half, int(hits[0].sum())   # the face-rest lanes
    counts = (int(gate.sum()), int((~gate).sum()), int(hit.sum()),
              int((~hit).sum()))
    assert min(counts) > 0, counts


# ---------------------------------------------------------------------------
# cylinder mass properties and AABBs


def _cylinder_bodies(builder):
    """Bodies with one cylinder each (turned and off-centre in the body),
    one body with a cylinder, a sphere and a box together, on a ground
    box."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (5, 1, 5))
    rng = np.random.default_rng(31)
    for i in range(4):
        bd = b.add_body(position=(i, 1.0, 0.0))
        a = rng.normal(size=3) * 0.3
        b.add_cylinder_collider(bd, a, a + rng.normal(size=3) * 0.5,
                                rng.uniform(0.1, 0.4),
                                density=500.0 + 200.0 * i)
    bd = b.add_body(position=(0.0, 2.0, 1.0))
    b.add_cylinder_collider(bd, (0, -0.2, 0), (0, 0.2, 0), 0.3)
    b.add_sphere_collider(bd, (0.3, 0.1, 0), 0.15)
    b.add_box_collider(bd, (-0.2, 0, 0.1), (0.1, 0.2, 0.1))
    return b


def test_cylinder_mass_properties():
    """Inverse mass, inverse inertia and centre of gravity of cylinder
    bodies (float64 in both builders, rounded once): 1e-6 relative."""
    jp = _cylinder_bodies(JaxSceneBuilder).finalize().body_params
    tp = _cylinder_bodies(SceneBuilder).finalize(device="cpu").body_params
    for f in ("inv_mass", "inv_inertia", "local_cog"):
        want = np.asarray(getattr(jp, f), np.float64)
        got = getattr(tp, f).numpy().astype(np.float64)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f


def test_cylinder_aabbs():
    """World AABBs of cylinders at seeded poses: 1e-6."""
    jscene = _cylinder_bodies(JaxSceneBuilder).finalize()
    tscene = _cylinder_bodies(SceneBuilder).finalize(device="cpu")
    st = chip_smoke.shapes_initial_state(tscene, 3, 0)
    rng = np.random.default_rng(32)
    rot = st.rot.clone()
    rot[:, 1:-1] = torch.from_numpy(_quats(rng, 3 * (rot.shape[1] - 2))
                                    .reshape(3, -1, 4))
    w = tshapes.world_colliders(tscene, st.pos, rot)
    mn, mx = tshapes.collider_aabbs(tscene, w)
    for e in range(3):
        jw = jax_world(jscene, jnp.asarray(st.pos[e].numpy()),
                       jnp.asarray(rot[e].numpy()))
        jmn, jmx = jax_aabbs(jscene, jw)
        assert np.abs(mn[e].numpy() - np.asarray(jmn)).max() <= 1e-6
        assert np.abs(mx[e].numpy() - np.asarray(jmx)).max() <= 1e-6


# ---------------------------------------------------------------------------
# the scenes


SCENES = ("mixed_shape_drop", "sphere_bounce", "pile")


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, port scene) of a golden scene or the check pile."""
    if name == "pile":
        return (chip_smoke.shapes_pile_builder(JaxSceneBuilder).finalize(),
                chip_smoke.shapes_pile_scene("cpu"))
    return (chip_smoke.golden_builder(JaxSceneBuilder, name).finalize(),
            chip_smoke.shapes_scene(name, "cpu"))


@pytest.mark.parametrize("name", SCENES)
def test_scene_arrays_equal(name):
    """Body params, colliders (with their cylinders), pair groups and hull
    geometry equal the JAX package's: ints exactly, floats to 1e-7; the
    fused step takes the scene, every pair group in a recipe."""
    jscene, tscene = scenes(name)
    want = {}
    _flatten_jax("", jscene, want)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, k
        else:
            assert np.array_equal(g, w), k
    assert fs.fused2_eligible(tscene)
    tab = fs.fused_tables(tscene, "cpu")
    rows = {fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]]]: m["pg"]
            for m in tab.metas}
    want_rows = {"mixed_shape_drop": {
        "capsule_cylinder": 1, "capsule_box": 2, "capsule_hull": 1,
        "cylinder_box": 2, "cylinder_hull": 1, "box_hull": 2},
        "sphere_bounce": {"sphere_box": 1}}
    if name in want_rows:
        assert rows == want_rows[name]
    else:
        assert set(chip_smoke.SHAPES_RECIPES) <= set(rows), rows


# ---------------------------------------------------------------------------
# the fused step against the JAX package's, one env


def _one_env(state, e=0):
    return state.replace(**{k: getattr(state, k)[e:e + 1].contiguous()
                            for k in FIELDS})


def _touching_state(name):
    """One env of each scene with bodies in contact: the sphere 3 mm into
    the ground falling at 0.5 m/s; the mixed drop's hull on the ground
    beside the ramp, the cylinder upright on the ground against a hull
    vertex and the capsule lying across the cylinder's cap; the pile's
    first env (a jumble: every body overlapping others at random turns).
    Velocities get the seeded noise of chip_smoke.shapes_initial_state."""
    _jscene, tscene = scenes(name)
    if name == "pile":
        return _one_env(chip_smoke.shapes_pile_poses(tscene, 1, 3))
    st = chip_smoke.shapes_initial_state(tscene, 1, 4)
    pos, rot, lin = st.pos.clone(), st.rot.clone(), st.lin_vel.clone()
    if name == "sphere_bounce":
        pos[0, 1] = torch.tensor([0.1, 0.497, -0.05])
        lin[0, 1, 1] -= 0.5
    else:
        pos[0, 1] = torch.tensor([2.6, 0.197, 0.0])             # hull
        pos[0, 2] = torch.tensor([3.296, 0.247, 0.02])          # cylinder
        pos[0, 3] = torch.tensor([3.3, 0.747, 0.0])             # capsule
        rot[0, 3] = torch.tensor([0.0, 0.0, np.sin(np.pi / 4),
                                  np.cos(np.pi / 4)])
    return st.replace(pos=pos, rot=rot, lin_vel=lin)


def _trajectory(name, state, steps):
    """`steps` steps of one env: the JAX package's eager unbatched "fused"
    step and the port's plain version, with the port's StepInfo."""
    jscene, tscene = scenes(name)
    jsettings = JaxPhysicsSettings(num_rigid_solver_iterations=ITERS,
                                   solver_mode="fused")
    jst = jscene.initial_state().replace(
        **{k: jnp.asarray(getattr(state, k)[0].numpy()) for k in FIELDS})
    tst = state_from_numpy({k: getattr(state, k).numpy() for k in FIELDS}
                           | {"controls": None}, device="cpu")
    tsettings = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                                solver_mode="fused")
    out = []
    for _ in range(steps):
        # op by op: the same values as the default eager path (each jnp call
        # its own small jit), with less dispatch cost
        with jax.disable_jit():
            jst = jax_physics_step(jscene, jst, jsettings, DT)[0]
        tst, info = physics_step(tscene, tst, tsettings, DT)
        out.append((jst, tst, info))
    return out


@pytest.fixture(scope="module", params=SCENES[:2])
def run(request):
    """Three steps of one env of a golden scene (the check pile's are in
    tests/test_torch_shapes_pile.py: a file of its own, so that the two
    long eager JAX trajectories run on two test workers side by side)."""
    name = request.param
    return name, _trajectory(name, _touching_state(name), 3)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b[0].numpy()).max())


def _live_by_recipe(name, info):
    tab = fs.fused_tables(scenes(name)[1], "cpu")
    live = info.contact_mask[0]
    live = live.any(dim=-1) if live.dim() == 2 else live
    out, r0 = {}, 0
    for m in sorted(tab.metas, key=lambda m: m["phase"]):
        key = fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]]]
        out[key] = out.get(key, 0) + int(live[r0:r0 + m["pg"]].sum())
        r0 += m["pg"]
    return out


LIVE = {"sphere_bounce": ("sphere_box",),
        "mixed_shape_drop": ("cylinder_box", "cylinder_hull",
                             "capsule_cylinder", "box_hull"),
        "pile": ("sphere_sphere", "sphere_capsule", "sphere_cylinder",
                 "sphere_hull", "cylinder_cylinder", "cylinder_box")}


def check_one_step(name, traj):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations, with the scene's new recipes live."""
    jst, tst, info = traj[0]
    live = _live_by_recipe(name, info)
    assert all(live[r] > 0 for r in LIVE[name]), live
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-5
    assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-5


def check_three_steps(traj):
    """≤1e-4 after each of three steps on every state field."""
    for jst, tst, _info in traj:
        for k in ("pos", "rot", "lin_vel", "ang_vel"):
            assert _diff(getattr(jst, k), getattr(tst, k)) <= 1e-4, k
        assert bool(torch.isfinite(tst.ang_vel).all())


def test_one_step_matches_jax(run):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations, with the scene's new recipes live."""
    check_one_step(*run)


def test_three_steps_match_jax(run):
    """≤1e-4 after each of three steps on every state field."""
    check_three_steps(run[1])
