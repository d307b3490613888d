"""Port parity, modules ops/narrowphase.py and ops/geometry.py (the
reference step's contact recipes): all 15 (typeA, typeB) buckets of
physics._contacts_for_group, called through the port's dispatcher on a
flat batch of seeded pairs, against the JAX package's `*_contact`
functions vmapped over the same pairs and run eagerly; and the three
closest-point primitives.

The five hull buckets' JAX side is their `*_contact` functions' own
calls evaluated on (N,) lanes instead of under vmap (see
_jax_hull_contacts).

The pairs of each bucket (N = 384, numpy seed per bucket): shape B near
the origin, shape A at a seeded direction and distance scaled by the two
shapes' sizes, a quarter of them face-parallel (axis-aligned rotations,
segment shapes along x, A stacked above B along y). Each bucket must hold
separated, touching (live depth <= 0.02), deep (live depth >= 0.1) and
face-parallel hits, counted from the JAX results. `hit` and `count` equal;
points, depths and normals of live points within 1e-5 absolute (the two
packages run the same float32 operations; XLA and PyTorch round a few
reductions differently)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.ops import geometry as jgeo
from dxk_tpu.ops import narrowphase as jnp_ops
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.ops import geometry as tgeo
from dxk_tpu_torch.ops.shapes import WorldColliders
from dxk_tpu_torch.physics import _contacts_for_group
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.scene import PairGroup

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

N = 384
TOL = 1e-5
SPHERE, CAPSULE, CYLINDER, BOX, HULL = range(5)
BUCKETS = [(a, b) for a in range(5) for b in range(a, 5)]
NAMES = ("sphere", "capsule", "cylinder", "box", "hull")
HULL_MESHES = (
    np.array([[0.4, 0, 0], [-0.3, 0.25, 0.1], [0, -0.2, 0.35],
              [-0.1, -0.15, -0.3], [0.1, 0.3, -0.2]]),
    np.array([[sx * 0.3, sy * 0.2, sz * 0.25] for sx in (-1, 1)
              for sy in (-1, 1) for sz in (-1, 1)]),
)


def _hull_scenes():
    """(JAX HullGeometry, port HullGeometry) of the two test hulls."""
    out = []
    for builder, kw in ((JaxSceneBuilder, {}), (SceneBuilder,
                                                {"device": "cpu"})):
        b = builder()
        for mesh in HULL_MESHES:
            hid = b.add_hull_geometry_from_mesh(mesh)
            b.add_hull_collider(b.add_body(position=(0.0, 0.0, 0.0)), hid)
        out.append(b.finalize(**kw).hulls)
    return out


JHULLS, THULLS = _hull_scenes()


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _quat(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _shapes(rng, stype, center, parallel):
    """World params (a, b, r, rot, hull_id, size) of N shapes of one type;
    `size` is a rough bounding radius."""
    a = center.copy()
    b = np.zeros((N, 3))
    r = rng.uniform(0.1, 0.45, N)
    rot = np.tile([0.0, 0.0, 0.0, 1.0], (N, 1))
    hid = np.zeros(N, np.int64)
    size = r.copy()
    par = parallel[:, None]
    if stype in (CAPSULE, CYLINDER):
        hl = rng.uniform(0.1, 0.5, N)
        u = np.where(par, [1.0, 0.0, 0.0], _unit(rng, N))
        a = center - u * hl[:, None]
        b = center + u * hl[:, None]
        size = r + hl
    elif stype == BOX:
        b = rng.uniform(0.15, 0.6, (N, 3))
        rot = np.where(par, rot, _quat(rng, N))
        size = np.linalg.norm(b, axis=-1)
    elif stype == HULL:
        hid = rng.integers(0, len(HULL_MESHES), N)
        rot = np.where(par, rot, _quat(rng, N))
        size = np.full(N, 0.45)
    return a, b, r, rot, hid, size


def _half_height(stype, b, r, hid):
    """Half extent along y of an axis-aligned shape (parallel pairs)."""
    if stype == BOX:
        return b[:, 1]
    if stype == HULL:
        verts = np.stack([m[:, 1].max() for m in HULL_MESHES])
        return verts[hid]
    return r


def make_pairs(bucket, seed):
    """Numpy world params of N seeded pairs of one bucket, and the mask of
    the face-parallel pairs."""
    ta, tb = bucket
    rng = np.random.default_rng(seed)
    parallel = np.arange(N) % 4 == 0
    cb = rng.uniform(-0.05, 0.05, (N, 3))
    sb = _shapes(rng, tb, cb, parallel)
    # A's centre: a seeded direction and distance, placed after B's size
    # is known; its own size is drawn first with a provisional centre
    sa = _shapes(rng, ta, np.zeros((N, 3)), parallel)
    d = _unit(rng, N)
    dist = (sa[5] + sb[5]) * rng.uniform(0.0, 1.25, N)
    stack = (_half_height(ta, sa[1], sa[2], sa[4])
             + _half_height(tb, sb[1], sb[2], sb[4])) * rng.uniform(
                 0.8, 1.04, N)
    off = np.where(parallel[:, None],
                   np.stack([rng.uniform(-0.1, 0.1, N), stack,
                             rng.uniform(-0.1, 0.1, N)], -1),
                   d * dist[:, None])
    ca = cb + off
    a_a, a_b = sa[0] + ca, sa[1] + (ca if ta in (CAPSULE, CYLINDER) else 0.0)
    side_a = (a_a, a_b, sa[2], sa[3], sa[4])
    side_b = sb[:5]
    return side_a, side_b, parallel


def _f32(x):
    return np.ascontiguousarray(x, dtype=np.float32)


def _jax_contacts(bucket, side_a, side_b):
    """JAX's vmapped `*_contact` of the bucket, eager."""
    ta, tb = bucket
    a_a, a_b, a_r, a_q, a_h = (jnp.asarray(_f32(x)) if i < 4 else
                               jnp.asarray(x) for i, x in enumerate(side_a))
    b_a, b_b, b_r, b_q, b_h = (jnp.asarray(_f32(x)) if i < 4 else
                               jnp.asarray(x) for i, x in enumerate(side_b))
    v = jax.vmap
    np_ops = jnp_ops
    if tb == HULL:
        return _jax_hull_contacts(ta, a_a, a_b, a_r, a_q, a_h,
                                  b_a, b_q, b_h)
    fn = getattr(np_ops, f"{NAMES[ta]}_{NAMES[tb]}_contact")
    args = {
        (SPHERE, SPHERE): (a_a, a_r, b_a, b_r),
        (SPHERE, CAPSULE): (a_a, a_r, b_a, b_b, b_r),
        (SPHERE, CYLINDER): (a_a, a_r, b_a, b_b, b_r),
        (SPHERE, BOX): (a_a, a_r, b_a, b_b, b_q),
        (CAPSULE, BOX): (a_a, a_b, a_r, b_a, b_b, b_q),
        (CYLINDER, BOX): (a_a, a_b, a_r, b_a, b_b, b_q),
        (BOX, BOX): (a_a, a_b, a_q, b_a, b_b, b_q),
    }.get(bucket, (a_a, a_b, a_r, b_a, b_b, b_r))
    return v(fn)(*args)


def _lanes(x):
    """(N, 3) -> v3 tuple of (N,) lanes."""
    return (x[:, 0], x[:, 1], x[:, 2])


def _jax_hull_world(p, q, h, hid, LM):
    """jnp_ops._hull_world_topo on (N,) lanes of per-pair hull tables."""
    from dxk_tpu.ops.pallas import cm_polytope as cp
    verts, pn, pm = h.vertices[hid], h.poly_normals[hid], h.poly_mask[hid]
    lp, ll = h.loop_pts[hid], h.loop_len[hid]
    ed, em = h.edge_dirs[hid], h.edge_mask[hid]
    loops = []
    for f in range(pn.shape[1]):
        pts = [_lanes(lp[:, f, i]) for i in range(lp.shape[2])]
        loops.append(tuple(pts + [pts[-1]] * (LM - len(pts))))
    return cp.hull_topology_world(
        _lanes(p), tuple(q[:, i] for i in range(4)),
        [_lanes(verts[:, i]) for i in range(verts.shape[1])],
        [(_lanes(pn[:, f]), pm[:, f]) for f in range(pn.shape[1])],
        loops, [ll[:, f] for f in range(pn.shape[1])],
        [(_lanes(ed[:, e]), em[:, e]) for e in range(ed.shape[1])])


def _jax_hull_contacts(ta, a_a, a_b, a_r, a_q, a_h, b_a, b_q, b_h):
    """The JAX package's five hull `*_contact` functions, evaluated on (N,)
    lanes: the same calls (its maths, its cm_hull / cm_polytope recipes,
    its _one_point / _stack_manifold) in the same order, without vmap,
    which eagerly costs 15-20 s a bucket on the CPU."""
    from dxk_tpu.core.maths import quat_inv_rotate, quat_rotate
    from dxk_tpu.ops.pallas import cm_hull as ch
    from dxk_tpu.ops.pallas import cm_polytope as cp
    h = JHULLS
    one_point = jax.vmap(jnp_ops._one_point)
    if ta in (SPHERE, CAPSULE):
        fn, fo, fm = (h.face_normals[b_h], h.face_offsets[b_h],
                      h.face_mask[b_h])
        verts = h.vertices[b_h]
        vlist = [_lanes(verts[:, i]) for i in range(verts.shape[1])]
        planes = [(_lanes(fn[:, i]), fo[:, i]) for i in range(fn.shape[1])]
        pvalid = [fm[:, i] for i in range(fm.shape[1])]
        if ta == SPHERE:
            pt, depth, nrm, hit = ch.sphere_hull_core(
                _lanes(quat_inv_rotate(b_q, a_a - b_a)), a_r, vlist, planes,
                pvalid)
        else:
            pt, depth, nrm, hit = ch.capsule_hull_core(
                _lanes(quat_inv_rotate(b_q, a_a - b_a)),
                _lanes(quat_inv_rotate(b_q, a_b - b_a)), a_r, vlist, planes,
                pvalid)
        return one_point(quat_rotate(b_q, jnp.stack(pt, -1)) + b_a, depth,
                         quat_rotate(b_q, jnp.stack(nrm, -1)), hit)
    LMb = h.loop_pts.shape[2]
    if ta == CYLINDER:
        pts, dps, nrm, hits = cp.cylinder_hull_cm(
            _lanes(a_a), _lanes(a_b), a_r, _jax_hull_world(b_a, b_q, h, b_h,
                                                           LMb))
        return one_point(jnp.stack(pts[0], -1), dps[0], jnp.stack(nrm, -1),
                         hits[0])
    if ta == BOX:
        LM = max(4, LMb)
        out = cp.box_hull_cm(_lanes(a_a), _lanes(a_b),
                             tuple(a_q[:, i] for i in range(4)),
                             _jax_hull_world(b_a, b_q, h, b_h, LM), LM)
    else:
        out = cp.hull_hull_cm(_jax_hull_world(a_a, a_q, h, a_h, LMb),
                              _jax_hull_world(b_a, b_q, h, b_h, LMb))
    pts, dps, nrm, masks = out
    cnt = sum(m.astype(jnp.int32) for m in masks)
    return (jnp.stack([jnp.stack(p, -1) for p in pts], 1),
            jnp.stack(dps, -1), jnp.stack(nrm, -1), cnt, cnt > 0)


def _port_contacts(bucket, side_a, side_b):
    """The port's dispatcher on one env of 2N colliders: A shapes first,
    then B shapes, pair i = (i, N + i)."""
    cat = [np.concatenate([x, y]) for x, y in zip(side_a, side_b)]
    ctype = torch.tensor([bucket[0]] * N + [bucket[1]] * N,
                         dtype=torch.int32)
    zeros = torch.zeros(2 * N)
    w = WorldColliders(
        ctype=ctype, a=torch.from_numpy(_f32(cat[0]))[None],
        b=torch.from_numpy(_f32(cat[1]))[None],
        r=torch.from_numpy(_f32(cat[2])),
        rot=torch.from_numpy(_f32(cat[3]))[None], friction=zeros,
        restitution=zeros, body=torch.zeros(2 * N, dtype=torch.int32),
        hull_id=torch.from_numpy(cat[4].astype(np.int32)))
    scene = types.SimpleNamespace(hulls=THULLS)
    group = PairGroup(type_a=bucket[0], type_b=bucket[1])
    pairs = torch.stack([torch.arange(N), torch.arange(N) + N], -1)[None]
    mask = torch.ones((1, N), dtype=torch.bool)
    out = _contacts_for_group(scene, w, group, pairs.to(torch.int32), mask)
    return tuple(x[0] for x in out)


@pytest.mark.parametrize("bucket", BUCKETS,
                         ids=[f"{NAMES[a]}-{NAMES[b]}" for a, b in BUCKETS])
def test_bucket_matches_jax(bucket):
    seed = 100 + 7 * bucket[0] + bucket[1]
    side_a, side_b, parallel = make_pairs(bucket, seed)
    jpts, jdps, jnrm, jcnt, jhit = (np.asarray(x) for x in
                                    _jax_contacts(bucket, side_a, side_b))
    tpts, tdps, tnrm, tcnt, thit = (x.numpy() for x in
                                    _port_contacts(bucket, side_a, side_b))
    live = np.arange(4) < jcnt[:, None]
    depth = np.where(live, jdps, -np.inf).max(axis=-1)
    cases = {
        "separated": int((~jhit).sum()),
        "touching": int((jhit & (depth <= 0.02)).sum()),
        "deep": int((jhit & (depth >= 0.1)).sum()),
        "face_parallel": int((jhit & parallel).sum()),
    }
    assert all(n > 0 for n in cases.values()), cases
    assert np.array_equal(thit, jhit)
    assert np.array_equal(tcnt, jcnt)
    assert np.abs(tpts - jpts)[live].max(initial=0.0) <= TOL
    assert np.abs(tdps - jdps)[live].max(initial=0.0) <= TOL
    assert np.abs(tnrm - jnrm)[jhit].max(initial=0.0) <= TOL


def test_geometry_matches_jax():
    """closest_point_point_segment / _point_aabb / _segment_segment on
    seeded inputs, degenerate (zero-length) and parallel segments
    included, within 1e-6."""
    rng = np.random.default_rng(7)
    M = 512
    p1, q1, p2, q2, q = (_f32(rng.uniform(-1, 1, (M, 3))) for _ in range(5))
    q1[:32] = p1[:32]                       # point-like first segment
    q2[16:48] = p2[16:48]                   # point-like second segment
    q2[64:96] = p2[64:96] + (q1[64:96] - p1[64:96]) * 0.5   # parallel
    lo = _f32(-rng.uniform(0.1, 0.6, (M, 3)))
    hi = _f32(rng.uniform(0.1, 0.6, (M, 3)))
    T = torch.from_numpy
    got = [tgeo.closest_point_point_segment(T(q), T(p1), T(q1)),
           tgeo.closest_point_point_aabb(T(q), T(lo), T(hi)),
           *tgeo.closest_point_segment_segment(T(p1), T(q1), T(p2), T(q2))]
    J = jnp.asarray
    want = [jgeo.closest_point_point_segment(J(q), J(p1), J(q1)),
            jgeo.closest_point_point_aabb(J(q), J(lo), J(hi)),
            *jgeo.closest_point_segment_segment(J(p1), J(q1), J(p2), J(q2))]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6
