"""Heightfield terrain collision, batched over environments.

Port of the JAX package's ``ops/heightmap.py`` (plan path): each collider
samples a static K x K window of grid cells around its AABB (2 K^2
triangles), runs one branchless shape-vs-triangle test per triangle, keeps
the 4 deepest contacts and puts the below-terrain safety contact in slot 3.
`heightfield_plan` buckets the colliders by shape type and window size from
build-time data, so each bucket runs its own test on a footprint-sized
window.

Contacts follow heightmap_collision.cpp, as in the JAX package:
  - sphere vs triangle: closest point on the triangle;
  - capsule vs triangle: closest point of the axis segment, then a sphere
    test there;
  - box vs triangle: 13-axis SAT in the box frame, the triangle point
    closest to the box centre as contact point;
  - cylinder: the capsule test on its axis, with the exact lowest support
    point for the safety contact;
  - hulls get no terrain contacts;
  - safety contact: the collider's lowest support point below the terrain
    height there gives a contact with normal (0, -1, 0).
The collider is body A, the terrain the static dummy body; the normal points
from the collider toward the terrain.

The JAX package reads the height table through one-hot masked sums (a TPU
idiom); here it is indexed directly, which gives the same values. Only the
plan path is defined: the JAX package's monolithic fallback gives cylinders
the box's safety-contact formula.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxk_tpu_torch.core.maths import (const, cross, dot, normalize,
                                      quat_inv_rotate, quat_rotate, sqrt,
                                      squared_length)
from dxk_tpu_torch.ops.geometry import closest_point_segment_segment
from dxk_tpu_torch.scene.scene import _Struct

BIG = 3.4e38


@dataclass
class Heightfield(_Struct):
    """Static terrain: cell (x, z) holds triangles (A, B, C) and (C, B, D)
    with A = (x, z), B = (x, z + 1), C = (x + 1, z), D = (x + 1, z + 1)
    (heightmap_collider.h:87-104)."""

    heights: torch.Tensor          # (H, W) float32 world heights, [z, x]
    cell_size: float
    min_corner: torch.Tensor = None    # (3,) world position of node [0, 0]
    friction: float = 1.0
    restitution: float = 0.0
    window: int = 8                    # largest window, in cells

    @property
    def size(self):
        return tuple(self.heights.shape)


def make_heightfield(heights, cell_size, min_corner=(0.0, 0.0, 0.0),
                     friction=1.0, restitution=0.0, window=8,
                     device="cuda") -> Heightfield:
    return Heightfield(
        heights=torch.from_numpy(np.ascontiguousarray(
            heights, dtype=np.float32)).to(device),
        cell_size=float(cell_size),
        min_corner=torch.from_numpy(np.asarray(
            min_corner, dtype=np.float32)).to(device),
        friction=friction, restitution=restitution, window=window)


def height_at(hf: Heightfield, x, z):
    """Terrain height of the triangle holding (x, z) (getHeightAt)."""
    lx = (x - hf.min_corner[0]) / hf.cell_size
    lz = (z - hf.min_corner[2]) / hf.cell_size
    H, W = hf.heights.shape
    cx = torch.clamp(torch.floor(lx).to(torch.int32), 0, W - 2)
    cz = torch.clamp(torch.floor(lz).to(torch.int32), 0, H - 2)
    fx = torch.clamp(lx - cx, 0.0, 1.0)
    fz = torch.clamp(lz - cz, 0.0, 1.0)
    cx, cz = cx.long(), cz.long()
    h = hf.heights
    ha = h[cz, cx]
    hb = h[cz + 1, cx]
    hc = h[cz, cx + 1]
    hd = h[cz + 1, cx + 1]
    # triangle (A, B, C) where fx + fz < 1, else (C, B, D)
    h1 = ha + (hc - ha) * fx + (hb - ha) * fz
    h2 = hd + (hb - hd) * (1.0 - fx) + (hc - hd) * (1.0 - fz)
    return hf.min_corner[1] + torch.where(fx + fz < 1.0, h1, h2)


def _window_triangles(hf: Heightfield, aabb_min, aabb_max, K):
    """The K x K cell window under each AABB (..., 3): triangle corners
    (..., 2 K^2, 3) in world space and a mask of the triangles in the grid
    that overlap the AABB."""
    H, W = hf.heights.shape
    dev = aabb_min.device
    lx = (aabb_min[..., 0] - hf.min_corner[0]) / hf.cell_size
    lz = (aabb_min[..., 2] - hf.min_corner[2]) / hf.cell_size
    x0 = torch.clamp(torch.floor(lx).to(torch.int64), 0, max(W - 1 - K, 0))
    z0 = torch.clamp(torch.floor(lz).to(torch.int64), 0, max(H - 1 - K, 0))

    d = torch.arange(K, device=dev)
    cx = (x0[..., None] + d)[..., None, :]            # (..., 1, K) [z, x]
    cz = (z0[..., None] + d)[..., :, None]            # (..., K, 1)
    valid = ((cx < W - 1) & (cz < H - 1)).flatten(-2)   # (..., K*K)

    # the (K+1) x (K+1) node window; clamped nodes only serve masked cells
    n = torch.arange(K + 1, device=dev)
    nx = torch.clamp(x0[..., None] + n, max=W - 1)     # (..., K+1)
    nz = torch.clamp(z0[..., None] + n, max=H - 1)
    nh = hf.heights[nz[..., :, None], nx[..., None, :]]   # (..., K+1, K+1)
    nwx = hf.min_corner[0] + nx.to(torch.float32) * hf.cell_size
    nwz = hf.min_corner[2] + nz.to(torch.float32) * hf.cell_size
    nodes = torch.stack([nwx[..., None, :].expand(nh.shape),
                         hf.min_corner[1] + nh,
                         nwz[..., :, None].expand(nh.shape)], dim=-1)

    lead = nodes.shape[:-3]
    A = nodes[..., :K, :K, :].reshape(*lead, K * K, 3)
    B = nodes[..., 1:, :K, :].reshape(*lead, K * K, 3)
    C = nodes[..., :K, 1:, :].reshape(*lead, K * K, 3)
    D = nodes[..., 1:, 1:, :].reshape(*lead, K * K, 3)
    tri_a = torch.cat([A, C], dim=-2)
    tri_b = torch.cat([B, B], dim=-2)
    tri_c = torch.cat([C, D], dim=-2)
    vmask = torch.cat([valid, valid], dim=-1)

    # prune triangles outside the AABB in x and z (and far above it)
    tmin = torch.minimum(torch.minimum(tri_a, tri_b), tri_c)
    tmax = torch.maximum(torch.maximum(tri_a, tri_b), tri_c)
    amin = aabb_min[..., None, :]
    amax = aabb_max[..., None, :]
    overlap = ((tmin[..., 0] <= amax[..., 0]) & (tmax[..., 0] >= amin[..., 0])
               & (tmin[..., 2] <= amax[..., 2])
               & (tmax[..., 2] >= amin[..., 2])
               & (tmin[..., 1] <= amax[..., 1] + 10.0)
               & (tmax[..., 1] >= amin[..., 1]))
    return tri_a, tri_b, tri_c, vmask & overlap


def _safe_div(x, d):
    return x / torch.where(torch.abs(d) < 1e-12, 1.0, d)


def closest_point_point_triangle(p, a, b, c):
    """Ericson 5.1.5 (the reference's closestPoint_PointTriangle)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = torch.clamp(_safe_div(d4 - d3, denom_bc), 0.0, 1.0)

    region_a = (d1 <= 0.0) & (d2 <= 0.0)
    region_b = (d3 >= 0.0) & (d4 <= d3)
    region_c = (d6 >= 0.0) & (d5 <= d6)
    region_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    region_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    region_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    v_ab = torch.clamp(_safe_div(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(_safe_div(d2, d2 - d6), 0.0, 1.0)

    denom = torch.where(torch.abs(va + vb + vc) < 1e-12, 1.0, va + vb + vc)
    v = vb / denom
    w = vc / denom
    out = a + ab * v[..., None] + ac * w[..., None]
    out = torch.where(region_bc[..., None], b + (c - b) * w_bc[..., None], out)
    out = torch.where(region_ac[..., None], a + ac * w_ac[..., None], out)
    out = torch.where(region_ab[..., None], a + ab * v_ab[..., None], out)
    out = torch.where(region_c[..., None], c, out)
    out = torch.where(region_b[..., None], b, out)
    return torch.where(region_a[..., None], a, out)


def _sphere_tri(center, radius, a, b, c):
    """collideSphereVsTriangle (heightmap_collision.cpp:43-78)."""
    closest = closest_point_point_triangle(center, a, b, c)
    n = closest - center
    sq = squared_length(n)
    hit = sq <= radius * radius
    degenerate = sq == 0.0
    dist = sqrt(torch.clamp(sq, min=1e-30))
    tri_n = cross(b - a, c - a)
    n = torch.where(degenerate[..., None], -tri_n, n / dist[..., None])
    n = torch.where(degenerate[..., None], normalize(n + 1e-30), n)
    depth = radius - torch.where(degenerate, 0.0, dist)
    return closest, n, depth, hit


def _sphere_capsule_pt(center, radius, closest, a, b, c):
    n = closest - center
    sq = squared_length(n)
    hit = sq <= radius * radius
    degenerate = sq == 0.0
    dist = sqrt(torch.clamp(sq, min=1e-30))
    tri_n = cross(b - a, c - a)
    n = torch.where(degenerate[..., None], -normalize(tri_n + 1e-30),
                    n / dist[..., None])
    depth = radius - torch.where(degenerate, 0.0, dist)
    return closest, n, depth, hit


def _capsule_tri(pa, pb, radius, a, b, c):
    """Capsule vs triangle: the closest point of the axis segment to the
    triangle (its two endpoints against the face, the segment against each
    edge), then a sphere test there."""
    cands = [(p, closest_point_point_triangle(p, a, b, c)) for p in (pa, pb)]
    for e0, e1 in ((a, b), (b, c), (c, a)):
        s, t, _ = closest_point_segment_segment(pa, pb, e0, e1)
        cands.append((s, t))
    best_d = torch.full(torch.broadcast_shapes(pa.shape, a.shape)[:-1], BIG,
                        dtype=a.dtype, device=a.device)
    best_s, best_q = pa, a
    for s, q in cands:
        dd = squared_length(s - q)
        better = dd < best_d
        best_d = torch.where(better, dd, best_d)
        best_s = torch.where(better[..., None], s, best_s)
        best_q = torch.where(better[..., None], q, best_q)
    return _sphere_capsule_pt(best_s, radius, best_q, a, b, c)


def _box_tri(center, half, q, a, b, c):
    """OBB vs triangle: 13-axis SAT in the box frame
    (heightmap_collision.cpp:80-507). Contact point: the triangle point
    closest to the box centre; normal: the SAT axis of least penetration,
    from the box toward the triangle."""
    al = quat_inv_rotate(q, a - center)
    bl = quat_inv_rotate(q, b - center)
    cl = quat_inv_rotate(q, c - center)
    f0 = bl - al
    f1 = cl - bl
    f2 = al - cl
    shape = al.shape
    best_pen = torch.full(shape[:-1], BIG, dtype=al.dtype, device=al.device)
    best_n = torch.zeros(shape, dtype=al.dtype, device=al.device)
    sep = torch.zeros(shape[:-1], dtype=torch.bool, device=al.device)

    def axis_test(axis, best_pen, best_n, sep):
        ln2 = squared_length(axis)
        ok = ln2 > 1e-12
        axis_n = axis / sqrt(torch.clamp(ln2, min=1e-12))[..., None]
        p0 = dot(al, axis_n)
        p1 = dot(bl, axis_n)
        p2 = dot(cl, axis_n)
        r = torch.sum(half * torch.abs(axis_n), dim=-1)
        tri_min = torch.minimum(torch.minimum(p0, p1), p2)
        tri_max = torch.maximum(torch.maximum(p0, p1), p2)
        pen = torch.minimum(tri_max, r) - torch.maximum(tri_min, -r)
        this_sep = ok & ((tri_min > r) | (tri_max < -r))
        better = ok & ~this_sep & (pen < best_pen)
        best_pen = torch.where(better, pen, best_pen)
        sgn = torch.where(tri_min + tri_max > 0.0, 1.0, -1.0)
        best_n = torch.where(better[..., None], axis_n * sgn[..., None],
                             best_n)
        return best_pen, best_n, sep | this_sep

    eye = [const(e, al).expand(shape) for e in
           ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))]
    for e in eye:
        best_pen, best_n, sep = axis_test(e, best_pen, best_n, sep)
    best_pen, best_n, sep = axis_test(cross(f0, cl - al), best_pen, best_n,
                                      sep)
    for f in (f0, f1, f2):
        for e in eye:
            best_pen, best_n, sep = axis_test(cross(e, f), best_pen, best_n,
                                              sep)
    cp = closest_point_point_triangle(torch.zeros_like(al), al, bl, cl)
    point = quat_rotate(q, cp) + center
    normal = quat_rotate(q, best_n)
    return point, normal, best_pen, ~sep


# ---------------------------------------------------------------------------
# the plan path


def heightfield_plan(scene):
    """Static (shape type, window size) buckets of the scene's colliders,
    from build-time data: {"groups": [(tag, K, idx ndarray)], "inactive":
    idx ndarray, "inv": permutation ndarray}; the concatenated idx arrays
    cover every collider once and `inv` maps that order back to collider
    order. The window K is the footprint bound ceil(extent / cell) + 1,
    rounded up to a power of two (at least 2, at most the heightfield's
    window): exactly the JAX package's. Kept on the scene."""
    cache = scene.__dict__.get("_heightfield_plan")
    if cache is not None:
        return cache
    c = scene.colliders
    hf = scene.heightfield
    ctype = c.ctype.cpu().numpy()
    a = c.a.cpu().numpy()
    b = c.b.cpu().numpy()
    r = c.r.cpu().numpy()
    body = c.body.cpu().numpy()
    C = ctype.shape[0]

    ext = np.zeros(C, np.float64)
    ext = np.where(ctype == 0, 2.0 * r, ext)                        # sphere
    ext = np.where(np.isin(ctype, (1, 2)),
                   np.linalg.norm(b - a, axis=-1) + 2.0 * r,
                   ext)                                    # capsule/cylinder
    ext = np.where(ctype == 3, 2.0 * np.linalg.norm(b, axis=-1), ext)  # box
    k_req = np.ceil(ext / hf.cell_size).astype(np.int64) + 1
    k_bucket = np.maximum(2, 2 ** np.ceil(np.log2(
        np.maximum(k_req, 1))).astype(np.int64))
    k_bucket = np.minimum(k_bucket, hf.window)

    # hulls (ctype 4) get no terrain contacts, as in the JAX package
    active = (body < scene.num_bodies) & np.isin(ctype, (0, 1, 2, 3))
    groups = []
    for tag, code in (("sphere", 0), ("capsule", 1), ("box", 3),
                      ("cylinder", 2)):
        tmask = active & (ctype == code)
        for K in sorted(set(k_bucket[tmask].tolist())):
            idx = np.nonzero(tmask & (k_bucket == K))[0]
            groups.append((tag, int(K), idx))
    inactive = np.nonzero(~active)[0]
    order = np.concatenate([g[2] for g in groups] + [inactive]) \
        if groups else inactive
    plan = {"groups": groups, "inactive": inactive,
            "inv": np.argsort(order)}
    scene.__dict__["_heightfield_plan"] = plan
    return plan


def lowest_support(tag, a_, b_, r_, rot_):
    """The lowest support point of each collider of a bucket (..., 3)."""
    if tag == "sphere":
        return a_ - const((0.0, 1.0, 0.0), a_) * r_[..., None]
    low_end = torch.where((a_[..., 1] < b_[..., 1])[..., None], a_, b_)
    if tag == "capsule":
        return low_end - const((0.0, 1.0, 0.0), a_) * r_[..., None]
    if tag == "cylinder":
        # the lower cap centre plus the radial part of -y orthogonal to the
        # axis: the exact lowest point of the cylinder
        axis = b_ - a_
        u = axis / sqrt(torch.clamp(squared_length(axis), min=1e-12))[
            ..., None]
        d = const((0.0, -1.0, 0.0), a_)
        radial = d - u * dot(d, u)[..., None]
        rl = sqrt(torch.clamp(squared_length(radial), min=0.0))
        rdir = torch.where((rl > 1e-6)[..., None],
                           radial / torch.clamp(rl, min=1e-12)[..., None],
                           const((1.0, 0.0, 0.0), a_))
        return low_end + r_[..., None] * rdir
    nl = quat_inv_rotate(rot_, const((0.0, -1.0, 0.0), a_).expand_as(a_))
    return a_ + quat_rotate(rot_, torch.where(nl >= 0, b_, -b_))


def _typed_group_contacts(hf: Heightfield, w, aabb_min, aabb_max, idx, tag,
                          K):
    """Terrain manifolds of one (shape type, window) bucket: 4 points per
    collider, (B, G, 4, ...) for the colliders `idx` (G,)."""
    a_ = w.a[:, idx]
    b_ = w.b[:, idx]
    r_ = w.r[idx].expand(a_.shape[:-1])
    rot_ = w.rot[:, idx]
    ta, tb, tc, vmask = _window_triangles(hf, aabb_min[:, idx],
                                          aabb_max[:, idx], K)
    ex = lambda x: x[..., None, :]                    # noqa: E731
    if tag == "sphere":
        pts, nrm, dep, hit = _sphere_tri(ex(a_), r_[..., None], ta, tb, tc)
    elif tag in ("capsule", "cylinder"):
        # cylinders: the capsule test on the axis (exact on the lateral
        # surface, what a rolling wheel touches)
        pts, nrm, dep, hit = _capsule_tri(ex(a_), ex(b_), r_[..., None], ta,
                                          tb, tc)
    else:
        pts, nrm, dep, hit = _box_tri(ex(a_), ex(b_), ex(rot_), ta, tb, tc)
    hit = hit & vmask

    # the 4 deepest: four rounds of masked max; argmax takes the first of
    # equal maxima, as the JAX package's first-tie one-hot does
    score = torch.where(hit, dep, -BIG)
    sel_p, sel_n, sel_d, sel_h = [], [], [], []
    for _slot in range(4):
        i = torch.argmax(score, dim=-1, keepdim=True)        # (B, G, 1)
        sel_p.append(torch.gather(pts, -2, i[..., None].expand(
            *i.shape, 3))[..., 0, :])
        sel_n.append(torch.gather(nrm, -2, i[..., None].expand(
            *i.shape, 3))[..., 0, :])
        sel_d.append(torch.gather(dep, -1, i)[..., 0])
        sel_h.append(torch.gather(hit, -1, i)[..., 0])
        score = score.scatter(-1, i, -BIG)
    pts4 = torch.stack(sel_p, dim=-2)
    nrm4 = torch.stack(sel_n, dim=-2)
    dep4 = torch.stack(sel_d, dim=-1)
    hit4 = torch.stack(sel_h, dim=-1)

    # below-terrain safety contact in slot 3 (heightmap_collision.cpp:537-570)
    low = lowest_support(tag, a_, b_, r_, rot_)
    h_at = height_at(hf, low[..., 0], low[..., 2])
    below = low[..., 1] < h_at
    down = const((0.0, -1.0, 0.0), low).expand_as(low)
    pts4[..., 3, :] = torch.where(below[..., None], low, pts4[..., 3, :])
    nrm4[..., 3, :] = torch.where(below[..., None], down, nrm4[..., 3, :])
    dep4[..., 3] = torch.where(below, h_at - low[..., 1], dep4[..., 3])
    hit4[..., 3] = hit4[..., 3] | below
    return pts4, nrm4, dep4, hit4


def heightfield_contacts(hf: Heightfield, w, body_of, aabb_min, aabb_max,
                         num_bodies, plan=None):
    """Contacts between every rigid-body collider and the terrain, one
    4-point row per collider: (points (B, C, 4, 3), normals (B, C, 4, 3),
    depths (B, C, 4), body_a (B, C), body_b (B, C) = dummy, friction (C,),
    restitution (C,), mask (B, C, 4)). body_a is the collider's body where
    the row has a contact, else the dummy. `w`: shapes.WorldColliders;
    `plan`: heightfield_plan(scene)."""
    if plan is None:
        raise NotImplementedError(
            "heightfield_contacts without a heightfield_plan: only the plan "
            "path is defined (the JAX package's monolithic fallback gives "
            "cylinders the box's safety-contact formula)")
    B, C = w.a.shape[0], w.a.shape[1]
    dev = w.a.device
    # the plan's index arrays on this device, made once (a copy from the
    # host each step would wait for the device)
    on_dev = plan.setdefault("on_device", {})
    if str(dev) not in on_dev:
        on_dev[str(dev)] = ([torch.from_numpy(idx).to(dev)
                             for _t, _k, idx in plan["groups"]],
                            torch.from_numpy(plan["inv"]).to(dev))
    idxs, inv = on_dev[str(dev)]
    parts = [_typed_group_contacts(hf, w, aabb_min, aabb_max, ix, tag, K)
             for (tag, K, idx), ix in zip(plan["groups"], idxs) if len(idx)]
    n_in = len(plan["inactive"])
    if n_in:
        z = lambda *s: torch.zeros((B, n_in, *s), device=dev)  # noqa: E731
        parts.append((z(4, 3), z(4, 3), z(4),
                      torch.zeros((B, n_in, 4), dtype=torch.bool,
                                  device=dev)))
    pts, nrm, dep, hit = (torch.cat(x, dim=1)[:, inv] for x in zip(*parts))
    is_rb = body_of < num_bodies
    hit = hit & is_rb[:, None]
    fric = torch.clamp(sqrt(w.friction * hf.friction), 0.0, 1.0)
    rest = torch.clamp(torch.clamp(w.restitution, min=hf.restitution),
                       0.0, 1.0)
    body_a = torch.where(hit.any(dim=-1), body_of.long(), num_bodies)
    body_b = torch.full((B, C), num_bodies, dtype=torch.int64, device=dev)
    return pts, nrm, dep, body_a, body_b, fric, rest, hit
