"""Narrowphase contact generation of the reference (non-fused) step,
batched over any leading dimensions: the port's counterpart of the JAX
package's ops/narrowphase.py, in its operation order. Each `*_contact`
function returns a fixed 4-slot manifold per pair, `(points (..., 4, 3),
depths (..., 4), normal (..., 3), count (...,) int32, hit (...,) bool)`;
all branches are evaluated and mask-selected. Normals point from collider
A to collider B.

All 15 (typeA, typeB) buckets: the sphere and capsule families, capsule-
and cylinder-box (closed-form segment / solid-cylinder vs box, face-clip
enrichment), cylinder-cylinder, box-box (15-axis SAT, reference-face
clipping, edge-edge closest points), and the five hull buckets over the
plain versions of the fused step's hull recipes (ops/kernels/cm_hull.py,
cm_polytope.py), called on per-pair lanes exactly as the JAX package calls
its own. These are the recipes the reference step calls; the fused step's
component-major recipes are ops/kernels/cm_narrowphase.py.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import (const, cross, dot, get_tangents,
                                      length, normalize, quat_inv_rotate,
                                      quat_rotate, quat_to_mat3, sqrt,
                                      squared_length)
from dxk_tpu_torch.ops.geometry import (closest_point_point_aabb,
                                        closest_point_point_segment,
                                        closest_point_segment_segment)
from dxk_tpu_torch.ops.manifold import (POLY_SLOTS, make_plane,
                                        project_and_filter, reduce_manifold,
                                        signed_distance, sutherland_hodgman)

EPSILON = 1e-6
# Minimum RELATIVE improvement for a later SAT candidate to replace the
# current winner in box_box_contact: a candidate must beat the incumbent by
# SAT_TIE_TOL * (|best| + |cand|). A box resting flat on a box is an exact
# tie between face axes of A and B; breaking it the same way keeps this path
# and the JAX package in agreement.
SAT_TIE_TOL = 1e-4


def _first_argmax3(p):
    """Index of the first maximum of the last axis (size 3)."""
    m = torch.zeros(p.shape[:-1], dtype=torch.int64, device=p.device)
    best = p[..., 0]
    for k in (1, 2):
        upd = p[..., k] > best
        best = torch.where(upd, p[..., k], best)
        m = torch.where(upd, k, m)
    return m


def _one_hot3(i, like):
    return (torch.arange(3, device=like.device) == i[..., None]).to(like.dtype)


def _pick(x, i):
    """x (..., 3), i (...,) int64 -> x[..., i]."""
    return torch.gather(x, -1, i[..., None])[..., 0]


def _mat_vec(m, v):
    """(..., 3, 3) @ (..., 3) as multiply-sum."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _mat_t_vec(m, v):
    """(..., 3, 3)^T @ (..., 3) as multiply-sum."""
    return torch.sum(m * v[..., :, None], dim=-2)


def _aabb_clip_planes_local(h, n_local):
    """The 4 side planes of the face most aligned with n_local, box-local.
    Returns (points (..., 4, 3), normals (..., 4, 3))."""
    m = _first_argmax3(torch.abs(n_local))
    e0 = _one_hot3((m + 1) % 3, h)
    e1 = _one_hot3((m + 2) % 3, h)
    normals = torch.stack([e0, e1, -e0, -e1], dim=-2)
    points = torch.stack([-h, -h, h, h], dim=-2)
    return points, normals


def _aabb_incident_vertices_local(h, n_local):
    """The 4 corners of the face pointing against n_local, box-local."""
    m = _first_argmax3(torch.abs(n_local))
    a0 = (m + 1) % 3
    a1 = (m + 2) % 3
    s = torch.where(_pick(n_local, m) < 0.0, 1.0, -1.0)
    em = _one_hot3(m, h)
    e0 = _one_hot3(a0, h)
    e1 = _one_hot3(a1, h)
    d = _pick(h, m) * s
    r0 = _pick(h, a0)[..., None]
    r1 = _pick(h, a1)[..., None]
    base = em * d[..., None]
    return torch.stack([
        base - e0 * r0 - e1 * r1,
        base + e0 * r0 - e1 * r1,
        base + e0 * r0 + e1 * r1,
        base - e0 * r0 + e1 * r1,
    ], dim=-2)


def _aabb_incident_edge_local(h, n_local):
    """The box-local edge most anti-aligned with n_local."""
    p = torch.abs(n_local)
    b_xy = const((1.0, 1.0, -1.0), h) * h    # flip z
    b_xz = const((1.0, -1.0, 1.0), h) * h    # flip y
    b_yz = const((-1.0, 1.0, 1.0), h) * h    # flip x
    p0, p1, p2 = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    out_b = torch.where(p0 > p1, torch.where(p1 > p2, b_xy, b_xz),
                        torch.where(p0 > p2, b_xy, b_yz))
    s = torch.where(n_local < 0.0, -1.0, 1.0)
    return h * s, out_b * s


def _obb_support(c, h, q, n):
    """Support point of an OBB along world direction n."""
    nl = quat_inv_rotate(q, n)
    return c + quat_rotate(q, torch.where(nl >= 0.0, h, -h))


def box_box_contact(ca, ha, qa, cb, hb, qb):
    """Box A (center, half extents, rotation) against box B."""
    dtype = ca.dtype
    Ra = quat_to_mat3(qa)   # columns = world axes of A
    Rb = quat_to_mat3(qb)
    # R[i][j] = dot(axisA_i, axisB_j) = (Ra^T Rb)[i][j]
    R = torch.sum(Ra[..., :, :, None] * Rb[..., :, None, :], dim=-3)
    tw = cb - ca
    t = quat_inv_rotate(qa, tw)

    absR = torch.abs(R) + EPSILON
    parallel = torch.any((absR >= 0.99).flatten(-2), dim=-1)

    # --- face tests (6)
    pen_face_a = ha + _mat_vec(absR, hb) - torch.abs(t)
    pen_face_b = _mat_t_vec(absR, ha) + hb - torch.abs(_mat_t_vec(R, t))

    # --- edge tests (9): axis = e_i x R[:, j] in A-local
    eye = torch.eye(3, dtype=dtype, device=ca.device)
    edge_raw, edge_pen, edge_axes = [], [], []
    for i in range(3):
        for j in range(3):
            axis = cross(eye[i], R[..., :, j])
            k1, k2 = (i + 1) % 3, (i + 2) % 3
            ra = ha[..., k1] * absR[..., k2, j] + ha[..., k2] * absR[..., k1, j]
            l1, l2 = (j + 1) % 3, (j + 2) % 3
            rb = hb[..., l1] * absR[..., i, l2] + hb[..., l2] * absR[..., i, l1]
            dist = torch.abs(dot(t, axis))
            pen_raw = ra + rb - dist
            inv_len = 1.0 / torch.clamp(length(axis), min=1e-30)
            edge_raw.append(pen_raw)
            edge_pen.append(pen_raw * inv_len)
            edge_axes.append(axis * inv_len[..., None])
    edge_raw = torch.stack(edge_raw, dim=-1)
    edge_pen = torch.stack(edge_pen, dim=-1)
    edge_axes = torch.stack(edge_axes, dim=-2)               # (..., 9, 3)

    separated = (torch.any(pen_face_a < 0.0, dim=-1)
                 | torch.any(pen_face_b < 0.0, dim=-1)
                 | (~parallel & torch.any(edge_raw < 0.0, dim=-1)))
    hit = ~separated

    big = 3.4e38
    scores = torch.cat([pen_face_a, pen_face_b,
                        torch.where(parallel[..., None], big, edge_pen)],
                       dim=-1)
    # deterministic tie-break: a later candidate must improve on the
    # incumbent by SAT_TIE_TOL (relative) to win
    best = scores[..., 0]
    winner = torch.zeros(best.shape, dtype=torch.int64, device=ca.device)
    for k in range(1, 15):
        sk = scores[..., k]
        margin = SAT_TIE_TOL * (torch.abs(best) + torch.abs(sk)) + 1e-9
        upd = sk < best - margin
        best = torch.where(upd, sk, best)
        winner = torch.where(upd, k, winner)
    is_face_a = winner < 3
    is_face_b = (winner >= 3) & (winner < 6)
    is_edge = winner >= 6

    # normal in A-local space
    n_face_a = eye[torch.clamp(winner, max=2)]
    col = torch.clamp(winner - 3, 0, 2)
    n_face_b = torch.gather(
        R, -1, col[..., None, None].expand(*col.shape, 3, 1))[..., 0]
    n_edge = torch.gather(
        edge_axes, -2,
        torch.clamp(winner - 6, 0, 8)[..., None, None].expand(
            *winner.shape, 1, 3))[..., 0, :]
    n_local = torch.where(is_face_a[..., None], n_face_a,
                          torch.where(is_face_b[..., None], n_face_b, n_edge))
    normal = quat_rotate(qa, n_local)
    normal = torch.where((dot(normal, tw) < 0.0)[..., None], -normal, normal)

    # ---- face case: reference-face clipping
    fb = is_face_b[..., None]
    ref_c = torch.where(fb, cb, ca)
    ref_h = torch.where(fb, hb, ha)
    ref_q = torch.where(fb, qb, qa)
    inc_c = torch.where(fb, ca, cb)
    inc_h = torch.where(fb, ha, hb)
    inc_q = torch.where(fb, qa, qb)
    ref_n = torch.where(fb, -normal, normal)

    cp_pts_l, cp_nrm_l = _aabb_clip_planes_local(
        ref_h, quat_inv_rotate(ref_q, ref_n))
    inc_v_l = _aabb_incident_vertices_local(
        inc_h, quat_inv_rotate(inc_q, ref_n))
    rq = ref_q[..., None, :].expand(*ref_q.shape[:-1], 4, 4)
    iq = inc_q[..., None, :].expand(*inc_q.shape[:-1], 4, 4)
    cp_pts = quat_rotate(rq, cp_pts_l) + ref_c[..., None, :]
    cp_nrm = quat_rotate(rq, cp_nrm_l)
    inc_v = quat_rotate(iq, inc_v_l) + inc_c[..., None, :]

    ref_plane = make_plane(_obb_support(ref_c, ref_h, ref_q, ref_n), ref_n)
    clip_planes = torch.cat(
        [cp_nrm, -torch.sum(cp_nrm * cp_pts, dim=-1, keepdim=True)], dim=-1)

    lead = ca.shape[:-1]
    zeros_v = inc_v.new_zeros((*lead, POLY_SLOTS - 4, 3))
    poly_v = torch.cat([inc_v, zeros_v], dim=-2)
    poly_d = torch.cat([-signed_distance(inc_v, ref_plane[..., None, :]),
                        zeros_v[..., 0]], dim=-1)
    n4 = torch.full(lead, 4, dtype=torch.int64, device=ca.device)
    poly_v, poly_d, n_pts = sutherland_hodgman(poly_v, poly_d, n4,
                                               clip_planes)
    poly_v, poly_d, n_pts = project_and_filter(poly_v, poly_d, n_pts,
                                               ref_plane)
    face_pts, face_dps, face_count = reduce_manifold(poly_v, poly_d, n_pts,
                                                     normal)
    face_hit = n_pts > 0

    # ---- edge case: closest points between the two incident edges
    a0l, a1l = _aabb_incident_edge_local(ha, quat_inv_rotate(qa, normal))
    b0l, b1l = _aabb_incident_edge_local(hb, quat_inv_rotate(qb, -normal))
    a0 = quat_rotate(qa, a0l) + ca
    a1 = quat_rotate(qa, a1l) + ca
    b0 = quat_rotate(qb, b0l) + cb
    b1 = quat_rotate(qb, b1l) + cb
    pa, pb, sq = closest_point_segment_segment(a0, a1, b0, b1)
    zeros3 = inc_v.new_zeros((*lead, 3, 3))
    edge_pts = torch.cat([((pa + pb) * 0.5)[..., None, :], zeros3], dim=-2)
    edge_dps = torch.cat([sqrt(torch.clamp(sq, min=0.0))[..., None],
                          zeros3[..., 0]], dim=-1)

    e = is_edge
    pts = torch.where(e[..., None, None], edge_pts, face_pts)
    dps = torch.where(e[..., None], edge_dps, face_dps)
    count = torch.where(e, 1, face_count)
    hit = hit & (e | face_hit)
    count = torch.where(hit, count, 0).to(torch.int32)
    return pts, dps, normal, count, hit


# ---------------------------------------------------------------------------
# shared helpers of the other buckets


def _sel(c, a, b):
    """torch.where with the condition `c` (...,) broadcast over the trailing
    dimensions of a and b (a pair's manifold fields)."""
    nd = max(a.dim(), b.dim())
    return torch.where(c.reshape(*c.shape, *([1] * (nd - c.dim()))), a, b)


def _sel_all(c, xs, ys):
    return tuple(_sel(c, x, y) for x, y in zip(xs, ys))


def _up(like):
    return const((0.0, 1.0, 0.0), like).expand(like.shape)


def _slots(rows, like, n=4):
    """(..., n, 3) points from up to n (..., 3) rows, zeros after."""
    zero = torch.zeros_like(like)
    return torch.stack(list(rows) + [zero] * (n - len(rows)), dim=-2)


def _depth_slots(vals, like, n=4):
    """(..., n) depths from up to n (...,) values, zeros after."""
    zero = torch.zeros_like(like)
    return torch.stack(list(vals) + [zero] * (n - len(vals)), dim=-1)


def _one_point(point, depth, normal, hit):
    return (_slots([point], point), _depth_slots([depth], depth), normal,
            torch.where(hit, 1, 0).to(torch.int32), hit)


def _clip3(x, lo, hi):
    """jnp.clip with array bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# sphere family (collision_narrow.cpp:374-495)


def sphere_sphere_contact(c1, r1, c2, r2):
    n = c2 - c1
    radius_sum = r1 + r2
    sq = squared_length(n)
    hit = sq <= radius_sum * radius_sum
    degenerate = sq == 0.0
    dist = sqrt(torch.clamp(sq, min=0.0))
    normal = torch.where(degenerate[..., None], _up(n),
                         n / torch.clamp(dist, min=1e-30)[..., None])
    depth = radius_sum - torch.where(degenerate, 0.0, dist)
    point = 0.5 * (c1 + r1[..., None] * normal + c2 - r2[..., None] * normal)
    return _one_point(point, depth, normal, hit)


def sphere_capsule_contact(sc, sr, ca, cb, cr):
    closest = closest_point_point_segment(sc, ca, cb)
    return sphere_sphere_contact(sc, sr, closest, cr)


def sphere_cylinder_contact(sc, sr, ca, cb, cr):
    """collision_narrow.cpp:408-450: the lateral body behaves like a sphere
    on the axis; beyond the caps, the closest point of the cap disk."""
    ab = cb - ca
    t = dot(sc - ca, ab) / torch.clamp(squared_length(ab), min=1e-12)
    inside = (t >= 0.0) & (t <= 1.0)

    # lateral case
    lat = sphere_sphere_contact(sc, sr, ca + (cb - ca) * t[..., None], cr)

    # cap case
    below = (t <= 0.0)[..., None]
    p = torch.where(below, ca, cb)
    up = torch.where(below, -ab, ab)
    proj = cross(cross(up, sc - p), up)
    proj = proj / torch.clamp(length(proj), min=1e-30)[..., None]
    end_a = p + proj * cr[..., None]
    end_b = p - proj * cr[..., None]
    closest = closest_point_point_segment(sc, end_a, end_b)
    nvec = closest - sc
    sq = squared_length(nvec)
    cap_hit = sq <= sr * sr
    degenerate = sq == 0.0
    dist = sqrt(torch.clamp(sq, min=0.0))
    normal = torch.where(degenerate[..., None], -normalize(up),
                         nvec / torch.clamp(dist, min=1e-30)[..., None])
    depth = sr - torch.where(degenerate, 0.0, dist)
    point = closest + (0.5 * depth)[..., None] * nvec
    cap = _one_point(point, depth, normal, cap_hit)

    return _sel_all(inside, lat, cap)


def sphere_box_contact(sc, sr, bc, bh, bq):
    """Sphere vs OBB via the sphere in box-local space against the AABB
    (collision_narrow.cpp:451-494)."""
    sc_l = quat_inv_rotate(bq, sc - bc)
    p = closest_point_point_aabb(sc_l, -bh, bh)
    n = p - sc_l
    sq = squared_length(n)
    hit = sq <= sr * sr
    dist = sqrt(torch.clamp(sq, min=0.0))
    pos = sq > 0.0
    n = torch.where(pos[..., None], n / torch.clamp(dist, min=1e-30)[..., None],
                    _up(n))
    depth = sr - torch.where(pos, dist, 0.0)
    point_l = 0.5 * (p + sc_l + n * sr[..., None])
    normal = quat_rotate(bq, n)
    point = quat_rotate(bq, point_l) + bc
    return _one_point(point, depth, normal, hit)


# ---------------------------------------------------------------------------
# capsule family (collision_narrow.cpp:523-704)


def _parallel_segments(aa, ab, ar, ba, bb, br):
    """The parallel-axis geometry shared by capsule-capsule,
    capsule-cylinder and cylinder-cylinder: A's unit axis and length, B's
    endpoints ordered along A, B's interval on A's axis, the overlap
    interval's end points on both axes and their separation."""
    a_dir = ab - aa
    a_len = length(a_dir)
    a_dir = a_dir / torch.clamp(a_len, min=1e-30)[..., None]
    b_dir = normalize(bb - ba)
    par = dot(a_dir, b_dir)
    flip = (par < 0.0)[..., None]
    p_ba = torch.where(flip, bb, ba)
    p_bb = torch.where(flip, ba, bb)
    b0 = dot(a_dir, p_ba - aa)
    b1 = dot(a_dir, p_bb - aa)
    left = torch.clamp(b0, min=0.0)
    right = torch.minimum(a_len, b1)
    ca0 = aa + left[..., None] * a_dir
    ca1 = aa + right[..., None] * a_dir
    cb0 = closest_point_point_segment(ca0, p_ba, p_bb)
    cb1 = cb0 + (right - left)[..., None] * a_dir
    nvec = cb0 - ca0
    d = length(nvec)
    return dict(a_dir=a_dir, a_len=a_len, b_dir=b_dir, par=par,
                is_parallel=torch.abs(par) > 0.99, p_ba=p_ba, p_bb=p_bb,
                b0=b0, b1=b1, left=left, right=right,
                overlaps=right >= left, ca0=ca0, ca1=ca1, cb0=cb0, cb1=cb1,
                nvec=nvec, d=d)


def _two_point(g, ar, br):
    """The 2-contact manifold of overlapping parallel intervals."""
    degen = g["d"] < EPSILON
    normal = torch.where(degen[..., None], _up(g["nvec"]),
                         g["nvec"] / torch.clamp(g["d"], min=1e-30)[..., None])
    pen = (ar + br) - torch.where(degen, 0.0, g["d"])
    two_hit = g["overlaps"] & (pen >= 0.0)
    pts2 = _slots([(g["ca0"] + g["cb0"]) * 0.5, (g["ca1"] + g["cb1"]) * 0.5],
                  g["ca0"])
    dps2 = _depth_slots([pen, pen], pen)
    return (pts2, dps2, normal, torch.where(two_hit, 2, 0).to(torch.int32),
            two_hit)


def capsule_capsule_contact(aa, ab, ar, ba, bb, br):
    g = _parallel_segments(aa, ab, ar, ba, bb, br)
    two = _two_point(g, ar, br)

    # disjoint intervals -> end sphere vs end sphere (560-568)
    use_a0 = (0.0 > g["b1"])[..., None]     # a's interval right of b's
    s_a = torch.where(use_a0, aa, ab)
    s_b = torch.where(use_a0, g["p_bb"], g["p_ba"])
    ends = sphere_sphere_contact(s_a, ar, s_b, br)
    par_res = _sel_all(g["overlaps"], two, ends)

    # non-parallel: closest points -> sphere-sphere (606-611)
    c1, c2, _ = closest_point_segment_segment(aa, ab, ba, bb)
    gen = sphere_sphere_contact(c1, ar, c2, br)
    return _sel_all(g["is_parallel"], par_res, gen)


def capsule_cylinder_contact(aa, ab, ar, ba, bb, br):
    """collision_narrow.cpp:614-704: parallel -> 2-point manifold along the
    overlap; otherwise segment-segment closest point -> sphere-cylinder."""
    g = _parallel_segments(aa, ab, ar, ba, bb, br)
    two = _two_point(g, ar, br)

    # parallel but no axial overlap: capsule end sphere vs cylinder
    use_a0 = (0.0 > g["b1"])[..., None]
    s_end = torch.where(use_a0, aa, ab)
    ends = sphere_cylinder_contact(s_end, ar, ba, bb, br)
    par_res = _sel_all(g["overlaps"], two, ends)

    c1, _, _ = closest_point_segment_segment(aa, ab, ba, bb)
    gen = sphere_cylinder_contact(c1, ar, ba, bb, br)
    return _sel_all(g["is_parallel"], par_res, gen)


# ---------------------------------------------------------------------------
# boolean overlap tests for triggers and force fields (overlapCheck,
# collision_narrow.cpp:1593-1689): the contact tests' hit flag


def shapes_overlap(manifold):
    return manifold[4]


# ---------------------------------------------------------------------------
# capsule / cylinder vs box, cylinder-cylinder: closed-form in box-local
# space (collision_narrow.cpp:705-1043)


def _aabb_face_clip_segment(seg_a, seg_b, radius, bh, normal, base):
    """Capsule/cylinder vs box-face manifold enrichment
    (collision_narrow.cpp:731-765): clip the radius-shifted axis segment
    against the side planes of the box face opposing `normal`; box-local,
    box at the origin. Returns (points (..., 4, 3), depths (..., 4),
    count (...,))."""
    aabb_normal = -normal
    ref_point = torch.where(aabb_normal < 0.0, -bh, bh)
    ref_plane = make_plane(ref_point, aabb_normal)

    pa = seg_a + normal * radius[..., None]
    pb = seg_b + normal * radius[..., None]
    poly_v = _slots([pa, pb], pa, POLY_SLOTS)
    poly_d = _depth_slots([-signed_distance(pa, ref_plane),
                           -signed_distance(pb, ref_plane)], radius,
                          POLY_SLOTS)

    cp_pts, cp_nrm = _aabb_clip_planes_local(bh, aabb_normal)
    planes = torch.cat(
        [cp_nrm, -torch.sum(cp_nrm * cp_pts, dim=-1, keepdim=True)], dim=-1)

    n2 = torch.full(radius.shape, 2, dtype=torch.int64, device=radius.device)
    v, dps, n = sutherland_hodgman(poly_v, poly_d, n2, planes)
    v, dps, n = project_and_filter(v, dps, n, ref_plane)
    return reduce_manifold(v, dps, n, base)


def _segment_box_closest(la, lb, bh, iters=8):
    """Closest point pair between segment [la, lb] and the solid AABB
    [-bh, bh] by alternating projection between the two convex sets.
    Returns (s on the segment, q in the box)."""
    s = 0.5 * (la + lb)
    for _ in range(iters):
        q = _clip3(s, -bh, bh)
        s = closest_point_point_segment(q, la, lb)
    q = _clip3(s, -bh, bh)
    return s, q


def _to_world(bq, bc, pts, normal):
    """Box-local manifold points and normal back to world space."""
    q4 = bq[..., None, :].expand(*pts.shape[:-1], 4)
    return quat_rotate(q4, pts) + bc[..., None, :], quat_rotate(bq, normal)


def capsule_box_contact(aa, ab, ar, bc, bh, bq):
    """Capsule vs box (collision_narrow.cpp:705-790 behaviour): the closest
    feature's normal and point from an analytic segment-vs-solid-box
    closest point, a minimum-translation fallback when the segment enters
    the box, and a 2-point face-clipped manifold when the capsule lies
    parallel to a box face. In box-local space."""
    la = quat_inv_rotate(bq, aa - bc)
    lb = quat_inv_rotate(bq, ab - bc)

    s, q = _segment_box_closest(la, lb, bh)
    delta = q - s
    d2 = squared_length(delta)
    inside = d2 <= 1e-12

    # shallow: sphere at the closest point vs the surface point
    dist = sqrt(torch.clamp(d2, min=1e-30))
    n_shallow = delta / dist[..., None]
    depth_shallow = ar - dist
    point_shallow = 0.5 * (s + n_shallow * ar[..., None] + q)

    # deep: minimum-translation face of the deeper inside segment point
    def face_pen(p):
        return bh - torch.abs(p)
    pen_a = torch.amin(face_pen(_clip3(la, -bh, bh)), dim=-1)
    pen_b = torch.amin(face_pen(_clip3(lb, -bh, bh)), dim=-1)
    in_a = torch.all(torch.abs(la) <= bh, dim=-1)
    in_b = torch.all(torch.abs(lb) <= bh, dim=-1)
    p_deep = torch.where((in_a & (~in_b | (pen_a >= pen_b)))[..., None], la,
                         torch.where(in_b[..., None], lb, s))
    fp = face_pen(p_deep)
    k = torch.argmin(fp, dim=-1)
    e_k = _one_hot3(k, la)
    p_k = torch.gather(p_deep, -1, k[..., None])[..., 0]
    sign = torch.where(p_k >= 0.0, 1.0, -1.0)
    n_deep = -sign[..., None] * e_k
    depth_deep = ar + torch.gather(fp, -1, k[..., None])[..., 0]

    normal = torch.where(inside[..., None], n_deep, n_shallow)
    depth = torch.where(inside, depth_deep, depth_shallow)
    point = torch.where(inside[..., None], p_deep, point_shallow)
    hit = inside | (depth_shallow >= 0.0)

    # parallel-to-face manifold enrichment (705-765)
    is_face = torch.any(torch.abs(normal) > 0.99, dim=-1)
    axis = normalize(lb - la)
    parallel = torch.abs(dot(normal, axis)) < 0.01
    enrich = is_face & parallel

    e_pts, e_dps, e_count = _aabb_face_clip_segment(la, lb, ar, bh, normal,
                                                    normal)
    use = enrich & (e_count > 0)

    pts1, dps1, _n1, cnt1, _ = _one_point(point, depth, normal, hit)
    pts = _sel(use, e_pts, pts1)
    dps = _sel(use, e_dps, dps1)
    cnt = torch.where(use, e_count.to(torch.int32), cnt1)

    pts, nrm = _to_world(bq, bc, pts, normal)
    cnt = torch.where(hit, cnt, 0).to(torch.int32)
    return pts, dps, nrm, cnt, hit


def _aabb_face_clip_interval(la, lb, radius, bh, normal):
    """Parameter-interval clip of the radius-shifted axis segment against
    the side planes of the box face opposing `normal` (box-local, AABB at
    the origin). Returns (e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok):
    face-projected end points, depths, live masks, interval validity."""
    absn = torch.abs(normal)
    fk0 = absn[..., 0] > 0.99
    fk1 = ~fk0 & (absn[..., 1] > 0.99)
    pa = la + normal * radius[..., None]
    pb = lb + normal * radius[..., None]

    def sel(i0, i1, i2, v):
        return torch.where(fk0, v[..., i0], torch.where(fk1, v[..., i1],
                                                        v[..., i2]))

    pa_u = sel(1, 0, 0, pa)
    pa_v = sel(2, 2, 1, pa)
    d_u = sel(1, 0, 0, pb) - pa_u
    d_v = sel(2, 2, 1, pb) - pa_v
    h_u = sel(1, 0, 0, bh)
    h_v = sel(2, 2, 1, bh)

    t0 = torch.zeros_like(pa_u)
    t1 = torch.ones_like(pa_u)

    def clip(t0, t1, p, d, h):
        big = 1e30
        for sign in (1.0, -1.0):
            num = sign * h - p
            tcross = num / torch.where(d == 0.0, big, d)
            dpos = (d * sign) > 0.0
            viol = (sign * p) > h
            t1 = torch.where(dpos, torch.minimum(t1, tcross), t1)
            t0 = torch.where(~dpos & (d != 0.0), torch.maximum(t0, tcross), t0)
            t1 = torch.where((d == 0.0) & viol, -1.0, t1)
        return t0, t1

    t0, t1 = clip(t0, t1, pa_u, d_u, h_u)
    t0, t1 = clip(t0, t1, pa_v, d_v, h_v)
    clip_ok = t1 >= t0

    seg_d = pb - pa
    e0 = pa + seg_d * t0[..., None]
    e1 = pa + seg_d * t1[..., None]
    face_h = sel(0, 1, 2, bh)
    n_k = sel(0, 1, 2, normal)
    p0_k = sel(0, 1, 2, e0)
    p1_k = sel(0, 1, 2, e1)
    dp_e0 = n_k * p0_k + face_h
    dp_e1 = n_k * p1_k + face_h
    ref_k = -n_k * face_h

    m = torch.where(fk0[..., None], const((1.0, 0.0, 0.0), la),
                    torch.where(fk1[..., None], const((0.0, 1.0, 0.0), la),
                                const((0.0, 0.0, 1.0), la)))

    def project(p):
        return p * (1.0 - m) + ref_k[..., None] * m

    return (project(e0), project(e1), dp_e0, dp_e1,
            dp_e0 >= 0.0, dp_e1 >= 0.0, clip_ok)


def _snap_sign(x):
    """sign(x) with |x| < 1e-6 snapped to 0: the witness point must not jump
    a whole cap or face over fp dust in a support direction."""
    return torch.sign(torch.where(torch.abs(x) < 1e-6, 0.0, x))


def _cyl_support_local(c, u, hl, r, d):
    """Support point of the cylinder (centre c, unit axis u, half-length
    hl, radius r) along d, closed form; degenerate axial or radial
    components resolve to the feature midpoint."""
    cap = c + u * (hl * _snap_sign(dot(u, d)))[..., None]
    radial = d - dot(d, u)[..., None] * u
    rl = length(radial)
    rad = torch.where((rl > EPSILON)[..., None],
                      radial / torch.clamp(rl, min=1e-30)[..., None]
                      * r[..., None], 0.0)
    return cap + rad


_BIGF = 3.4e38


def _sat_consider(best, n, valid, cid, overlap):
    """One SAT candidate axis: it replaces the incumbent only when its
    overlap is smaller by the relative tie margin."""
    best_ov, best_n, best_id = best
    ov = torch.where(valid, overlap(n), _BIGF)
    take = ov < best_ov - SAT_TIE_TOL * (torch.abs(ov) + torch.abs(best_ov))
    return (torch.where(take, ov, best_ov),
            torch.where(take[..., None], n, best_n),
            torch.where(take, cid, best_id))


def cylinder_box_contact(aa, ab, ar, bc, bh, bq):
    """collision_narrow.cpp:953-1043 behaviour, closed form: the boolean
    from the cylinder's capsule, the exact tube case and a solid-cylinder
    vs box alternating projection; tube contacts by the capsule formula;
    cap and deep contacts by SAT minimum translation over {3 box faces, the
    cylinder axis, 3 axis x box-edge crosses, the lateral closest
    direction}; then face-clip or cap-ring manifold enrichment."""
    la = quat_inv_rotate(bq, aa - bc)
    lb = quat_inv_rotate(bq, ab - bc)

    axis_v = lb - la
    alen = length(axis_v)
    u = axis_v / torch.clamp(alen, min=1e-30)[..., None]
    hl = 0.5 * alen
    cc = 0.5 * (la + lb)

    # exact boolean
    s, q = _segment_box_closest(la, lb, bh)
    delta = q - s
    d2 = squared_length(delta)
    dist_axis = sqrt(torch.clamp(d2, min=1e-30))
    dir_thr = torch.clamp(1e-3 * ar, min=1e-6)
    have_dir = d2 > dir_thr * dir_thr
    tube_case = have_dir & (torch.abs(dot(delta, u)) <= 1e-4 * dist_axis)

    # solid-cylinder / box alternating projection
    p = cc
    for _ in range(32):
        qq = _clip3(p, -bh, bh)
        w = qq - cc
        t = torch.minimum(torch.maximum(dot(w, u), -hl), hl)
        rad = w - dot(w, u)[..., None] * u
        rl = length(rad)
        scale = torch.clamp(ar / torch.clamp(rl, min=1e-30), max=1.0)
        p = cc + t[..., None] * u + rad * scale[..., None]
    qq = _clip3(p, -bh, bh)
    d_cb2 = squared_length(qq - p)
    touch = torch.clamp(1e-3 * ar, min=1e-5)
    cap_hit = d_cb2 <= touch * touch

    # tube contact: the capsule formula
    n_tube = torch.where(have_dir[..., None], delta / dist_axis[..., None],
                         _up(delta))
    depth_tube = ar - dist_axis
    point_tube = 0.5 * (s + n_tube * ar[..., None] + q)

    # cap / deep contact: SAT minimum translation over the candidate axes
    def overlap(n):
        rb = torch.sum(bh * torch.abs(n), dim=-1)
        un = dot(u, n)
        rc = hl * torch.abs(un) + ar * sqrt(torch.clamp(1.0 - un * un,
                                                        min=0.0))
        return rb + rc - torch.abs(dot(cc, n))

    best = (torch.full_like(ar, _BIGF), _up(la),
            torch.full(ar.shape, -1, dtype=torch.int64, device=ar.device))
    eye = torch.eye(3, dtype=la.dtype, device=la.device)
    true = torch.ones_like(have_dir)
    for i in range(3):                                    # box faces
        best = _sat_consider(best, eye[i].expand_as(la), true, i, overlap)
    best = _sat_consider(best, u, alen > EPSILON, 3, overlap)  # axis
    for i in range(3):                                    # u x box edges
        wax = cross(u, eye[i].expand_as(u))
        wl = length(wax)
        wn = wax / torch.clamp(wl, min=1e-30)[..., None]
        best = _sat_consider(best, wn, wl > 1e-6, 4 + i, overlap)
    best = _sat_consider(best, n_tube, have_dir, 7, overlap)  # lateral
    best_ov, best_n, best_id = best

    sgn = torch.where(dot(cc, best_n) >= 0.0, 1.0, -1.0)
    n_sat = -sgn[..., None] * best_n                      # cylinder -> box
    depth_sat = best_ov

    # witness point by winning feature
    pa_face = _cyl_support_local(cc, u, hl, ar, n_sat)
    pt_face = pa_face - (0.5 * depth_sat)[..., None] * n_sat
    pb_u = _snap_sign(-n_sat) * bh
    pt_u = pb_u + (0.5 * depth_sat)[..., None] * n_sat
    pt_mid = 0.5 * (pa_face + pb_u)
    pt_lat = torch.where(have_dir[..., None],
                         0.5 * (s + n_sat * ar[..., None] + q), pt_mid)
    point_sat = torch.where((best_id < 3)[..., None], pt_face,
                            torch.where((best_id == 3)[..., None], pt_u,
                                        pt_lat))

    # the tube direction wins only when it is the smaller pushout
    use_tube = tube_case & (depth_tube <= depth_sat)
    normal = torch.where(use_tube[..., None], n_tube, n_sat)
    depth = torch.where(use_tube, depth_tube, depth_sat)
    point = torch.where(use_tube[..., None], point_tube, point_sat)

    hit = (dist_axis <= ar) & (depth_sat >= 0.0) & (tube_case | cap_hit)

    is_face = torch.any(torch.abs(normal) > 0.99, dim=-1)
    axis = normalize(lb - la)
    cos_angle = torch.abs(dot(normal, axis))
    enrich = is_face & (cos_angle < 0.01)

    e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok = _aabb_face_clip_interval(
        la, lb, ar, bh, normal)
    use = enrich & clip_ok & (m_e0 | m_e1)

    pts1, dps1, _n1, cnt1, _ = _one_point(point, depth, normal, hit)
    first = torch.where(m_e0[..., None], e0p, e1p)
    e_pts = _slots([first, e1p], first)
    e_dps = _depth_slots([torch.where(m_e0, dp_e0, dp_e1), dp_e1], dp_e1)
    e_count = torch.where(m_e0 & m_e1, 2, 1).to(torch.int32)
    pts = _sel(use, e_pts, pts1)
    dps = _sel(use, e_dps, dps1)
    cnt = torch.where(use, e_count, cnt1)

    # cap flat on a box face: 4-point rim ring
    cap_case = is_face & (cos_angle > 0.99)
    cap_c = torch.where((dot(la, normal) > dot(lb, normal))[..., None], la, lb)
    t1c, t2c = get_tangents(normal)
    rr = (ar * 0.95)[..., None]
    ring = torch.stack([cap_c + t1c * rr, cap_c - t1c * rr,
                        cap_c + t2c * rr, cap_c - t2c * rr], dim=-2)
    pts = _sel(cap_case, ring, pts)
    dps = _sel(cap_case, torch.ones_like(dps) * depth[..., None], dps)
    cnt = torch.where(cap_case, 4, cnt).to(torch.int32)

    pts, nrm = _to_world(bq, bc, pts, normal)
    cnt = torch.where(hit, cnt, 0).to(torch.int32)
    return pts, dps, nrm, cnt, hit


def cylinder_cylinder_contact(aa, ab, ar, ba, bb, br):
    """collision_narrow.cpp:821-951: parallel -> cap-to-cap (a 4-point ring
    on the cap-disk intersection) or tube-to-tube (2 contacts); otherwise
    closed form as cylinder_box_contact: the capsule boolean, solid-solid
    alternating projection, exact tube-tube contacts and SAT minimum
    translation over {axis a, axis b, their cross, lateral closest}."""
    g = _parallel_segments(aa, ab, ar, ba, bb, br)
    a_dir, a_len, b_dir = g["a_dir"], g["a_len"], g["b_dir"]
    left, right, b0 = g["left"], g["right"], g["b0"]
    nvec, d = g["nvec"], g["d"]
    pen = (ar + br) - d
    radial_hit = pen >= 0.0

    cap_pen = right - left
    cap_first = cap_pen < pen
    b_right = (b0 > 0.0)[..., None]
    cap_normal = torch.where(b_right, a_dir, -a_dir)
    cap_point = torch.where(b_right, ab - (0.5 * cap_pen)[..., None] * a_dir,
                            aa + (0.5 * cap_pen)[..., None] * a_dir)

    degen = d < EPSILON
    t_normal = torch.where(degen[..., None], _up(nvec),
                           nvec / torch.clamp(d, min=1e-30)[..., None])

    # tube-to-tube 2-point manifold
    pts2 = _slots([(g["ca0"] + g["cb0"]) * 0.5, (g["ca1"] + g["cb1"]) * 0.5],
                  nvec)
    dps2 = _depth_slots([pen, pen], pen)

    # cap-to-cap: 4-point ring on the inscribed circle of the cap-disk
    # intersection lens
    lat = nvec - dot(nvec, a_dir)[..., None] * a_dir
    dl = length(lat)
    lat_dir = torch.where((dl > EPSILON)[..., None],
                          lat / torch.clamp(dl, min=1e-30)[..., None],
                          get_tangents(a_dir)[0])
    lo = torch.maximum(-ar, dl - br)
    hi = torch.minimum(ar, dl + br)
    re = torch.clamp(0.5 * (hi - lo), min=0.0)
    c_off = 0.5 * (lo + hi)
    ring_c = cap_point + lat_dir * c_off[..., None]
    t1 = lat_dir
    t2 = cross(cap_normal, t1)
    rev = re[..., None]
    pts1c = torch.stack([ring_c + t1 * rev, ring_c - t1 * rev,
                         ring_c + t2 * rev, ring_c - t2 * rev], dim=-2)
    dps1c = torch.ones_like(dps2) * cap_pen[..., None]
    ring_ok = re > EPSILON
    pts1c = _sel(ring_ok, pts1c, _slots([cap_point], cap_point))
    dps1c = _sel(ring_ok, dps1c, _depth_slots([cap_pen], cap_pen))
    cap_cnt = torch.where(ring_ok, 4, 1)

    par_hit = g["overlaps"] & radial_hit
    p_pts = _sel(cap_first, pts1c, pts2)
    p_dps = _sel(cap_first, dps1c, dps2)
    p_nrm = torch.where(cap_first[..., None], cap_normal, t_normal)
    p_cnt = torch.where(cap_first, cap_cnt, 2)
    p_cnt = torch.where(par_hit, p_cnt, 0)

    # non-parallel
    ca_c = 0.5 * (aa + ab)
    cb_c = 0.5 * (ba + bb)
    a_hl = 0.5 * a_len
    b_len = length(bb - ba)
    b_hl = 0.5 * b_len
    rsum = ar + br

    c1, c2, dsq = closest_point_segment_segment(aa, ab, ba, bb)
    gdelta = c2 - c1
    gdist = sqrt(torch.clamp(dsq, min=1e-30))
    g_thr = torch.clamp(1e-3 * torch.maximum(ar, br), min=1e-6)
    g_have = dsq > g_thr * g_thr
    perp = (g_have & (torch.abs(dot(gdelta, a_dir)) <= 1e-4 * gdist)
            & (torch.abs(dot(gdelta, b_dir)) <= 1e-4 * gdist))
    n_tt = torch.where(g_have[..., None], gdelta / gdist[..., None],
                       _up(gdelta))
    depth_tt = rsum - gdist
    point_tt = 0.5 * (c1 + n_tt * ar[..., None] + c2 - n_tt * br[..., None])

    def _proj_cyl(x, c, uax, hl, r):
        w = x - c
        t = torch.minimum(torch.maximum(dot(w, uax), -hl), hl)
        rad = w - dot(w, uax)[..., None] * uax
        rl = length(rad)
        scale = torch.clamp(r / torch.clamp(rl, min=1e-30), max=1.0)
        return c + t[..., None] * uax + rad * scale[..., None]

    p = ca_c
    for _ in range(32):
        qq = _proj_cyl(p, cb_c, b_dir, b_hl, br)
        p = _proj_cyl(qq, ca_c, a_dir, a_hl, ar)
    qq = _proj_cyl(p, cb_c, b_dir, b_hl, br)
    d_cc2 = squared_length(qq - p)
    g_touch = torch.clamp(1e-3 * torch.maximum(ar, br), min=1e-5)
    g_caphit = d_cc2 <= g_touch * g_touch

    def cyl_radius_on(n, uax, hl, r):
        un = dot(uax, n)
        return hl * torch.abs(un) + r * sqrt(torch.clamp(1.0 - un * un,
                                                         min=0.0))

    dc = cb_c - ca_c

    def g_overlap(n):
        return (cyl_radius_on(n, a_dir, a_hl, ar)
                + cyl_radius_on(n, b_dir, b_hl, br) - torch.abs(dot(dc, n)))

    best = (torch.full_like(ar, _BIGF), _up(aa),
            torch.full(ar.shape, -1, dtype=torch.int64, device=ar.device))
    best = _sat_consider(best, a_dir, a_len > EPSILON, 0, g_overlap)
    best = _sat_consider(best, b_dir, b_len > EPSILON, 1, g_overlap)
    xax = cross(a_dir, b_dir)
    xl = length(xax)
    best = _sat_consider(best, xax / torch.clamp(xl, min=1e-30)[..., None],
                         xl > 1e-6, 2, g_overlap)
    best = _sat_consider(best, n_tt, g_have, 3, g_overlap)
    g_bo, g_bn, g_bi = best

    g_sgn = torch.where(dot(dc, g_bn) >= 0.0, 1.0, -1.0)
    n_gsat = g_sgn[..., None] * g_bn                       # A -> B
    depth_gsat = g_bo

    pb_sup = _cyl_support_local(cb_c, b_dir, b_hl, br, -n_gsat)
    pa_sup = _cyl_support_local(ca_c, a_dir, a_hl, ar, n_gsat)
    pt_capa = pb_sup + (0.5 * depth_gsat)[..., None] * n_gsat
    pt_capb = pa_sup - (0.5 * depth_gsat)[..., None] * n_gsat
    pt_glat = torch.where(g_have[..., None],
                          0.5 * (c1 + n_gsat * ar[..., None] + c2
                                 - n_gsat * br[..., None]),
                          0.5 * (pa_sup + pb_sup))
    point_gsat = torch.where((g_bi == 0)[..., None], pt_capa,
                             torch.where((g_bi == 1)[..., None], pt_capb,
                                         pt_glat))

    use_tt = perp & (depth_tt <= depth_gsat)
    g_nrm = torch.where(use_tt[..., None], n_tt, n_gsat)
    g_depth = torch.where(use_tt, depth_tt, depth_gsat)
    g_point = torch.where(use_tt[..., None], point_tt, point_gsat)
    g_hit = (gdist <= rsum) & (depth_gsat >= 0.0) & (perp | g_caphit)
    g_pts, g_dps, g_nrm, g_cnt, g_hit = _one_point(g_point, g_depth, g_nrm,
                                                   g_hit)

    par = g["is_parallel"]
    return (_sel(par, p_pts, g_pts), _sel(par, p_dps, g_dps),
            torch.where(par[..., None], p_nrm, g_nrm),
            torch.where(par, p_cnt.to(torch.int32), g_cnt).to(torch.int32),
            torch.where(par, par_hit, g_hit))


# ---------------------------------------------------------------------------
# hull buckets: the fused step's hull recipes (plain versions) on per-pair
# lanes, hull-local for sphere / capsule, world-space polytopes otherwise


def _v3_lanes(x):
    """(..., 3) -> v3 tuple of (...) lanes."""
    return (x[..., 0], x[..., 1], x[..., 2])


def _hull_local_lists(verts, fnorm, foff, fmask):
    """Vertex and plane lists of per-pair hull tables (padded vertices
    repeat vertex 0, harmless for a support argmax)."""
    vlist = [_v3_lanes(verts[..., i, :]) for i in range(verts.shape[-2])]
    planes = [(_v3_lanes(fnorm[..., i, :]), foff[..., i])
              for i in range(fnorm.shape[-2])]
    pvalid = [fmask[..., i] for i in range(fmask.shape[-1])]
    return vlist, planes, pvalid


def sphere_hull_contact(sc, sr, hp, hq, verts, vmask, fnorm, foff, fmask):
    """collision_narrow.cpp:496-522 behaviour: distance GJK on (centre,
    hull) and the face-plane minimum translation for a centre inside
    (ops/kernels/cm_hull.py)."""
    from dxk_tpu_torch.ops.kernels.cm_hull import sphere_hull_core
    p_l = quat_inv_rotate(hq, sc - hp)
    vlist, planes, pvalid = _hull_local_lists(verts, fnorm, foff, fmask)
    pt, depth, nrm, hit = sphere_hull_core(_v3_lanes(p_l), sr, vlist,
                                           planes, pvalid)
    point = quat_rotate(hq, torch.stack(pt, dim=-1)) + hp
    normal = quat_rotate(hq, torch.stack(nrm, dim=-1))
    return _one_point(point, depth, normal, hit)


def capsule_hull_contact(aa, ab, ar, hp, hq, verts, vmask, fnorm, foff,
                         fmask):
    """collision_narrow.cpp:792-820 behaviour, as sphere_hull_contact with
    the segment swept by a ball."""
    from dxk_tpu_torch.ops.kernels.cm_hull import capsule_hull_core
    a_l = quat_inv_rotate(hq, aa - hp)
    b_l = quat_inv_rotate(hq, ab - hp)
    vlist, planes, pvalid = _hull_local_lists(verts, fnorm, foff, fmask)
    pt, depth, nrm, hit = capsule_hull_core(_v3_lanes(a_l), _v3_lanes(b_l),
                                            ar, vlist, planes, pvalid)
    point = quat_rotate(hq, torch.stack(pt, dim=-1)) + hp
    normal = quat_rotate(hq, torch.stack(nrm, dim=-1))
    return _one_point(point, depth, normal, hit)


def _hull_world_topo(hp, hq, verts, pn, po, pm, lp, ll, ed, em, LM):
    """World-space polytope lists (cm_polytope contract) from per-pair hull
    tables; loops padded to LM by repeating their last point."""
    from dxk_tpu_torch.ops.kernels import cm_polytope as cp
    vlist = [_v3_lanes(verts[..., i, :]) for i in range(verts.shape[-2])]
    flist = [(_v3_lanes(pn[..., f, :]), pm[..., f])
             for f in range(pn.shape[-2])]
    llist, llens = [], []
    for f in range(pn.shape[-2]):
        pts = [_v3_lanes(lp[..., f, l, :]) for l in range(lp.shape[-2])]
        while len(pts) < LM:
            pts.append(pts[-1])
        llist.append(tuple(pts))
        llens.append(ll[..., f])
    elist = [(_v3_lanes(ed[..., e, :]), em[..., e])
             for e in range(ed.shape[-2])]
    return cp.hull_topology_world(_v3_lanes(hp), tuple(hq.unbind(-1)), vlist,
                                  flist, llist, llens, elist)


def _stack_manifold(pts, dps, nrm, masks):
    """cm_polytope output -> the (pts, dps, normal, count, hit) contract."""
    cnt = masks[0].to(torch.int32)
    for m in masks[1:]:
        cnt = cnt + m.to(torch.int32)
    hit = cnt > 0
    return (torch.stack([torch.stack(p, dim=-1) for p in pts], dim=-2),
            torch.stack(dps, dim=-1), torch.stack(nrm, dim=-1), cnt, hit)


def cylinder_hull_contact(aa, ab, ar, hp, hq, verts, vmask, pn, po, pm,
                          lp, ll, ed, em):
    """collision_narrow.cpp:1045-1073 behaviour: candidate-axis SAT with
    exact cylinder projection intervals (cm_polytope.cylinder_hull_cm)."""
    from dxk_tpu_torch.ops.kernels.cm_polytope import cylinder_hull_cm
    hw = _hull_world_topo(hp, hq, verts, pn, po, pm, lp, ll, ed, em,
                          lp.shape[-2])
    pts, dps, nrm, hits = cylinder_hull_cm(_v3_lanes(aa), _v3_lanes(ab), ar,
                                           hw)
    return _one_point(torch.stack(pts[0], dim=-1), dps[0],
                      torch.stack(nrm, dim=-1), hits[0])


def box_hull_contact(bc, bh, bq, hp, hq, verts, vmask, pn, po, pm,
                     lp, ll, ed, em):
    """collision_narrow.cpp:1150-1178 behaviour: exact SAT over {box
    faces, hull faces, edge crosses} and a clipped <= 4-point manifold
    (cm_polytope.box_hull_cm)."""
    from dxk_tpu_torch.ops.kernels.cm_polytope import box_hull_cm
    LM = max(4, lp.shape[-2])
    hw = _hull_world_topo(hp, hq, verts, pn, po, pm, lp, ll, ed, em, LM)
    out = box_hull_cm(_v3_lanes(bc), _v3_lanes(bh), tuple(bq.unbind(-1)),
                      hw, LM)
    return _stack_manifold(*out)


def hull_hull_contact(ap, aq, averts, amask, apn, apo, apm, alp, all_, aed,
                      aem, bp, bq, bverts, bmask, bpn, bpo, bpm, blp, bll,
                      bed, bem):
    """collision_narrow.cpp:1558-1584 behaviour: exact SAT over {faces of
    A, faces of B, edge crosses} and a clipped <= 4-point manifold from the
    build-time face loops (cm_polytope.hull_hull_cm)."""
    from dxk_tpu_torch.ops.kernels.cm_polytope import hull_hull_cm
    LM = max(alp.shape[-2], blp.shape[-2])
    hwa = _hull_world_topo(ap, aq, averts, apn, apo, apm, alp, all_, aed,
                           aem, LM)
    hwb = _hull_world_topo(bp, bq, bverts, bpn, bpo, bpm, blp, bll, bed,
                           bem, LM)
    return _stack_manifold(*hull_hull_cm(hwa, hwb))
