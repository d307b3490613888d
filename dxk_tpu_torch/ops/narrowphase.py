"""Narrowphase contact generation of the reference (non-fused) step,
batched over any leading dimensions: the port's counterpart of the JAX
package's ops/narrowphase.py. Each `*_contact` function returns a fixed
4-slot manifold per pair, `(points (..., 4, 3), depths (..., 4),
normal (..., 3), count (...,) int32, hit (...,) bool)`; all branches are
evaluated and mask-selected. Normals point from collider A to collider B.

Ported so far: box-box (15-axis SAT, reference-face clipping, edge-edge
closest points). This is the recipe the reference step calls, with its own
operation order; the fused step's component-major recipe is
ops/kernels/cm_narrowphase.py::box_box_cm.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import (cross, dot, length, quat_inv_rotate,
                                      quat_rotate, quat_to_mat3,
                                      squared_length)
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


def _vec(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


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


def closest_point_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2] (Ericson 5.1.9).
    Returns (c1, c2, sq_distance)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = squared_length(d1)
    e = squared_length(d2)
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = a * e - b * b

    ok = denom > 1e-12
    s = torch.where(ok, torch.clamp((b * f - c * e)
                                    / torch.where(ok, denom, 1.0), 0.0, 1.0),
                    0.0)
    t = (b * s + f) / torch.clamp(e, min=1e-12)

    s = torch.where(t < 0.0, torch.clamp(-c / torch.clamp(a, min=1e-12),
                                         0.0, 1.0),
                    torch.where(t > 1.0,
                                torch.clamp((b - c) / torch.clamp(a, min=1e-12),
                                            0.0, 1.0), s))
    t = torch.clamp(t, 0.0, 1.0)

    # degenerate segments
    both_pts = (a <= 1e-12) & (e <= 1e-12)
    s = torch.where(both_pts, 0.0, torch.where(a <= 1e-12, 0.0, s))
    t = torch.where(both_pts, 0.0, torch.where(e <= 1e-12, 0.0, t))

    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    return c1, c2, squared_length(c1 - c2)


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
    b_xy = _vec([1.0, 1.0, -1.0], h) * h    # flip z
    b_xz = _vec([1.0, -1.0, 1.0], h) * h    # flip y
    b_yz = _vec([-1.0, 1.0, 1.0], h) * h    # flip x
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
    edge_dps = torch.cat([torch.sqrt(torch.clamp(sq, min=0.0))[..., None],
                          zeros3[..., 0]], dim=-1)

    e = is_edge
    pts = torch.where(e[..., None, None], edge_pts, face_pts)
    dps = torch.where(e[..., None], edge_dps, face_dps)
    count = torch.where(e, 1, face_count)
    hit = hit & (e | face_hit)
    count = torch.where(hit, count, 0).to(torch.int32)
    return pts, dps, normal, count, hit
