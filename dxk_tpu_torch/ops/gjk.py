"""Branchless fixed-iteration GJK boolean intersection test, batched over
pairs: the JAX package's ops/gjk.py (after the reference's
gjkIntersectionTest + updateGJKSimplex, collision_gjk.h:183-238,
collision_gjk.cpp:6-212).

Every branch of the simplex update is computed and mask-selected, and the
reference's unbounded loop is a fixed count with a done flag (its
gjk_unexpected_error becomes "no intersection"). Support points are
(pointA, pointB, minkowski) triples, so a simplex is (P, 4, 3, 3): rows
a/b/c/d, then the fields. Shape parameters are tuples of (P, ...) tensors;
support functions take world-space directions (P, 3).

The 3-term sums here (dot products, squared lengths) are written out as
(x0 + x1) + x2: the CPU's torch.sum over a last dimension of 3 adds in
that order, the card's in another ((x0 + x2) + x1), and EPA on curved
shapes is chaotic in that ulp (a sphere-sphere pair's normal can turn by
radians). Written out, the card computes what the CPU does, bit for bit.

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import const, cross, quat_inv_rotate, \
    quat_rotate, sqrt

GJK_MAX_ITERATIONS = 32


def sum3(p):
    """p (..., 3) summed over its last dimension as (p0 + p1) + p2."""
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def dot(a, b):
    return sum3(a * b)


def squared_length(v):
    return sum3(v * v)


def normalize(v):
    return v / sqrt(squared_length(v))[..., None]


def noz(v):
    """Normalize-or-zero: 0 for ~zero input (core.maths.noz)."""
    sq = squared_length(v)
    ok = sq > 1e-12
    safe = torch.where(ok, sq, 1.0)
    return torch.where(ok[..., None], v * sqrt(1.0 / safe)[..., None], 0.0)


# -- support functions (collision_gjk.h:6-135)


def support_sphere(params, d):
    center, radius = params
    return normalize(d) * radius[..., None] + center


def support_capsule(params, d):
    a, b, radius = params
    farther = torch.where((dot(d, a) > dot(d, b))[..., None], a, b)
    return normalize(d) * radius[..., None] + farther


def support_cylinder(params, d):
    a, b, radius = params
    farther = torch.where((dot(d, a) > dot(d, b))[..., None], a, b)
    n = a - b
    proj = noz(cross(cross(n, d), n))
    return farther + proj * radius[..., None]


def support_box(params, d):
    center, half, q = params
    dl = quat_inv_rotate(q, d)
    return center + quat_rotate(q, torch.where(dl < 0.0, -half, half))


def _first_argmax_row(pts, scores):
    """pts (..., V, 3) at the first maximum of scores (..., V)."""
    i = torch.argmax(scores, dim=-1)
    return torch.gather(pts, -2, i[..., None, None].expand(
        *i.shape, 1, 3))[..., 0, :]


def support_hull(params, d):
    """params: pos (P, 3), q (P, 4), verts (P, V, 3), mask (P, V); the
    first of equal best vertices."""
    pos, q, verts, mask = params
    dl = quat_inv_rotate(q, d)
    scores = torch.where(mask, dot(verts, dl[..., None, :]), -3.4e38)
    return pos + quat_rotate(q, _first_argmax_row(verts, scores))


def support_extruded_triangle(params, d):
    """A triangle and its copy extruded downward (P, 6, 3), used by
    heightmap collision (collision_gjk.h:102-135)."""
    pts = params
    return _first_argmax_row(pts, dot(pts, d[..., None, :]))


def _sp(support_a, support_b, a_params, b_params, d):
    """Minkowski support triples (pA, pB, pA - pB), (P, 3, 3)."""
    pa = support_a(a_params, d)
    pb = support_b(b_params, -d)
    return torch.stack([pa, pb, pa - pb], dim=-2)


def _cross_aba(a, b):
    return cross(cross(a, b), a)


def _w(c, a, b):
    """torch.where with c (P,) over the trailing dimensions of a and b."""
    nd = max(a.dim(), b.dim())
    return torch.where(c.reshape(*c.shape, *([1] * (nd - c.dim()))), a, b)


def gjk_intersection(support_a, support_b, a_params, b_params,
                     max_iterations=GJK_MAX_ITERATIONS):
    """Returns (hit (P,) bool, simplex (P, 4, 3, 3)). The simplex rows are
    the tetrahedron a/b/c/d where hit is true."""
    like = a_params[0]
    P = like.shape[0]
    dir0 = const((1.0, 0.1, -0.2), like).expand(P, 3)  # collision_gjk.h:190

    c = _sp(support_a, support_b, a_params, b_params, dir0)
    fail0 = dot(c[:, 2], dir0) < 0.0
    d1 = -c[:, 2]
    b = _sp(support_a, support_b, a_params, b_params, d1)
    fail1 = dot(b[:, 2], d1) < 0.0
    dirv = _cross_aba(c[:, 2] - b[:, 2], -b[:, 2])

    d = torch.zeros_like(c)
    a_out = torch.zeros_like(c)
    num = torch.full((P,), 2, dtype=torch.int32, device=like.device)
    done = fail0 | fail1
    hit = torch.zeros_like(done)

    for _ in range(max_iterations):
        small = squared_length(dirv) < 0.0001
        a = _sp(support_a, support_b, a_params, b_params, dirv)
        behind = dot(a[:, 2], dirv) < 0.0
        fail_now = ~done & (small | behind)

        # ---- triangle case (numPoints == 2): collision_gjk.cpp:8-53
        ao = -a[:, 2]
        ab = b[:, 2] - a[:, 2]
        ac = c[:, 2] - a[:, 2]
        abc = cross(ab, ac)
        abp = cross(ab, abc)
        acp = cross(abc, ac)
        t_over_ab = dot(ao, abp) > 0.0
        t_over_ac = dot(ao, acp) > 0.0
        t_front = dot(ao, abc) >= 0.0
        t_back = dot(ao, -abc) >= 0.0
        tri_err = ~(t_over_ab | t_over_ac | t_front | t_back)
        # priority: over ab, over ac, front, back
        sel_ab = t_over_ab
        sel_ac = ~t_over_ab & t_over_ac
        sel_fr = ~t_over_ab & ~t_over_ac & t_front
        sel_bk = ~t_over_ab & ~t_over_ac & ~t_front & t_back

        tb2, tc2, td2, tnum2, tdir2 = b, c, d, num, dirv
        tc2 = _w(sel_ab, a, tc2)
        tdir2 = _w(sel_ab, _cross_aba(ab, ao), tdir2)
        tb2 = _w(sel_ac, a, tb2)
        tdir2 = _w(sel_ac, _cross_aba(ac, ao), tdir2)
        td2 = _w(sel_fr, b, td2)
        tb2 = _w(sel_fr, a, tb2)
        tnum2 = torch.where(sel_fr, 3, tnum2)
        tdir2 = _w(sel_fr, abc, tdir2)
        td2 = _w(sel_bk, c, td2)
        tc2 = _w(sel_bk, b, tc2)
        tb2 = _w(sel_bk, a, tb2)
        tnum2 = torch.where(sel_bk, 3, tnum2)
        tdir2 = _w(sel_bk, -abc, tdir2)

        # ---- tetrahedron case (numPoints == 3): collision_gjk.cpp:54-207
        ad = d[:, 2] - a[:, 2]
        abc3 = cross(ac, ab)
        abd3 = cross(ab, ad)
        adc3 = cross(ad, ac)
        flags = ((dot(abc3, ao) > 0.0).to(torch.int32)
                 + 2 * (dot(abd3, ao) > 0.0).to(torch.int32)
                 + 4 * (dot(adc3, ao) > 0.0).to(torch.int32))
        stop = flags == 0
        tet_err = flags == 7
        abc_ab = dot(cross(abc3, ab), ao) > 0.0   # overABC1
        ac_abc = dot(cross(ac, abc3), ao) > 0.0   # overABC2
        abd_ad = dot(cross(abd3, ad), ao) > 0.0   # overABD1
        ab_abd = dot(cross(ab, abd3), ao) > 0.0   # overABD2
        adc_ac = dot(cross(adc3, ac), ao) > 0.0   # overADC1
        ad_adc = dot(cross(ad, adc3), ao) > 0.0   # overADC2

        wh = torch.where
        # actions: 0 line (b, a), 1 line (a, c), 2 line (d, a),
        # 3 tri (b, c, a), 4 tri (b, a, d), 5 tri (a, c, d)
        abc_chain1 = wh(abc_ab, 0, wh(ac_abc, 1, 3))
        abc_chain2 = wh(ac_abc, 1, 3)
        abd_chain1 = wh(abd_ad, 2, wh(ab_abd, 0, 4))
        abd_chain2 = wh(ab_abd, 0, 4)
        adc_chain1 = wh(adc_ac, 1, wh(ad_adc, 2, 5))
        adc_chain2 = wh(ad_adc, 2, 5)
        action = wh(flags == 1, abc_chain1,
                 wh(flags == 2, abd_chain1,
                 wh(flags == 4, adc_chain1,
                 wh(flags == 3, wh(abc_ab, abd_chain1, abc_chain2),
                 wh(flags == 6, wh(abd_ad, adc_chain1, abd_chain2),
                 wh(flags == 5, wh(adc_ac, abc_chain1, adc_chain2),
                    torch.zeros_like(flags)))))))
        is_l0, is_l1, is_l2 = action == 0, action == 1, action == 2
        is_t3, is_t4 = action == 3, action == 4

        qb = _w(is_l0, b, _w(is_l1, a, _w(is_l2, d, _w(is_t3, b,
             _w(is_t4, b, a)))))
        qc = _w(is_l0, a, _w(is_l1, c, _w(is_l2, a, _w(is_t3, c,
             _w(is_t4, a, c)))))
        qd = _w(is_t3, a, d)
        qnum = torch.where(action < 3, 2, 3).to(torch.int32)
        qdir = _w(is_l0, _cross_aba(ab, ao), _w(is_l1, _cross_aba(ac, ao),
               _w(is_l2, _cross_aba(ad, ao), _w(is_t3, abc3,
               _w(is_t4, abd3, adc3)))))

        in_tri = num == 2
        nb = _w(in_tri, tb2, qb)
        nc = _w(in_tri, tc2, qc)
        ndd = _w(in_tri, td2, qd)
        nnum = torch.where(in_tri, tnum2, qnum)
        ndir = _w(in_tri, tdir2, qdir)
        err = torch.where(in_tri, tri_err, tet_err)
        got_hit = ~in_tri & stop

        # update only live lanes; on convergence b/c/d stay and `a`
        # completes the tetrahedron
        act = ~done & ~fail_now
        upd = act & ~got_hit
        b = _w(upd, nb, b)
        c = _w(upd, nc, c)
        d = _w(upd, ndd, d)
        num = torch.where(upd, nnum, num)
        dirv = _w(upd, ndir, dirv)
        a_out = _w(act & got_hit, a, a_out)
        hit = hit | (act & got_hit)
        done = done | fail_now | (act & (got_hit | err))

    hit = hit & ~(fail0 | fail1)
    return hit, torch.stack([a_out, b, c, d], dim=1)
