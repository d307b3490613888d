"""Distance GJK on component-major lane tuples — the plain PyTorch form of
the distance GJK that ``csrc/fused_step.cu`` runs for the sphere-hull and
capsule-hull recipes and for the boolean gate of the cylinder-hull recipe.

Computes the distance and closest-point witnesses between two convex
shapes from their support functions (the margin trick of the hull
recipes: a capsule is a segment swept by a ball, so the segment-to-hull
distance gives the exact contact depth; see cm_hull.py). The same math,
in the same operation order, as the JAX package's
``ops/pallas/gjk_distance.py``.

Everything is a v3 tuple of same-shaped tensors (cm_narrowphase
conventions). The simplex is 4 fixed slots of (wA, wB, w = wA - wB) with
validity masks; the closest point on the simplex is computed branchlessly
over its 4 triangles (Ericson 5.1.5, every region mask-selected) and the
new support replaces the valid slot with the smallest barycentric weight
(first slot on ties). A fixed number of iterations (24 unless the caller
asks for another); once a lane is done its simplex no longer changes.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import sqrt
from dxk_tpu_torch.ops.kernels.cm_narrowphase import (_add, _cross, _dot,
                                                      _max, _muls, _sub,
                                                      _sqlen, _where)

_BIG = 3.4e38


def _closest_pt_triangle(p0, a, b, c):
    """Closest point to the query p0 on triangle abc. Returns
    (q, (u, v, w)) with q = u*a + v*b + w*c."""
    ab = _sub(b, a)
    ac = _sub(c, a)
    ap = _sub(p0, a)
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = _sub(p0, b)
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = _sub(p0, c)
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    # region masks, in Ericson's order (first hit wins)
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    vc = d1 * d4 - d3 * d2
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    vb = d5 * d2 - d1 * d6
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    va = d3 * d6 - d5 * d4
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    def nz(x):
        return torch.where(torch.abs(x) > 1e-30, x, 1e-30)

    t_ab = d1 / nz(d1 - d3)
    t_ac = d2 / nz(d2 - d6)
    t_bc = (d4 - d3) / nz((d4 - d3) + (d5 - d6))
    denom = 1.0 / nz(va + vb + vc)
    v_in = vb * denom
    w_in = vc * denom

    one = torch.ones_like(d1)
    zero = torch.zeros_like(d1)

    # priority select: a, b, ab, c, ac, bc, interior
    sel_a = in_a
    sel_b = ~sel_a & in_b
    sel_ab = ~sel_a & ~sel_b & on_ab
    sel_c = ~sel_a & ~sel_b & ~sel_ab & in_c
    sel_ac = ~sel_a & ~sel_b & ~sel_ab & ~sel_c & on_ac
    sel_bc = ~sel_a & ~sel_b & ~sel_ab & ~sel_c & ~sel_ac & on_bc
    sel_in = ~sel_a & ~sel_b & ~sel_ab & ~sel_c & ~sel_ac & ~sel_bc

    u = (torch.where(sel_a, one, zero)
         + torch.where(sel_ab, 1.0 - t_ab, zero)
         + torch.where(sel_ac, 1.0 - t_ac, zero)
         + torch.where(sel_in, 1.0 - v_in - w_in, zero))
    v = (torch.where(sel_b, one, zero)
         + torch.where(sel_ab, t_ab, zero)
         + torch.where(sel_bc, 1.0 - t_bc, zero)
         + torch.where(sel_in, v_in, zero))
    w = (torch.where(sel_c, one, zero)
         + torch.where(sel_ac, t_ac, zero)
         + torch.where(sel_bc, t_bc, zero)
         + torch.where(sel_in, w_in, zero))

    q = _add(_add(_muls(a, u), _muls(b, v)), _muls(c, w))
    return q, (u, v, w)


def _origin_in_tetra(ws, ext2):
    """True where the origin is strictly inside the (non-degenerate)
    tetrahedron spanned by the 4 slots; the volume threshold is relative
    to the simplex extent."""
    a, b, c, d = ws
    vol = _dot(_cross(_sub(b, a), _sub(c, a)), _sub(d, a))
    nondeg = vol * vol > 1e-10 * ext2 * ext2 * ext2

    def same_side(p1, p2, p3, p4):
        n = _cross(_sub(p2, p1), _sub(p3, p1))
        s4 = _dot(n, _sub(p4, p1))
        s0 = -_dot(n, p1)                     # dot(n, origin - p1)
        return s4 * s0 >= 0.0

    return (nondeg & same_side(a, b, c, d) & same_side(a, b, d, c)
            & same_side(a, c, d, b) & same_side(b, c, d, a))


def _simplex_closest(ws):
    """Closest point to the origin on the simplex of the 4 slots (unused
    slots duplicate used ones). Returns (q v3, lambdas[4]); q snaps to zero
    when the origin is inside the tetrahedron."""
    zero3 = (torch.zeros_like(ws[0][0]),) * 3

    best_d = torch.full_like(ws[0][0], _BIG)
    best_q = zero3
    best_l = [torch.zeros_like(ws[0][0]) for _ in range(4)]

    for (i, j, k) in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
        q, (u, v, w) = _closest_pt_triangle(zero3, ws[i], ws[j], ws[k])
        d = _sqlen(q)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_q = _where(take, q, best_q)
        lam = [torch.zeros_like(u) for _ in range(4)]
        lam[i] = u
        lam[j] = v
        lam[k] = w
        best_l = [torch.where(take, ln, bo) for ln, bo in zip(lam, best_l)]

    ext2 = torch.maximum(torch.maximum(_sqlen(ws[0]), _sqlen(ws[1])),
                         torch.maximum(_sqlen(ws[2]), _sqlen(ws[3])))
    inside = _origin_in_tetra(ws, ext2)
    best_q = _where(inside, zero3, best_q)
    return best_q, best_l


def gjk_distance(support_a, support_b, a_params, b_params,
                 max_iterations=24, stats=None):
    """Distance + witnesses between two convex shapes given support
    functions `support(params, d v3) -> v3`.

    Returns (dist, qa v3, qb v3, overlap): the separation distance
    (~0 when overlapping), the closest-point witnesses on A and B, and
    True where the shapes (numerically) intersect. When `stats` is a dict,
    stats["iterations"] receives the iterations each lane runs before it
    is done (what the kernel, which stops a lane there, executes)."""
    def sup_pair(d):
        pa = support_a(a_params, d)
        pb = support_b(b_params, (-d[0], -d[1], -d[2]))
        return pa, pb, _sub(pa, pb)

    # initial direction: fixed
    shape_probe = support_a(a_params, (1.0, 0.0, 0.0))
    onel = torch.ones_like(shape_probe[0])
    zerol = torch.zeros_like(shape_probe[0])
    dir0 = (onel, 0.1 * onel, -0.2 * onel)

    pa0, pb0, w0 = sup_pair(dir0)
    was = [pa0, pa0, pa0, pa0]
    wbs = [pb0, pb0, pb0, pb0]
    ws = [w0, w0, w0, w0]
    valid = [onel > 0.0, onel < 0.0, onel < 0.0, onel < 0.0]

    q = w0
    lams = [onel, zerol, zerol, zerol]
    overlap = torch.zeros_like(onel, dtype=torch.bool)
    done = torch.zeros_like(onel, dtype=torch.bool)
    iters = torch.zeros_like(onel, dtype=torch.int32)

    ext2 = _sqlen(w0)
    for _ in range(max_iterations):
        iters = iters + (~done).to(torch.int32)
        # new support toward the origin
        d2q = _sqlen(q)
        deg = d2q <= 1e-12 * (ext2 + 1e-12)   # at the origin: overlapping
        overlap = overlap | (~done & deg)
        done = done | deg

        nd = _muls(q, -1.0 / sqrt(_max(d2q, 1e-30)))
        pa, pb, w = sup_pair(nd)
        ext2 = torch.maximum(ext2, _sqlen(w))

        # convergence: no meaningful relative progress toward the origin
        prog = d2q - _dot(q, w)
        no_prog = prog <= 1e-6 * d2q + 1e-12 * ext2
        done = done | no_prog

        # replace the valid slot with the smallest barycentric weight (or
        # the first invalid slot); skip when done
        scores = [torch.where(valid[i], lams[i], -1.0) for i in range(4)]
        m01 = scores[0] <= scores[1]
        i01 = torch.where(m01, 0, 1)
        s01 = torch.where(m01, scores[0], scores[1])
        m23 = scores[2] <= scores[3]
        i23 = torch.where(m23, 2, 3)
        s23 = torch.where(m23, scores[2], scores[3])
        repl = torch.where(s01 <= s23, i01, i23)

        upd = ~done
        for i in range(4):
            sel = upd & (repl == i)
            was[i] = _where(sel, pa, was[i])
            wbs[i] = _where(sel, pb, wbs[i])
            ws[i] = _where(sel, w, ws[i])
            valid[i] = valid[i] | sel

        q, lams = _simplex_closest(ws)

    dist = sqrt(_max(_sqlen(q), 0.0))
    overlap = overlap | (dist <= 1e-9)

    qa = (zerol,) * 3
    qb = (zerol,) * 3
    for i in range(4):
        qa = _add(qa, _muls(was[i], lams[i]))
        qb = _add(qb, _muls(wbs[i], lams[i]))
    if stats is not None:
        stats["iterations"] = iters
    return dist, qa, qb, overlap
