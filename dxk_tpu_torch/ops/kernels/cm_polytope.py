"""Convex-polytope contacts on component-major lane tuples — exact SAT +
reference-face clipping for box-hull and hull-hull pairs, candidate-axis
SAT for cylinder-hull: the plain PyTorch form of the box-hull, hull-hull
and cylinder-hull recipes of ``csrc/fused_step.cu``, in the same operation
order as the JAX package's ``ops/pallas/cm_polytope.py``.

For two polytopes the separating-axis set {face normals of A, face
normals of B, edge-direction cross products} is finite and complete, so
the minimum translation is found by brute force over the build-time
merged faces and deduplicated edge directions (scene/hull_topology.py).
A face winner gives a <= 4-point manifold by Sutherland-Hodgman clipping
the incident face loop against the reference face loop (the clip, filter
and reduction of box_box_cm, on S = 2 LM slots); an edge winner gives one
closest-point contact. Winner order and ties as in box_box_cm: faces of
A, then faces of B, then edges; an earlier candidate wins within the
relative SAT_TIE_TOL.

Inputs are WORLD-space lists:
  verts:  list[V] of v3             polytope vertices
  faces:  list[F] of (n v3, valid)  outward unit face normals
  loops:  list[F] of (list[LM] of v3, length lane)   ordered CCW around n
  edges:  list[E] of (d v3, valid)  unique unit edge directions
Loops are padded to a COMMON LM on both sides (repeat the last point).
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import sqrt
from dxk_tpu_torch.ops.kernels.cm_narrowphase import (
    SAT_TIE_TOL, _add, _clip, _clip_one_plane_cm, _cross, _dot, _max, _muls,
    _neg, _project_filter_cm, _reduce_manifold_cm, _sqlen, _sub, _where,
    quat_rotate_cm)

_BIG = 3.4e38


def _tree_where(c, a, b):
    """torch.where over matching nested tuples of tensors."""
    if isinstance(a, tuple):
        return tuple(_tree_where(c, x, y) for x, y in zip(a, b))
    return torch.where(c, a, b)


def _interval(verts, n):
    """(min, max) of dot(v, n) over a vertex list."""
    s0 = _dot(verts[0], n)
    mn = mx = s0
    for v in verts[1:]:
        s = _dot(v, n)
        mn = torch.minimum(mn, s)
        mx = torch.maximum(mx, s)
    return mn, mx


def _support(verts, n):
    """Vertex of the list maximizing dot(v, n) (first max wins)."""
    best = verts[0]
    bs = _dot(best, n)
    for v in verts[1:]:
        s = _dot(v, n)
        take = s > bs
        bs = torch.where(take, s, bs)
        best = _where(take, v, best)
    return best


def _centroid(verts):
    inv = 1.0 / len(verts)
    c = verts[0]
    for v in verts[1:]:
        c = _add(c, v)
    return _muls(c, inv)


def _sat_update(best, ov, payload, margin_tol=SAT_TIE_TOL):
    """One relative-tie-tolerance argmin step (first min wins within the
    margin). best = (ov, payload...); payload entries may be nested tuples
    of lanes."""
    bs = best[0]
    margin = margin_tol * (torch.abs(bs) + torch.abs(ov)) + 1e-9
    upd = ov < bs - margin
    out = [torch.where(upd, ov, bs)]
    for new, old in zip(payload, best[1:]):
        out.append(_tree_where(upd, new, old))
    return tuple(out)


def _face_scan(faces, loops, verts_self, verts_other):
    """Best (min-overlap) face axis of one side; n is the side's OUTWARD
    face normal. Overlap along n: max_self(n) - min_other(n). Returns
    (ov, n, loop_pts, loop_len, separated)."""
    zero = torch.zeros_like(_dot(verts_self[0], verts_self[0]))
    LM = len(loops[0][0])
    best = (torch.full_like(zero, _BIG), (zero, zero, zero),
            tuple((zero, zero, zero) for _ in range(LM)),
            torch.zeros_like(zero, dtype=torch.int32))
    separated = zero > torch.ones_like(zero)      # all-False
    for (n, valid), (loop, llen) in zip(faces, loops):
        mx_s = _dot(verts_self[0], n)
        for v in verts_self[1:]:
            mx_s = torch.maximum(mx_s, _dot(v, n))
        mn_o, _ = _interval(verts_other, n)
        ov = mx_s - mn_o
        separated = separated | (valid & (ov < 0.0))
        ov = torch.where(valid, ov, _BIG)
        best = _sat_update(best, ov, (n, tuple(loop), llen))
    return best + (separated,)


def _edge_scan(edges_a, edges_b, verts_a, verts_b, ca, cb):
    """Best (min-overlap) edge-cross axis, oriented A->B via centroids;
    near-parallel crosses are masked out. Returns
    (ov, axis, da, db, separated)."""
    zero = torch.zeros_like(_dot(verts_a[0], verts_a[0]))
    best = (torch.full_like(zero, _BIG), (zero, zero, zero),
            (zero, zero, zero), (zero, zero, zero))
    separated = zero > torch.ones_like(zero)
    cab = _sub(cb, ca)
    for da, va in edges_a:
        for db, vb in edges_b:
            ax = _cross(da, db)
            l2 = _sqlen(ax)
            ok = va & vb & (l2 > 1e-10)
            axn = _muls(ax, 1.0 / sqrt(_max(l2, 1e-30)))
            s = torch.where(_dot(axn, cab) < 0.0, -1.0, 1.0)
            axn = _muls(axn, s)
            mxa = _dot(verts_a[0], axn)
            for v in verts_a[1:]:
                mxa = torch.maximum(mxa, _dot(v, axn))
            mnb = _dot(verts_b[0], axn)
            for v in verts_b[1:]:
                mnb = torch.minimum(mnb, _dot(v, axn))
            ov = mxa - mnb
            separated = separated | (ok & (ov < 0.0))
            ov = torch.where(ok, ov, _BIG)
            best = _sat_update(best, ov, (axn, da, db))
    return best + (separated,)


def _select_incident(faces, loops, ref_n):
    """Face of the OTHER side most antiparallel to the reference normal:
    argmax of dot(fn, -ref_n). Returns (loop_pts, loop_len)."""
    zero = torch.zeros_like(ref_n[0])
    LM = len(loops[0][0])
    bs = torch.full_like(zero, -_BIG)
    bl = tuple((zero, zero, zero) for _ in range(LM))
    bn = torch.zeros_like(zero, dtype=torch.int32)
    for (n, valid), (loop, llen) in zip(faces, loops):
        s = torch.where(valid, -_dot(n, ref_n), -_BIG)
        take = s > bs
        bs = torch.where(take, s, bs)
        bl = _tree_where(take, tuple(loop), bl)
        bn = torch.where(take, llen, bn)
    return bl, bn


def polytope_polytope_core(verts_a, faces_a, loops_a, edges_a,
                           verts_b, faces_b, loops_b, edges_b, stats=None):
    """Exact SAT + reference-face clip between two convex polytopes.
    Returns (pts[4] v3, dps[4], normal v3 (A->B), masks[4]) in world
    space. When `stats` is a dict, stats["which"] receives the SAT winner
    per lane: 0 a face of A, 1 a face of B, 2 an edge pair."""
    zero = torch.zeros_like(_dot(verts_a[0], verts_a[0]))
    LM = len(loops_a[0][0])
    assert LM == len(loops_b[0][0]), "loops must share a common LM padding"

    ca = _centroid(verts_a)
    cb = _centroid(verts_b)

    ov_a, n_a, loop_a, len_a, sep_a = _face_scan(
        faces_a, loops_a, verts_a, verts_b)
    ov_b, n_b, loop_b, len_b, sep_b = _face_scan(
        faces_b, loops_b, verts_b, verts_a)
    ov_e, ax_e, da_e, db_e, sep_e = _edge_scan(
        edges_a, edges_b, verts_a, verts_b, ca, cb)

    hit = ~(sep_a | sep_b | sep_e)

    # 3-way winner: faces of A, then faces of B, then edges
    best = (ov_a, torch.zeros_like(zero, dtype=torch.int32))
    best = _sat_update(best, ov_b, (torch.ones_like(best[1]),))
    best = _sat_update(best, ov_e, (torch.full_like(best[1], 2),))
    which = best[1]
    is_face_a = which == 0
    is_face_b = which == 1
    is_edge = which == 2
    best_ov = best[0]

    # world normal pointing A -> B (face-A: +n_a; face-B: -n_b; edge: +ax)
    normal = _where(is_face_a, n_a, _where(is_face_b, _neg(n_b), ax_e))

    # ---- face case: clip incident loop against reference loop ------------
    ref_n = _where(is_face_b, n_b, n_a)          # outward from ref side
    ref_loop = _where_loop(is_face_b, loop_b, loop_a)
    ref_len = torch.where(is_face_b, len_b, len_a)
    inc_from_b = _select_incident(faces_b, loops_b, ref_n)
    inc_from_a = _select_incident(faces_a, loops_a, ref_n)
    inc_loop = _where_loop(is_face_b, inc_from_a[0], inc_from_b[0])
    inc_len = torch.where(is_face_b, inc_from_a[1], inc_from_b[1])

    rp_d = -_dot(ref_n, ref_loop[0])             # ref face plane offset

    S = 2 * LM
    zv = (zero, zero, zero)
    verts = list(inc_loop) + [zv] * (S - LM)
    depths = [-(_dot(v, ref_n) + rp_d) for v in inc_loop] \
        + [zero] * (S - LM)
    nn = inc_len
    for i in range(LM):
        start = ref_loop[i]
        is_wrap = ref_len - 1 == i
        end = _where(is_wrap, ref_loop[0], ref_loop[(i + 1) % LM])
        side_n = _cross(ref_n, _sub(end, start))  # inward for CCW loops
        pd = -_dot(side_n, start)
        nv, nd, nnn = _clip_one_plane_cm(verts, depths, nn, side_n, pd)
        use = ref_len > i
        verts = [_where(use, a, b) for a, b in zip(nv, verts)]
        depths = [torch.where(use, a, b) for a, b in zip(nd, depths)]
        nn = torch.where(use, nnn, nn)
    verts, depths, nn = _project_filter_cm(verts, depths, nn, ref_n, rp_d)
    f_pts, f_dps, f_cnt = _reduce_manifold_cm(verts, depths, nn, normal)
    face_hit = nn > 0

    # ---- edge case: closest point between the two support LINES ----------
    a_sup = _support(verts_a, ax_e)
    b_sup = _support(verts_b, _neg(ax_e))
    r = _sub(b_sup, a_sup)
    a11 = _sqlen(da_e)
    a22 = _sqlen(db_e)
    a12 = -_dot(da_e, db_e)
    b1 = _dot(da_e, r)
    b2 = -_dot(db_e, r)
    det = a11 * a22 - a12 * a12
    ok = det > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    s = torch.where(ok, (b1 * a22 - b2 * a12) * inv, 0.0)
    t = torch.where(ok, (a11 * b2 - a12 * b1) * inv, 0.0)
    pa = _add(a_sup, _muls(da_e, s))
    pb = _add(b_sup, _muls(db_e, t))
    e_pt = _muls(_add(pa, pb), 0.5)
    e_dp = best_ov

    pts = [_where(is_edge, e_pt, f_pts[k]) for k in range(4)]
    dps = [torch.where(is_edge, e_dp if k == 0 else zero, f_dps[k])
           for k in range(4)]
    count = torch.where(is_edge, 1, f_cnt)
    hit = hit & (is_edge | face_hit)
    count = torch.where(hit, count, 0)
    masks = [(k < count) for k in range(4)]
    if stats is not None:
        stats["which"] = which
    return pts, dps, normal, masks


def _where_loop(c, la, lb):
    return tuple(_where(c, a, b) for a, b in zip(la, lb))


# ===========================================================================
# world-space topology builders


def box_topology_world(bc, bh, bq, LM):
    """Box (center, half-extents, quat) as world-space polytope lists:
    8 verts, 6 faces with 4-point CCW loops (padded to LM), 3 edge dirs."""
    one = torch.ones_like(bh[0])
    zero = torch.zeros_like(bh[0])
    true = one > zero
    ex, ey, ez = (one, zero, zero), (zero, one, zero), (zero, zero, one)
    ax = [quat_rotate_cm(bq, e) for e in (ex, ey, ez)]

    def corner(sx, sy, sz):
        l = (sx * bh[0], sy * bh[1], sz * bh[2])
        return _add(quat_rotate_cm(bq, l), bc)

    verts = [corner(sx, sy, sz)
             for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
             for sz in (-1.0, 1.0)]

    faces, loops = [], []
    llen = torch.full_like(zero, 4).to(torch.int32)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3

        def face_loop(si, order):
            out = []
            for sj, sk in order:
                s = [0.0, 0.0, 0.0]
                s[i], s[j], s[k] = si, sj, sk
                l = (s[0] * bh[0], s[1] * bh[1], s[2] * bh[2])
                out.append(_add(quat_rotate_cm(bq, l), bc))
            while len(out) < LM:
                out.append(out[-1])
            return tuple(out)

        # CCW around the outward normal (cross(n, edge) points inward)
        faces.append((ax[i], true))
        loops.append((face_loop(1.0, ((1, -1), (1, 1), (-1, 1), (-1, -1))),
                      llen))
        faces.append((_neg(ax[i]), true))
        loops.append((face_loop(-1.0, ((-1, -1), (-1, 1), (1, 1), (1, -1))),
                      llen))
    edges = [(ax[i], true) for i in range(3)]
    return verts, faces, loops, edges


def hull_topology_world(hp, hq, vlist, flist, llist, llens, elist):
    """Rotate hull-local topology lists to world. vlist: list[V] v3;
    flist: list[F] (n v3, valid); llist: list[F] of list[LM] v3; llens:
    list[F] lanes; elist: list[E] (d v3, valid)."""
    verts = [_add(quat_rotate_cm(hq, v), hp) for v in vlist]
    faces = [(quat_rotate_cm(hq, n), valid) for n, valid in flist]
    loops = [(tuple(_add(quat_rotate_cm(hq, p), hp) for p in loop), ll)
             for loop, ll in zip(llist, llens)]
    edges = [(quat_rotate_cm(hq, d), valid) for d, valid in elist]
    return verts, faces, loops, edges


def box_hull_cm(bc, bh, bq, hulls_world, LM, stats=None):
    """Box vs hull via the polytope core (box = side a). hulls_world =
    (verts, faces, loops, edges) world lists of the hull side, loops
    padded to LM."""
    va, fa, la, ea = box_topology_world(bc, bh, bq, LM)
    vb, fb, lb, eb = hulls_world
    return polytope_polytope_core(va, fa, la, ea, vb, fb, lb, eb, stats)


def hull_hull_cm(hulls_world_a, hulls_world_b, stats=None):
    va, fa, la, ea = hulls_world_a
    vb, fb, lb, eb = hulls_world_b
    return polytope_polytope_core(va, fa, la, ea, vb, fb, lb, eb, stats)


# ===========================================================================
# cylinder-hull: candidate-axis SAT, single contact


def cylinder_hull_cm(ca, cb2, cr, hulls_world, stats=None):
    """Cylinder (axis endpoints ca..cb2, radius cr) vs hull. The cylinder
    is smooth, so the SAT runs over a candidate axis set that covers every
    feature pairing: the hull's face normals, the cylinder axis, hull edge
    direction x cylinder axis, and the direction from the clamped closest
    axis point to each hull vertex. The cylinder's projection along a unit
    axis n is centre +- (h |n.a| + r sqrt(1 - (n.a)^2)), exact, so each
    candidate's overlap is exact. Then 8 rounds of support-witness descent
    from the best axis (keeping the minimum), and a 16-iteration distance
    GJK decides the boolean (the candidates can miss a separating axis in
    rim-vs-edge configurations); the SAT gives the depth. Returns
    (pts[1], dps[1], normal (cyl->hull), masks[1]). When `stats` is a
    dict it receives "sat" (the SAT found no separating axis), "gate" (the
    GJK found the shapes touching) and the GJK's "iterations"."""
    verts_h, faces_h, _loops_h, edges_h = hulls_world
    m = _muls(_add(ca, cb2), 0.5)
    axv = _sub(cb2, ca)
    hlen = 0.5 * sqrt(_max(_sqlen(axv), 0.0))
    adir = _muls(axv, 1.0 / _max(2.0 * hlen, 1e-30))
    zero = torch.zeros_like(cr)

    def cyl_interval(n):
        na = _dot(n, adir)
        perp = sqrt(_max(1.0 - na * na, 0.0))
        half = hlen * torch.abs(na) + cr * perp
        c = _dot(m, n)
        return c - half, c + half

    best_ov = torch.full_like(zero, _BIG)
    best_n = (zero, zero, torch.ones_like(zero))
    separated = zero > torch.ones_like(zero)

    def consider(best_ov, best_n, separated, n, valid):
        # two-sided overlap; normal oriented cylinder -> hull
        mna, mxa = cyl_interval(n)
        mnb, mxb = _interval(verts_h, n)
        d1 = mxa - mnb
        d2 = mxb - mna
        ov = torch.minimum(d1, d2)
        nd = _where(d1 <= d2, n, _neg(n))
        separated = separated | (valid & (ov < 0.0))
        ov = torch.where(valid, ov, _BIG)
        upd = ov < best_ov - (SAT_TIE_TOL * (torch.abs(best_ov)
                                             + torch.abs(ov)) + 1e-9)
        return (torch.where(upd, ov, best_ov), _where(upd, nd, best_n),
                separated)

    for n, valid in faces_h:
        best_ov, best_n, separated = consider(
            best_ov, best_n, separated, n, valid)
    true = torch.ones_like(zero) > zero
    best_ov, best_n, separated = consider(
        best_ov, best_n, separated, adir, true)
    for d, valid in edges_h:
        cx = _cross(d, adir)
        l2 = _sqlen(cx)
        ok = valid & (l2 > 1e-10)
        cxn = _muls(cx, 1.0 / sqrt(_max(l2, 1e-30)))
        best_ov, best_n, separated = consider(
            best_ov, best_n, separated, cxn, ok)
    for v in verts_h:
        # direction from the clamped closest axis point to the vertex
        w = _sub(v, m)
        t = _clip(_dot(w, adir), -hlen, hlen)
        perp = _sub(w, _muls(adir, t))
        l2 = _sqlen(perp)
        ok = l2 > 1e-10
        pn = _muls(perp, 1.0 / sqrt(_max(l2, 1e-30)))
        best_ov, best_n, separated = consider(
            best_ov, best_n, separated, pn, ok)

    # ---- support-witness descent: at a local optimum of
    # overlap(n) = max_cyl(n) - min_hull(n) the witness difference is
    # parallel to n, so iterate n <- normalize(sign(ov) * (w_c - w_h)) from
    # the best SAT axis, keeping the minimum
    def cyl_support(n):
        na = _dot(n, adir)
        perp = _sub(n, _muls(adir, na))
        pl = sqrt(_max(_sqlen(perp), 0.0))
        pdir = _muls(perp, 1.0 / _max(pl, 1e-30))
        sgn = torch.where(na >= 0.0, 1.0, -1.0)
        return _add(m, _add(_muls(adir, hlen * sgn),
                            _muls(pdir, torch.where(pl > 1e-6, cr, 0.0))))

    def overlap_along(n):
        na = _dot(n, adir)
        half = hlen * torch.abs(na) + cr * sqrt(
            _max(1.0 - na * na, 0.0))
        mn_h, _ = _interval(verts_h, n)
        return _dot(m, n) + half - mn_h

    probe_n, probe_ov = best_n, best_ov
    for _ in range(8):
        w_c = cyl_support(probe_n)
        w_h = _support(verts_h, _neg(probe_n))
        d = _sub(w_c, w_h)
        d = _muls(d, torch.where(probe_ov >= 0.0, 1.0, -1.0))
        dl = sqrt(_max(_sqlen(d), 0.0))
        ok = dl > 1e-9
        probe_n = _where(ok, _muls(d, 1.0 / _max(dl, 1e-30)), probe_n)
        probe_ov = overlap_along(probe_n)
        take = probe_ov < best_ov
        best_ov = torch.where(take, probe_ov, best_ov)
        best_n = _where(take, probe_n, best_n)

    # ---- boolean gate: distance GJK, exact for separated convex shapes
    from dxk_tpu_torch.ops.kernels.cm_hull import sup_verts
    from dxk_tpu_torch.ops.kernels.gjk_distance import gjk_distance

    def sup_cyl(params, d):
        return cyl_support(d)

    dist, _qa, _qb, overlap = gjk_distance(
        sup_cyl, sup_verts, None, verts_h, max_iterations=16, stats=stats)
    sat = (best_ov >= 0.0) & ~separated
    gate = overlap | (dist < 1e-5)
    hit = sat & gate
    n = best_n                                   # cylinder -> hull
    # the cylinder's support point along +n, pulled back half the depth
    pt = _sub(cyl_support(n), _muls(n, 0.5 * best_ov))
    if stats is not None:
        stats["sat"] = sat
        stats["gate"] = gate
    return [pt], [best_ov], n, [hit]
