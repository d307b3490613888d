"""Component-major contact recipes — the plain PyTorch form of the
narrowphase that ``csrc/fused_step.cu`` computes per pair row.

Every vec3 is a tuple of 3 same-shaped tensors (shape (B, pairs): env batch
leading, pair rows minor). Each recipe is the same math, in the same
operation order, as the JAX package's ``ops/pallas/cm_narrowphase.py``;
``tests/test_torch_cm_kernels.py`` and ``tests/test_torch_shapes.py`` (the
sphere and cylinder recipes) pin them against each other.

Returns per recipe: (points, depths, normal, mask) where points is a list
of K v3 tuples, depths a list of K tensors, normal one v3, and mask a list
of K boolean tensors (point k live).

Ported: every recipe of the JAX module, the sphere, capsule, cylinder and
box pairs (the hull pairs are in cm_hull.py and cm_polytope.py)."""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import sqrt


def _max(a, b):
    """Elementwise maximum where either side may be a Python scalar."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def _min(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)

EPSILON = 1e-6
SAT_TIE_TOL = 1e-4        # relative SAT tie-break margin
REDUCE_TIE_TOL = 1e-4  # relative manifold-reduction tie margin


# ---- v3 helpers (local to avoid cross-module kernel imports) ----

def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _muls(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _where(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def _clamp01(x):
    return _clip(x, 0.0, 1.0)


def _sqlen(a):
    return _dot(a, a)


def quat_rotate_cm(q, v):
    """q: 4-tuple (x,y,z,w), v: v3 — maths.py quat_rotate port."""
    qv = (q[0], q[1], q[2])
    t = _muls(_cross(qv, v), 2.0)
    return _add(_add(v, _muls(t, q[3])), _cross(qv, t))


def quat_inv_rotate_cm(q, v):
    return quat_rotate_cm((-q[0], -q[1], -q[2], q[3]), v)


def closest_point_point_segment_cm(q, a, b):
    ab = _sub(b, a)
    t = _clamp01(_dot(_sub(q, a), ab)
                 / _max(_sqlen(ab), 1e-12))
    return _add(a, _muls(ab, t))


def closest_point_segment_segment_cm(p1, q1, p2, q2):
    """geometry.py:closest_point_segment_segment (Ericson 5.1.9)."""
    d1 = _sub(q1, p1)
    d2 = _sub(q2, p2)
    r = _sub(p1, p2)
    a = _sqlen(d1)
    e = _sqlen(d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b

    s = torch.where(denom > 1e-12,
                  _clamp01((b * f - c * e)
                           / torch.where(denom > 1e-12, denom, 1.0)), 0.0)
    t = (b * s + f) / _max(e, 1e-12)
    s = torch.where(t < 0.0, _clamp01(-c / _max(a, 1e-12)),
                  torch.where(t > 1.0, _clamp01((b - c) / _max(a, 1e-12)),
                            s))
    t = _clamp01(t)
    both = (a <= 1e-12) & (e <= 1e-12)
    s = torch.where(both, 0.0, torch.where(a <= 1e-12, 0.0, s))
    t = torch.where(both, 0.0, torch.where(e <= 1e-12, 0.0, t))
    c1 = _add(p1, _muls(d1, s))
    c2 = _add(p2, _muls(d2, t))
    return c1, c2


def _normalize_or_up(n):
    """n / |n|, or +Y when degenerate (narrowphase _UP convention)."""
    sq = _sqlen(n)
    dist = sqrt(_max(sq, 0.0))
    inv = 1.0 / _max(dist, 1e-30)
    deg = sq == 0.0
    return (_where(deg, (torch.zeros_like(sq), torch.ones_like(sq),
                         torch.zeros_like(sq)), _muls(n, inv)),
            dist, deg)


def sphere_sphere_cm(c1, r1, c2, r2):
    """narrowphase.sphere_sphere_contact: single point."""
    n = _sub(c2, c1)
    rs = r1 + r2
    sq = _sqlen(n)
    hit = sq <= rs * rs
    normal, dist, deg = _normalize_or_up(n)
    depth = rs - torch.where(deg, 0.0, dist)
    point = _muls(_add(_add(c1, _muls(normal, r1)),
                       _sub(c2, _muls(normal, r2))), 0.5)
    return point, depth, normal, hit


def capsule_capsule_cm(aa, ab, ar, ba, bb, br):
    """narrowphase.capsule_capsule_contact (collision_narrow.cpp:523-611):
    K=2 points. Returns (pts[2], dps[2], normal, mask[2])."""
    a_dirv = _sub(ab, aa)
    a_len = sqrt(_max(_sqlen(a_dirv), 0.0))
    a_dir = _muls(a_dirv, 1.0 / _max(a_len, 1e-30))
    b_dirv = _sub(bb, ba)
    b_len = sqrt(_max(_sqlen(b_dirv), 0.0))
    b_dir = _muls(b_dirv, 1.0 / _max(b_len, 1e-30))
    par = _dot(a_dir, b_dir)
    is_parallel = torch.abs(par) > 0.99

    # parallel: interval-overlap 2-point manifold
    swap = par < 0.0
    p_ba = _where(swap, bb, ba)
    p_bb = _where(swap, ba, bb)
    b0 = _dot(a_dir, _sub(p_ba, aa))
    b1 = _dot(a_dir, _sub(p_bb, aa))
    left = _max(0.0, b0)
    right = _min(a_len, b1)
    overlaps = right >= left

    ca0 = _add(aa, _muls(a_dir, left))
    ca1 = _add(aa, _muls(a_dir, right))
    cb0 = closest_point_point_segment_cm(ca0, p_ba, p_bb)
    cb1 = _add(cb0, _muls(a_dir, right - left))
    nvec = _sub(cb0, ca0)
    normal2, d, deg = _normalize_or_up(nvec)
    deg = d < EPSILON
    normal2 = _where(deg, (torch.zeros_like(d), torch.ones_like(d),
                           torch.zeros_like(d)), normal2)
    pen = (ar + br) - torch.where(deg, 0.0, d)
    two_hit = overlaps & (pen >= 0.0)
    p2_0 = _muls(_add(ca0, cb0), 0.5)
    p2_1 = _muls(_add(ca1, cb1), 0.5)

    # disjoint parallel intervals: end-sphere vs end-sphere
    use_a0 = 0.0 > b1
    s_a = _where(use_a0, aa, ab)
    s_b = _where(use_a0, p_bb, p_ba)
    e_pt, e_dp, e_n, e_hit = sphere_sphere_cm(s_a, ar, s_b, br)

    # non-parallel: closest points -> sphere-sphere
    c1, c2 = closest_point_segment_segment_cm(aa, ab, ba, bb)
    g_pt, g_dp, g_n, g_hit = sphere_sphere_cm(c1, ar, c2, br)

    # merge: parallel&overlap -> 2 pts; parallel&disjoint -> end spheres;
    # non-parallel -> general
    one_pt = _where(is_parallel, e_pt, g_pt)
    one_dp = torch.where(is_parallel, e_dp, g_dp)
    one_n = _where(is_parallel, e_n, g_n)
    one_hit = (is_parallel & e_hit) | (~is_parallel & g_hit)

    use2 = is_parallel & overlaps
    pt0 = _where(use2, p2_0, one_pt)
    dp0 = torch.where(use2, pen, one_dp)
    normal = _where(use2, normal2, one_n)
    m0 = (use2 & two_hit) | (~use2 & one_hit)
    pt1 = p2_1
    dp1 = pen
    m1 = use2 & two_hit
    return [pt0, pt1], [dp0, dp1], normal, [m0, m1]


def _segment_box_closest_cm(la, lb, bh, iters=8):
    """narrowphase._segment_box_closest: alternating projection."""
    s = _muls(_add(la, lb), 0.5)
    for _ in range(iters):
        q = tuple(_clip(s[i], -bh[i], bh[i]) for i in range(3))
        s = closest_point_point_segment_cm(q, la, lb)
    q = tuple(_clip(s[i], -bh[i], bh[i]) for i in range(3))
    return s, q


def _face_clip_segment_cm(la, lb, ar, bh, normal):
    """Shared capsule/cylinder vs box-face manifold enrichment on CM rows
    (narrowphase._aabb_face_clip_segment behavior via a parameter-interval
    clip of the radius-shifted axis segment against the face window).
    Returns (e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok): face-projected
    endpoint candidates (box-local), their depths, live masks and interval
    validity."""
    absn = (torch.abs(normal[0]), torch.abs(normal[1]), torch.abs(normal[2]))
    # face axis k = argmax |normal|; clip the shifted segment's param
    # interval against the two side-plane pairs
    fk0 = absn[0] > 0.99
    fk1 = ~fk0 & (absn[1] > 0.99)
    # shifted segment
    pa = _add(la, _muls(normal, ar))
    pb = _add(lb, _muls(normal, ar))

    def sel(i0, i1, i2, v):
        """component along axis index chosen by face flags: fk0->i0 etc."""
        return torch.where(fk0, v[i0], torch.where(fk1, v[i1], v[i2]))

    # side axes (u, v) for face k: (1,2), (0,2), (0,1)
    pa_u = sel(1, 0, 0, pa)
    pa_v = sel(2, 2, 1, pa)
    d_u = sel(1, 0, 0, pb) - pa_u
    d_v = sel(2, 2, 1, pb) - pa_v
    h_u = sel(1, 0, 0, bh)
    h_v = sel(2, 2, 1, bh)

    t0 = torch.zeros_like(pa_u)
    t1 = torch.ones_like(pa_u)

    def clip(t0, t1, p, d, h):
        # p + t*d <= h  and  >= -h
        big = 1e30
        for sign in (1.0, -1.0):
            num = sign * h - p
            tcross = num / torch.where(d == 0.0, big, d)
            dpos = (d * sign) > 0.0
            viol = (sign * p) > h
            # entering: d moves toward violation -> upper bound; else lower
            t1 = torch.where(dpos, _min(t1, tcross), t1)
            t0 = torch.where(~dpos & (d != 0.0), _max(t0, tcross), t0)
            # degenerate: no motion along axis and already outside
            t1 = torch.where((d == 0.0) & viol, -1.0, t1)
        return t0, t1

    t0, t1 = clip(t0, t1, pa_u, d_u, h_u)
    t0, t1 = clip(t0, t1, pa_v, d_v, h_v)
    clip_ok = t1 >= t0

    seg_d = _sub(pb, pa)
    e0 = _add(pa, _muls(seg_d, t0))
    e1 = _add(pa, _muls(seg_d, t1))
    # depth along the face plane: -(signed distance to the face), with
    # aabb_normal = -normal and ref corner selected by its sign
    face_h = sel(0, 1, 2, bh)
    n_k = sel(0, 1, 2, normal)
    # signed distance of p to plane {x_k = sign * h} along aabb normal
    # (-normal): depth = -( (-n_k)*p_k - (-n_k)*(-n_k*h) )
    p0_k = sel(0, 1, 2, e0)
    p1_k = sel(0, 1, 2, e1)
    dp_e0 = n_k * p0_k + face_h
    dp_e1 = n_k * p1_k + face_h
    # project the points back onto the face plane
    ref_k = -n_k * face_h

    def project(p, pk):
        return _where(fk0, (torch.full_like(pk, 0.0) + ref_k, p[1], p[2]),
                      _where(fk1, (p[0], ref_k, p[2]), (p[0], p[1], ref_k)))

    e0p = project(e0, p0_k)
    e1p = project(e1, p1_k)
    m_e0 = dp_e0 >= 0.0
    m_e1 = dp_e1 >= 0.0
    return e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok


def capsule_box_cm(aa, ab, ar, bc, bh, bq):
    """narrowphase.capsule_box_contact (collision_narrow.cpp:705-790
    behavior): K=2. bh: v3 of half-extents; bq: 4-tuple quat.
    Returns (pts[2], dps[2], normal, mask[2]) in WORLD space."""
    la = quat_inv_rotate_cm(bq, _sub(aa, bc))
    lb = quat_inv_rotate_cm(bq, _sub(ab, bc))

    s, q = _segment_box_closest_cm(la, lb, bh)
    delta = _sub(q, s)
    d2 = _sqlen(delta)
    inside = d2 <= 1e-12

    dist = sqrt(_max(d2, 1e-30))
    n_shallow = _muls(delta, 1.0 / dist)
    depth_shallow = ar - dist
    point_shallow = _muls(_add(_add(s, _muls(n_shallow, ar)), q), 0.5)

    # deep: min-translation face of the deeper-inside endpoint
    def face_pen(p):
        fp = tuple(bh[i] - torch.abs(_clip(p[i], -bh[i], bh[i]))
                   for i in range(3))
        return fp

    def fp_min(p):
        fp = face_pen(p)
        return _min(fp[0], _min(fp[1], fp[2]))

    in_a = ((torch.abs(la[0]) <= bh[0]) & (torch.abs(la[1]) <= bh[1])
            & (torch.abs(la[2]) <= bh[2]))
    in_b = ((torch.abs(lb[0]) <= bh[0]) & (torch.abs(lb[1]) <= bh[1])
            & (torch.abs(lb[2]) <= bh[2]))
    pen_a = fp_min(la)
    pen_b = fp_min(lb)
    pick_a = in_a & (~in_b | (pen_a >= pen_b))
    p_deep = _where(pick_a, la, _where(in_b, lb, s))

    fp = tuple(bh[i] - torch.abs(p_deep[i]) for i in range(3))
    # argmin over the 3 face distances
    k0 = (fp[0] <= fp[1]) & (fp[0] <= fp[2])
    k1 = ~k0 & (fp[1] <= fp[2])
    k2 = ~k0 & ~k1
    fmin = torch.where(k0, fp[0], torch.where(k1, fp[1], fp[2]))
    sgn = [torch.where(p_deep[i] >= 0.0, 1.0, -1.0) for i in range(3)]
    n_deep = (-torch.where(k0, sgn[0], 0.0), -torch.where(k1, sgn[1], 0.0),
              -torch.where(k2, sgn[2], 0.0))
    depth_deep = ar + fmin

    normal = _where(inside, n_deep, n_shallow)
    depth = torch.where(inside, depth_deep, depth_shallow)
    point = _where(inside, p_deep, point_shallow)
    hit = inside | (depth_shallow >= 0.0)

    # parallel-to-face 2-point manifold (the segment clipped to the face
    # window; collision_narrow.cpp:731-765 via _aabb_face_clip_segment)
    absn = (torch.abs(normal[0]), torch.abs(normal[1]), torch.abs(normal[2]))
    is_face = (absn[0] > 0.99) | (absn[1] > 0.99) | (absn[2] > 0.99)
    axisv = _sub(lb, la)
    axis = _muls(axisv, 1.0 / _max(
        sqrt(_max(_sqlen(axisv), 0.0)), 1e-30))
    parallel = torch.abs(_dot(normal, axis)) < 0.01
    enrich = is_face & parallel

    e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok = _face_clip_segment_cm(
        la, lb, ar, bh, normal)
    use = enrich & clip_ok & (m_e0 | m_e1)

    pt0 = _where(use, _where(m_e0, e0p, e1p), point)
    dp0 = torch.where(use, torch.where(m_e0, dp_e0, dp_e1), depth)
    m0 = (use & (m_e0 | m_e1)) | (~use & hit)
    pt1 = e1p
    dp1 = dp_e1
    m1 = use & m_e0 & m_e1

    # world space
    def to_world(p):
        return _add(quat_rotate_cm(bq, p), bc)

    nrm_w = quat_rotate_cm(bq, normal)
    m0 = m0 & hit
    m1 = m1 & hit
    return ([to_world(pt0), to_world(pt1)], [dp0, dp1], nrm_w, [m0, m1])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def get_tangent_cm(n):
    """maths.get_tangent: branch on |n.x| >= 0.57735, then normalize."""
    use_x = torch.abs(n[0]) >= 0.57735
    z = torch.zeros_like(n[0])
    t = _where(use_x, (n[1], -n[0], z), (z, n[2], -n[1]))
    ln = sqrt(_max(_sqlen(t), 0.0))
    return _muls(t, 1.0 / _max(ln, 1e-30))


def _first_argmax3(p0, p1, p2):
    """One-hot masks for argmax([p0,p1,p2]) (first max wins)."""
    m0 = (p0 >= p1) & (p0 >= p2)
    m1 = ~m0 & (p1 >= p2)
    m2 = ~m0 & ~m1
    return m0, m1, m2


def _mask3(m):
    return tuple(torch.where(x, 1.0, 0.0) for x in m)


def _clip_one_plane_cm(verts, depths, n, pn, pd):
    """manifold._clip_one_plane on CM slots: verts = list[S] of v3,
    depths list[S], n int32 array; plane (pn v3, pd). Returns new lists +
    count."""
    S = len(verts)
    n_safe = _max(n, 1)
    sd = [_dot(v, pn) + pd for v in verts]

    first_vs, first_ds, end_vs, end_ds, i1s, i2s = [], [], [], [], [], []
    offset = torch.zeros_like(n)
    for k in range(S):
        valid = k < n
        nxt = torch.remainder(k + 1, n_safe)
        ev, ed, esd = verts[0], depths[0], sd[0]
        for s in range(1, S):
            pick = nxt == s
            ev = _where(pick, verts[s], ev)
            ed = torch.where(pick, depths[s], ed)
            esd = torch.where(pick, sd[s], esd)
        s_in = sd[k] > 0.0
        e_in = esd > 0.0
        a_abs = torch.abs(sd[k])
        t = a_abs / _max(a_abs + torch.abs(esd), 1e-12)
        clip_v = _add(verts[k], _muls(_sub(ev, verts[k]), t))
        clip_d = depths[k] + (ed - depths[k]) * t
        emit_clip = (s_in ^ e_in) & valid
        emit_end = e_in & valid
        cnt = emit_clip.to(torch.int32) + emit_end.to(torch.int32)
        i1s.append(torch.where(cnt >= 1, offset, S))
        i2s.append(torch.where(cnt == 2, offset + 1, S))
        offset = offset + cnt
        first_vs.append(_where(emit_clip, clip_v, ev))
        first_ds.append(torch.where(emit_clip, clip_d, ed))
        end_vs.append(ev)
        end_ds.append(ed)

    zero = torch.zeros_like(depths[0])
    zv = (zero, zero, zero)
    out_v, out_d = [], []
    for s in range(S):
        av, ad = zv, zero
        for k in range(S):
            p1 = i1s[k] == s
            av = _where(p1, first_vs[k], av)
            ad = torch.where(p1, first_ds[k], ad)
            p2 = i2s[k] == s
            av = _where(p2, end_vs[k], av)
            ad = torch.where(p2, end_ds[k], ad)
        out_v.append(av)
        out_d.append(ad)
    return out_v, out_d, offset


def _project_filter_cm(verts, depths, n, pn, pd):
    """manifold.project_and_filter: drop depth<0 points, project onto the
    reference plane, compact to front."""
    S = len(verts)
    proj = [_add(v, _muls(pn, d)) for v, d in zip(verts, depths)]
    offset = torch.zeros_like(n)
    tgts, keeps = [], []
    for k in range(S):
        valid = (k < n) & (depths[k] >= 0.0)
        tgts.append(torch.where(valid, offset, S))
        keeps.append(valid)
        offset = offset + valid.to(torch.int32)
    zero = torch.zeros_like(depths[0])
    out_v, out_d = [], []
    for s in range(S):
        av, ad = (zero, zero, zero), zero
        for k in range(S):
            p = tgts[k] == s
            av = _where(p, proj[k], av)
            ad = torch.where(p, depths[k], ad)
        out_v.append(av)
        out_d.append(ad)
    return out_v, out_d, offset


def _reduce_manifold_cm(verts, depths, n, normal):
    """manifold.reduce_manifold (findStableContactManifold,
    collision_narrow.cpp:56-146): keep at most 4 points."""
    S = len(verts)
    NEG = -3.4e38

    def masked_best(scores):
        bs = torch.where(0 < n, scores[0], NEG)
        bv, bd = verts[0], depths[0]
        for k in range(1, S):
            sk = torch.where(k < n, scores[k], NEG)
            # first max wins, with the relative manifold.REDUCE_TIE_TOL
            # margin so this port picks the same vertex as the AoS path
            upd = sk > bs + (REDUCE_TIE_TOL * (torch.abs(bs) + torch.abs(sk))
                             + 1e-9)
            bs = torch.where(upd, sk, bs)
            bv = _where(upd, verts[k], bv)
            bd = torch.where(upd, depths[k], bd)
        return bv, bd

    search = get_tangent_cm(normal)
    p0, d0 = masked_best([_dot(v, search) for v in verts])
    p1, d1 = masked_best([_sqlen(_sub(v, p0)) for v in verts])
    area3 = [0.5 * _dot(_cross(_sub(p0, v), _sub(p1, v)), normal)
             for v in verts]
    p2, d2 = masked_best(area3)
    s4 = []
    for v in verts:
        qa = _sub(p0, v)
        qb = _sub(p1, v)
        qc = _sub(p2, v)
        a1 = 0.5 * _dot(_cross(qa, qb), normal)
        a2 = 0.5 * _dot(_cross(qb, qc), normal)
        a3 = 0.5 * _dot(_cross(qc, qa), normal)
        s4.append(_max(_max(a1, a2), a3))
    p3, d3 = masked_best(s4)

    use_r = n > 4
    red_v = [p0, p1, p2, p3]
    red_d = [d0, d1, d2, d3]
    out_v = [_where(use_r, red_v[k], verts[k]) for k in range(4)]
    out_d = [torch.where(use_r, red_d[k], depths[k]) for k in range(4)]
    count = torch.where(use_r, 4, n)
    return out_v, out_d, count


def _incident_edge_local_cm(h, nl):
    """narrowphase._aabb_incident_edge_local (getAABBIncidentEdge,
    collision_narrow.cpp:301-336), CM."""
    p = (torch.abs(nl[0]), torch.abs(nl[1]), torch.abs(nl[2]))
    out_a = h
    b_xy = (h[0], h[1], -h[2])
    b_xz = (h[0], -h[1], h[2])
    b_yz = (-h[0], h[1], h[2])
    out_b = _where(p[0] > p[1],
                   _where(p[1] > p[2], b_xy, b_xz),
                   _where(p[0] > p[2], b_xy, b_yz))
    s = tuple(torch.where(c < 0.0, -1.0, 1.0) for c in nl)
    return (tuple(out_a[i] * s[i] for i in range(3)),
            tuple(out_b[i] * s[i] for i in range(3)))


def box_box_cm(ac, ah, aq, bc, bh, bq):
    """narrowphase.box_box_contact (collision_narrow.cpp:1179-1528): 15-axis
    SAT, reference-face clip or edge-edge closest point. K=4.
    Returns (pts[4], dps[4], normal, mask[4]) in WORLD space."""
    one = torch.ones_like(ah[0])
    zero = torch.zeros_like(ah[0])
    ex, ey, ez = (one, zero, zero), (zero, one, zero), (zero, zero, one)
    basis = (ex, ey, ez)
    a_ax = [quat_rotate_cm(aq, e) for e in basis]
    b_ax = [quat_rotate_cm(bq, e) for e in basis]
    R = [[_dot(a_ax[i], b_ax[j]) for j in range(3)] for i in range(3)]
    tw = _sub(bc, ac)
    t = [_dot(a_ax[i], tw) for i in range(3)]
    absR = [[torch.abs(R[i][j]) + EPSILON for j in range(3)]
            for i in range(3)]
    parallel = zero > one        # all-False
    for i in range(3):
        for j in range(3):
            parallel = parallel | (absR[i][j] >= 0.99)

    pen_face_a = [ah[i] + sum(absR[i][j] * bh[j] for j in range(3))
                  - torch.abs(t[i]) for i in range(3)]
    tB = [sum(R[i][j] * t[i] for i in range(3)) for j in range(3)]
    pen_face_b = [sum(absR[i][j] * ah[i] for i in range(3)) + bh[j]
                  - torch.abs(tB[j]) for j in range(3)]

    edge_raw, edge_pen, edge_axes = [], [], []
    for i in range(3):
        for j in range(3):
            if i == 0:
                axis = (zero, -R[2][j], R[1][j])
            elif i == 1:
                axis = (R[2][j], zero, -R[0][j])
            else:
                axis = (-R[1][j], R[0][j], zero)
            k1, k2 = (i + 1) % 3, (i + 2) % 3
            ra = ah[k1] * absR[k2][j] + ah[k2] * absR[k1][j]
            l1, l2 = (j + 1) % 3, (j + 2) % 3
            rb = bh[l1] * absR[i][l2] + bh[l2] * absR[i][l1]
            dist = torch.abs(sum(t[c] * axis[c] for c in range(3)))
            praw = ra + rb - dist
            ln = sqrt(_max(_sqlen(axis), 0.0))
            inv_len = 1.0 / _max(ln, 1e-30)
            edge_raw.append(praw)
            edge_pen.append(praw * inv_len)
            edge_axes.append(_muls(axis, inv_len))

    separated = zero > one
    for p in pen_face_a:
        separated = separated | (p < 0.0)
    for p in pen_face_b:
        separated = separated | (p < 0.0)
    any_edge_neg = zero > one
    for p in edge_raw:
        any_edge_neg = any_edge_neg | (p < 0.0)
    separated = separated | (~parallel & any_edge_neg)
    hit = ~separated

    # argmin over [face_a(3), face_b(3), edges(9 or big)] — first min wins
    big = torch.full_like(zero, 3.4e38)
    cands = []
    for i in range(3):
        cands.append((pen_face_a[i], basis[i], True, False))
    for j in range(3):
        cands.append((pen_face_b[j], (R[0][j], R[1][j], R[2][j]),
                      False, False))
    for e in range(9):
        cands.append((torch.where(parallel, big, edge_pen[e]),
                      edge_axes[e], False, True))
    best_s, n_local, fa, fb = cands[0][0], cands[0][1], one > zero, zero > one
    is_edge = zero > one
    for s, cn, c_fa, c_edge in cands[1:]:
        # relative SAT_TIE_TOL tie-break — must match box_box_contact
        # exactly.
        margin = SAT_TIE_TOL * (torch.abs(best_s) + torch.abs(s)) + 1e-9
        upd = s < best_s - margin
        best_s = torch.where(upd, s, best_s)
        n_local = _where(upd, cn, n_local)
        fa = (upd & c_fa) | (~upd & fa)
        is_edge = (upd & c_edge) | (~upd & is_edge)
    is_face_b = ~fa & ~is_edge

    normal = quat_rotate_cm(aq, n_local)
    flip = _dot(normal, tw) < 0.0
    normal = _where(flip, _neg(normal), normal)

    # ---- face case: reference-face clipping (1438-1495)
    def qsel(c, qa_, qb_):
        return tuple(torch.where(c, x, y) for x, y in zip(qa_, qb_))

    ref_c = _where(is_face_b, bc, ac)
    ref_h = _where(is_face_b, bh, ah)
    ref_q = qsel(is_face_b, bq, aq)
    inc_c = _where(is_face_b, ac, bc)
    inc_h = _where(is_face_b, ah, bh)
    inc_q = qsel(is_face_b, aq, bq)
    ref_n = _where(is_face_b, _neg(normal), normal)

    n_ref_l = quat_inv_rotate_cm(ref_q, ref_n)
    m = _first_argmax3(torch.abs(n_ref_l[0]), torch.abs(n_ref_l[1]),
                       torch.abs(n_ref_l[2]))
    mm = _mask3(m)
    e0 = (mm[2], mm[0], mm[1])       # one-hot of (m+1)%3
    e1 = (mm[1], mm[2], mm[0])       # one-hot of (m+2)%3
    neg_h = _neg(ref_h)
    cp_l = [neg_h, neg_h, ref_h, ref_h]
    cn_l = [e0, e1, _neg(e0), _neg(e1)]
    planes = []
    for pl_p, pl_n in zip(cp_l, cn_l):
        nw = quat_rotate_cm(ref_q, pl_n)
        pw = _add(quat_rotate_cm(ref_q, pl_p), ref_c)
        planes.append((nw, -_dot(nw, pw)))

    n_inc_l = quat_inv_rotate_cm(inc_q, ref_n)
    mi = _first_argmax3(torch.abs(n_inc_l[0]), torch.abs(n_inc_l[1]),
                        torch.abs(n_inc_l[2]))
    mmi = _mask3(mi)
    ei0 = (mmi[2], mmi[0], mmi[1])
    ei1 = (mmi[1], mmi[2], mmi[0])
    nl_m = _dot(n_inc_l, mmi)
    s_inc = torch.where(nl_m < 0.0, 1.0, -1.0)
    d_inc = _dot(inc_h, mmi) * s_inc
    r0 = _dot(inc_h, ei0)
    r1 = _dot(inc_h, ei1)
    base = _muls(mmi, d_inc)
    corners = []
    for s0, s1 in ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)):
        cl = _add(base, _add(_muls(ei0, s0 * r0), _muls(ei1, s1 * r1)))
        corners.append(_add(quat_rotate_cm(inc_q, cl), inc_c))

    sup_l = tuple(torch.where(n_ref_l[i] >= 0.0, ref_h[i], -ref_h[i])
                  for i in range(3))
    sup_w = _add(quat_rotate_cm(ref_q, sup_l), ref_c)
    rp_d = -_dot(ref_n, sup_w)

    S = 8
    zv = (zero, zero, zero)
    verts = corners + [zv] * (S - 4)
    depths = [-(_dot(v, ref_n) + rp_d) for v in corners] + [zero] * (S - 4)
    nn = torch.full_like(zero, 4).to(torch.int32)
    for pn_, pd_ in planes:
        verts, depths, nn = _clip_one_plane_cm(verts, depths, nn, pn_, pd_)
    verts, depths, nn = _project_filter_cm(verts, depths, nn, ref_n, rp_d)
    f_pts, f_dps, f_cnt = _reduce_manifold_cm(verts, depths, nn, normal)
    face_hit = nn > 0

    # ---- edge case: closest point between the incident edges (1496-1518)
    a0l, a1l = _incident_edge_local_cm(ah, quat_inv_rotate_cm(aq, normal))
    b0l, b1l = _incident_edge_local_cm(bh, quat_inv_rotate_cm(
        bq, _neg(normal)))
    a0 = _add(quat_rotate_cm(aq, a0l), ac)
    a1 = _add(quat_rotate_cm(aq, a1l), ac)
    b0 = _add(quat_rotate_cm(bq, b0l), bc)
    b1 = _add(quat_rotate_cm(bq, b1l), bc)
    c1, c2 = closest_point_segment_segment_cm(a0, a1, b0, b1)
    e_pt = _muls(_add(c1, c2), 0.5)
    e_dp = sqrt(_max(_sqlen(_sub(c1, c2)), 0.0))

    pts = [_where(is_edge, e_pt, f_pts[k]) for k in range(4)]
    dps = [torch.where(is_edge, e_dp if k == 0 else zero, f_dps[k])
           for k in range(4)]
    count = torch.where(is_edge, 1, f_cnt)
    hit = hit & (is_edge | face_hit)
    count = torch.where(hit, count, 0)
    masks = [(k < count) for k in range(4)]
    return pts, dps, normal, masks


# ===========================================================================
# sphere recipes


def sphere_capsule_cm(sc, sr, ca, cb, cr):
    """narrowphase.sphere_capsule_contact: sphere vs closest axis point."""
    closest = closest_point_point_segment_cm(sc, ca, cb)
    return sphere_sphere_cm(sc, sr, closest, cr)


def sphere_box_cm(sc, sr, bc, bh, bq):
    """narrowphase.sphere_box_contact: rotate-to-local sphere-vs-AABB
    (collision_narrow.cpp:451-494)."""
    sc_l = quat_inv_rotate_cm(bq, _sub(sc, bc))
    p = tuple(_clip(sc_l[i], -bh[i], bh[i]) for i in range(3))
    n = _sub(p, sc_l)
    sq = _sqlen(n)
    hit = sq <= sr * sr
    dist = sqrt(_max(sq, 0.0))
    pos = sq > 0.0
    inv = 1.0 / _max(dist, 1e-30)
    up = (torch.zeros_like(sq), torch.ones_like(sq), torch.zeros_like(sq))
    n = _where(pos, _muls(n, inv), up)
    depth = sr - torch.where(pos, dist, 0.0)
    point_l = _muls(_add(_add(p, sc_l), _muls(n, sr)), 0.5)
    normal = quat_rotate_cm(bq, n)
    point = _add(quat_rotate_cm(bq, point_l), bc)
    return point, depth, normal, hit


# ===========================================================================
# cylinder recipes


def _snap_sign(x):
    """sign() with components under 1e-6 snapped to 0, so that a witness
    point does not jump a whole cap or face on float dust."""
    return torch.sign(torch.where(torch.abs(x) < 1e-6, 0.0, x))


def _cyl_support_cm(c, u, hl, r, d):
    """Cylinder support point along d (cap by snapped axial sign + radial
    rim)."""
    cap = _add(c, _muls(u, hl * _snap_sign(_dot(u, d))))
    radial = _sub(d, _muls(u, _dot(d, u)))
    rl = sqrt(_max(_sqlen(radial), 0.0))
    rad = _where(rl > EPSILON,
                 _muls(radial, r / _max(rl, 1e-30)),
                 (torch.zeros_like(rl),) * 3)
    return _add(cap, rad)


def sphere_cylinder_cm(sc, sr, ca, cb, cr):
    """narrowphase.sphere_cylinder_contact (collision_narrow.cpp:408-450):
    lateral body -> sphere-on-axis; beyond the caps -> cap disk rim/face."""
    ab = _sub(cb, ca)
    t = _dot(_sub(sc, ca), ab) / _max(_sqlen(ab), 1e-12)
    inside = (t >= 0.0) & (t <= 1.0)

    # lateral case
    on_axis = _add(ca, _muls(ab, t))
    l_pt, l_dp, l_n, l_hit = sphere_sphere_cm(sc, sr, on_axis, cr)

    # cap case
    t_lo = t <= 0.0
    p = _where(t_lo, ca, cb)
    up = _where(t_lo, _sub(ca, cb), ab)        # -ab when t<=0 else ab
    proj = _cross(_cross(up, _sub(sc, p)), up)
    proj = _muls(proj, 1.0 / _max(
        sqrt(_max(_sqlen(proj), 0.0)), 1e-30))
    end_a = _add(p, _muls(proj, cr))
    end_b = _sub(p, _muls(proj, cr))
    closest = closest_point_point_segment_cm(sc, end_a, end_b)
    nvec = _sub(closest, sc)
    sq = _sqlen(nvec)
    cap_hit = sq <= sr * sr
    degenerate = sq == 0.0
    dist = sqrt(_max(sq, 0.0))
    up_n = _muls(up, 1.0 / _max(
        sqrt(_max(_sqlen(up), 0.0)), 1e-30))
    normal = _where(degenerate, (-up_n[0], -up_n[1], -up_n[2]),
                    _muls(nvec, 1.0 / _max(dist, 1e-30)))
    depth = sr - torch.where(degenerate, 0.0, dist)
    point = _add(closest, _muls(nvec, 0.5 * depth))
    # merge
    pt = _where(inside, l_pt, point)
    dp = torch.where(inside, l_dp, depth)
    nm = _where(inside, l_n, normal)
    hit = (inside & l_hit) | (~inside & cap_hit)
    return pt, dp, nm, hit


def capsule_cylinder_cm(aa, ab, ar, ba, bb, br):
    """narrowphase.capsule_cylinder_contact (collision_narrow.cpp:614-704):
    parallel -> 2-point overlap manifold; else segment-segment closest
    point -> sphere-cylinder. K=2."""
    a_dirv = _sub(ab, aa)
    a_len = sqrt(_max(_sqlen(a_dirv), 0.0))
    a_dir = _muls(a_dirv, 1.0 / _max(a_len, 1e-30))
    b_dirv = _sub(bb, ba)
    b_dir = _muls(b_dirv, 1.0 / _max(
        sqrt(_max(_sqlen(b_dirv), 0.0)), 1e-30))
    par = _dot(a_dir, b_dir)
    is_parallel = torch.abs(par) > 0.99

    swap = par < 0.0
    p_ba = _where(swap, bb, ba)
    p_bb = _where(swap, ba, bb)
    b0 = _dot(a_dir, _sub(p_ba, aa))
    b1 = _dot(a_dir, _sub(p_bb, aa))
    left = _max(0.0, b0)
    right = _min(a_len, b1)
    overlaps = right >= left

    ca0 = _add(aa, _muls(a_dir, left))
    ca1 = _add(aa, _muls(a_dir, right))
    cb0 = closest_point_point_segment_cm(ca0, p_ba, p_bb)
    cb1 = _add(cb0, _muls(a_dir, right - left))
    nvec = _sub(cb0, ca0)
    normal2, d, _deg0 = _normalize_or_up(nvec)
    deg = d < EPSILON
    normal2 = _where(deg, (torch.zeros_like(d), torch.ones_like(d),
                           torch.zeros_like(d)), normal2)
    pen = (ar + br) - torch.where(deg, 0.0, d)
    two_hit = overlaps & (pen >= 0.0)
    p2_0 = _muls(_add(ca0, cb0), 0.5)
    p2_1 = _muls(_add(ca1, cb1), 0.5)

    # parallel but no axial overlap: capsule end sphere vs cylinder
    use_a0 = 0.0 > b1
    s_end = _where(use_a0, aa, ab)
    e_pt, e_dp, e_n, e_hit = sphere_cylinder_cm(s_end, ar, ba, bb, br)

    # non-parallel: closest points -> sphere-cylinder
    c1, _c2 = closest_point_segment_segment_cm(aa, ab, ba, bb)
    g_pt, g_dp, g_n, g_hit = sphere_cylinder_cm(c1, ar, ba, bb, br)

    one_pt = _where(is_parallel, e_pt, g_pt)
    one_dp = torch.where(is_parallel, e_dp, g_dp)
    one_n = _where(is_parallel, e_n, g_n)
    one_hit = (is_parallel & e_hit) | (~is_parallel & g_hit)

    use2 = is_parallel & overlaps
    pt0 = _where(use2, p2_0, one_pt)
    dp0 = torch.where(use2, pen, one_dp)
    normal = _where(use2, normal2, one_n)
    m0 = (use2 & two_hit) | (~use2 & one_hit)
    pt1 = p2_1
    dp1 = pen
    m1 = use2 & two_hit
    return [pt0, pt1], [dp0, dp1], normal, [m0, m1]


def _fixed_point(step, p, iters, stats):
    """`iters` rounds of p <- step(p). When `stats` is a dict,
    stats["iterations"] receives, per lane, the rounds run until an iterate
    equals the one before bit for bit (from there every later round gives
    the same point; the kernel stops there)."""
    done = torch.zeros_like(p[0], dtype=torch.bool)
    n = torch.zeros_like(p[0], dtype=torch.int32)
    for _ in range(iters):
        pn = step(p)
        if stats is not None:
            n = n + (~done).to(torch.int32)
            same = ((pn[0].view(torch.int32) == p[0].view(torch.int32))
                    & (pn[1].view(torch.int32) == p[1].view(torch.int32))
                    & (pn[2].view(torch.int32) == p[2].view(torch.int32)))
            done = done | same
        p = pn
    if stats is not None:
        stats["iterations"] = n
    return p


def _branch_stats(stats, ring, tube):
    """Which manifold a cylinder recipe built, per lane: "ring" (4-point
    cap ring), "tube" (2-point lying-tube manifold), else "single"."""
    if stats is not None:
        stats["branch"] = torch.where(ring, 0, torch.where(tube, 1, 2))


def cylinder_box_cm(aa, ab, ar, bc, bh, bq, stats=None):
    """narrowphase.cylinder_box_contact (collision_narrow.cpp:953-1043
    behavior, analytic redesign): K=4. Exact boolean (axis distance +
    solid-cylinder alternating projection), exact tube contacts, SAT-MTV
    candidates for cap/deep contacts, then face-clip (2 points) / cap-rim
    ring (4 points) enrichment. Returns (pts[4], dps[4], normal, mask[4])
    in WORLD space. When `stats` is a dict it receives the manifold kind
    per lane (_branch_stats) and the alternating projection's rounds."""
    la = quat_inv_rotate_cm(bq, _sub(aa, bc))
    lb = quat_inv_rotate_cm(bq, _sub(ab, bc))

    axis_v = _sub(lb, la)
    alen = sqrt(_max(_sqlen(axis_v), 0.0))
    u = _muls(axis_v, 1.0 / _max(alen, 1e-30))
    hl = 0.5 * alen
    cc = _muls(_add(la, lb), 0.5)
    zero = torch.zeros_like(ar)
    one = torch.ones_like(ar)
    up = (zero, one, zero)

    # ---- exact boolean ----
    s, q = _segment_box_closest_cm(la, lb, bh)
    delta = _sub(q, s)
    d2 = _sqlen(delta)
    dist_axis = sqrt(_max(d2, 1e-30))
    # threshold well above alternating-projection float dust
    dir_thr = _max(1e-3 * ar, 1e-6)
    have_dir = d2 > dir_thr * dir_thr
    tube_case = have_dir & (torch.abs(_dot(delta, u)) <= 1e-4 * dist_axis)

    # solid-cylinder / box alternating projection (32 rounds)
    def step(p):
        qq = tuple(_clip(p[i], -bh[i], bh[i]) for i in range(3))
        w = _sub(qq, cc)
        t = _clip(_dot(w, u), -hl, hl)
        rad = _sub(w, _muls(u, _dot(w, u)))
        rl = sqrt(_max(_sqlen(rad), 0.0))
        scale = _min(1.0, ar / _max(rl, 1e-30))
        return _add(_add(cc, _muls(u, t)), _muls(rad, scale))

    p = _fixed_point(step, cc, 32, stats)
    qq = tuple(_clip(p[i], -bh[i], bh[i]) for i in range(3))
    d_cb2 = _sqlen(_sub(qq, p))
    touch = _max(1e-3 * ar, 1e-5)
    cap_hit = d_cb2 <= touch * touch

    # ---- tube contact: exact (the capsule formula) ----
    n_tube = _where(have_dir, _muls(delta, 1.0 / dist_axis), up)
    depth_tube = ar - dist_axis
    point_tube = _muls(_add(_add(s, _muls(n_tube, ar)), q), 0.5)

    # ---- cap/deep contact: SAT-MTV over the candidate axes ----
    def overlap(n):
        rb = bh[0] * torch.abs(n[0]) + bh[1] * torch.abs(n[1]) \
            + bh[2] * torch.abs(n[2])
        un = _dot(u, n)
        rc = hl * torch.abs(un) + ar * sqrt(
            _max(1.0 - un * un, 0.0))
        return rb + rc - torch.abs(_dot(cc, n))

    big = 3.4e38
    best_ov = torch.full_like(ar, big)
    best_n = up
    best_id = torch.full_like(ar, -1.0)

    def consider(bo, bn, bi, n, valid, cid):
        # SAT_TIE_TOL relative tie-breaking
        ov = overlap(n) if valid is None else torch.where(valid, overlap(n),
                                                          big)
        take = ov < bo - SAT_TIE_TOL * (torch.abs(ov) + torch.abs(bo))
        return (torch.where(take, ov, bo), _where(take, n, bn),
                torch.where(take, cid, bi))

    ex = (one, zero, zero)
    ey = (zero, one, zero)
    ez = (zero, zero, one)
    for i, e in enumerate((ex, ey, ez)):                  # box faces
        best_ov, best_n, best_id = consider(
            best_ov, best_n, best_id, e, None, float(i))
    best_ov, best_n, best_id = consider(                  # cylinder axis
        best_ov, best_n, best_id, u, alen > EPSILON, 3.0)
    for i, e in enumerate((ex, ey, ez)):                  # u x box edges
        wax = _cross(u, e)
        wl = sqrt(_max(_sqlen(wax), 0.0))
        wn = _muls(wax, 1.0 / _max(wl, 1e-30))
        best_ov, best_n, best_id = consider(
            best_ov, best_n, best_id, wn, wl > 1e-6, 4.0 + i)
    best_ov, best_n, best_id = consider(                  # lateral closest
        best_ov, best_n, best_id, n_tube, have_dir, 7.0)

    sgn = torch.where(_dot(cc, best_n) >= 0.0, 1.0, -1.0)
    n_sat = _muls(best_n, -sgn)                           # points cyl -> box
    depth_sat = best_ov

    # witness point by winning feature
    pa_face = _cyl_support_cm(cc, u, hl, ar, n_sat)
    pt_face = _sub(pa_face, _muls(n_sat, 0.5 * depth_sat))
    pb_u = tuple(_snap_sign(-n_sat[i]) * bh[i] for i in range(3))
    pt_u = _add(pb_u, _muls(n_sat, 0.5 * depth_sat))
    pt_mid = _muls(_add(pa_face, pb_u), 0.5)
    pt_lat = _where(have_dir,
                    _muls(_add(_add(s, _muls(n_sat, ar)), q), 0.5), pt_mid)
    point_sat = _where(best_id < 2.5, pt_face,
                       _where((best_id > 2.5) & (best_id < 3.5),
                              pt_u, pt_lat))

    # tube direction wins only when it is the smaller pushout
    use_tube = tube_case & (depth_tube <= depth_sat)
    normal = _where(use_tube, n_tube, n_sat)
    depth = torch.where(use_tube, depth_tube, depth_sat)
    point = _where(use_tube, point_tube, point_sat)

    hit = (dist_axis <= ar) & (depth_sat >= 0.0) & (tube_case | cap_hit)

    # ---- enrichment ----
    absn = (torch.abs(normal[0]), torch.abs(normal[1]), torch.abs(normal[2]))
    is_face = (absn[0] > 0.99) | (absn[1] > 0.99) | (absn[2] > 0.99)
    axis_n = _muls(axis_v, 1.0 / _max(
        sqrt(_max(_sqlen(axis_v), 0.0)), 1e-30))
    cos_angle = torch.abs(_dot(normal, axis_n))
    enrich = is_face & (cos_angle < 0.01)

    e0p, e1p, dp_e0, dp_e1, m_e0, m_e1, clip_ok = _face_clip_segment_cm(
        la, lb, ar, bh, normal)
    use = enrich & clip_ok & (m_e0 | m_e1)

    pt0 = _where(use, _where(m_e0, e0p, e1p), point)
    dp0 = torch.where(use, torch.where(m_e0, dp_e0, dp_e1), depth)
    m0 = (use & (m_e0 | m_e1)) | (~use & hit)
    pt1 = e1p
    dp1 = dp_e1
    m1 = use & m_e0 & m_e1

    # cap flat on a box face: 4-point rim ring
    cap_case = is_face & (cos_angle > 0.99)
    pick_a = _dot(la, normal) > _dot(lb, normal)
    cap_c = _where(pick_a, la, lb)
    t1c = get_tangent_cm(normal)
    t2c = _cross(normal, t1c)
    rr = ar * 0.95
    r0 = _add(cap_c, _muls(t1c, rr))
    r1 = _sub(cap_c, _muls(t1c, rr))
    r2 = _add(cap_c, _muls(t2c, rr))
    r3 = _sub(cap_c, _muls(t2c, rr))

    pt0 = _where(cap_case, r0, pt0)
    pt1 = _where(cap_case, r1, pt1)
    pt2 = r2
    pt3 = r3
    dp0 = torch.where(cap_case, depth, dp0)
    dp1 = torch.where(cap_case, depth, dp1)
    dp2 = depth
    dp3 = depth
    m0 = (cap_case & hit) | (~cap_case & m0 & hit)
    m1 = (cap_case & hit) | (~cap_case & m1 & hit)
    m2 = cap_case & hit
    m3 = cap_case & hit
    _branch_stats(stats, cap_case & hit, ~cap_case & m1)

    def to_world(pp):
        return _add(quat_rotate_cm(bq, pp), bc)

    nrm_w = quat_rotate_cm(bq, normal)
    return ([to_world(pt0), to_world(pt1), to_world(pt2), to_world(pt3)],
            [dp0, dp1, dp2, dp3], nrm_w, [m0, m1, m2, m3])


def cylinder_cylinder_cm(aa, ab, ar, ba, bb, br, stats=None):
    """narrowphase.cylinder_cylinder_contact (collision_narrow.cpp:821-951
    behavior, analytic non-parallel path): K=4. Parallel: cap-to-cap
    4-point ring / tube-to-tube 2 points; otherwise exact boolean + SAT-MTV
    single point. Returns (pts[4], dps[4], normal, mask[4]) in WORLD space.
    `stats` as in cylinder_box_cm."""
    zero = torch.zeros_like(ar)
    one = torch.ones_like(ar)
    up = (zero, one, zero)

    a_dirv = _sub(ab, aa)
    a_len = sqrt(_max(_sqlen(a_dirv), 0.0))
    a_dir = _muls(a_dirv, 1.0 / _max(a_len, 1e-30))
    b_dirv = _sub(bb, ba)
    b_len = sqrt(_max(_sqlen(b_dirv), 0.0))
    b_dir = _muls(b_dirv, 1.0 / _max(b_len, 1e-30))
    par = _dot(a_dir, b_dir)
    is_parallel = torch.abs(par) > 0.99

    # ---- parallel branch (orient b along a, 1D intervals) ----
    swap = par < 0.0
    p_ba = _where(swap, bb, ba)
    p_bb = _where(swap, ba, bb)
    b0 = _dot(a_dir, _sub(p_ba, aa))
    b1 = _dot(a_dir, _sub(p_bb, aa))
    left = _max(0.0, b0)
    right = _min(a_len, b1)
    overlaps = right >= left

    ca0 = _add(aa, _muls(a_dir, left))
    ca1 = _add(aa, _muls(a_dir, right))
    cb0 = closest_point_point_segment_cm(ca0, p_ba, p_bb)
    cb1 = _add(cb0, _muls(a_dir, right - left))
    nvec = _sub(cb0, ca0)
    d = sqrt(_max(_sqlen(nvec), 0.0))
    pen = (ar + br) - d
    radial_hit = pen >= 0.0

    cap_pen = right - left
    cap_first = cap_pen < pen
    b_right = b0 > 0.0
    cap_normal = _where(b_right, a_dir, _neg(a_dir))
    cap_point = _where(b_right,
                       _sub(ab, _muls(a_dir, 0.5 * cap_pen)),
                       _add(aa, _muls(a_dir, 0.5 * cap_pen)))

    degen = d < EPSILON
    t_normal = _where(degen, up, _muls(nvec, 1.0 / _max(d, 1e-30)))

    # tube-to-tube 2 points
    tt0 = _muls(_add(ca0, cb0), 0.5)
    tt1 = _muls(_add(ca1, cb1), 0.5)

    # cap-to-cap 4-point ring on the cap-disk intersection lens
    lat = _sub(nvec, _muls(a_dir, _dot(nvec, a_dir)))
    dl = sqrt(_max(_sqlen(lat), 0.0))
    lat_ok = dl > EPSILON
    lat_dir = _where(lat_ok, _muls(lat, 1.0 / _max(dl, 1e-30)),
                     get_tangent_cm(a_dir))
    lo = _max(-ar, dl - br)
    hi = _min(ar, dl + br)
    re = _max(0.5 * (hi - lo), 0.0)
    c_off = 0.5 * (lo + hi)
    ring_c = _add(cap_point, _muls(lat_dir, c_off))
    t1v = lat_dir
    t2v = _cross(cap_normal, t1v)
    r0 = _add(ring_c, _muls(t1v, re))
    r1 = _sub(ring_c, _muls(t1v, re))
    r2 = _add(ring_c, _muls(t2v, re))
    r3 = _sub(ring_c, _muls(t2v, re))
    ring_ok = re > EPSILON

    par_hit = overlaps & radial_hit

    # ---- non-parallel analytic ----
    ca_c = _muls(_add(aa, ab), 0.5)
    cb_c = _muls(_add(ba, bb), 0.5)
    a_hl = 0.5 * a_len
    b_hl = 0.5 * b_len
    rsum = ar + br

    c1, c2 = closest_point_segment_segment_cm(aa, ab, ba, bb)
    gdelta = _sub(c2, c1)
    dsq = _sqlen(gdelta)
    gdist = sqrt(_max(dsq, 1e-30))
    g_thr = _max(1e-3 * _max(ar, br), 1e-6)
    g_have = dsq > g_thr * g_thr
    perp = g_have & (torch.abs(_dot(gdelta, a_dir)) <= 1e-4 * gdist) \
        & (torch.abs(_dot(gdelta, b_dir)) <= 1e-4 * gdist)
    n_tt = _where(g_have, _muls(gdelta, 1.0 / gdist), up)
    depth_tt = rsum - gdist
    point_tt = _muls(_add(_add(c1, _muls(n_tt, ar)),
                          _sub(c2, _muls(n_tt, br))), 0.5)

    def _proj_cyl(x, c, uax, hl, r):
        w = _sub(x, c)
        wu = _dot(w, uax)
        t = _clip(wu, -hl, hl)
        rad = _sub(w, _muls(uax, wu))
        rl = sqrt(_max(_sqlen(rad), 0.0))
        scale = _min(1.0, r / _max(rl, 1e-30))
        return _add(_add(c, _muls(uax, t)), _muls(rad, scale))

    def step(p):
        qq = _proj_cyl(p, cb_c, b_dir, b_hl, br)
        return _proj_cyl(qq, ca_c, a_dir, a_hl, ar)

    p = _fixed_point(step, ca_c, 32, stats)
    qq = _proj_cyl(p, cb_c, b_dir, b_hl, br)
    d_cc2 = _sqlen(_sub(qq, p))
    g_touch = _max(1e-3 * _max(ar, br), 1e-5)
    g_caphit = d_cc2 <= g_touch * g_touch

    def cyl_radius_on(n, uax, hl, r):
        un = _dot(uax, n)
        return hl * torch.abs(un) + r * sqrt(
            _max(1.0 - un * un, 0.0))

    dc = _sub(cb_c, ca_c)

    def g_overlap(n):
        return (cyl_radius_on(n, a_dir, a_hl, ar)
                + cyl_radius_on(n, b_dir, b_hl, br)
                - torch.abs(_dot(dc, n)))

    big = 3.4e38
    g_bo = torch.full_like(ar, big)
    g_bn = up
    g_bi = torch.full_like(ar, -1.0)

    def g_consider(bo, bn, bi, n, valid, cid):
        ov = torch.where(valid, g_overlap(n), big)
        take = ov < bo - SAT_TIE_TOL * (torch.abs(ov) + torch.abs(bo))
        return (torch.where(take, ov, bo), _where(take, n, bn),
                torch.where(take, cid, bi))

    g_bo, g_bn, g_bi = g_consider(g_bo, g_bn, g_bi, a_dir,
                                  a_len > EPSILON, 0.0)
    g_bo, g_bn, g_bi = g_consider(g_bo, g_bn, g_bi, b_dir,
                                  b_len > EPSILON, 1.0)
    xax = _cross(a_dir, b_dir)
    xl = sqrt(_max(_sqlen(xax), 0.0))
    g_bo, g_bn, g_bi = g_consider(
        g_bo, g_bn, g_bi, _muls(xax, 1.0 / _max(xl, 1e-30)),
        xl > 1e-6, 2.0)
    g_bo, g_bn, g_bi = g_consider(g_bo, g_bn, g_bi, n_tt, g_have, 3.0)

    g_sgn = torch.where(_dot(dc, g_bn) >= 0.0, 1.0, -1.0)
    n_gsat = _muls(g_bn, g_sgn)                            # points A -> B
    depth_gsat = g_bo

    pb_sup = _cyl_support_cm(cb_c, b_dir, b_hl, br, _neg(n_gsat))
    pa_sup = _cyl_support_cm(ca_c, a_dir, a_hl, ar, n_gsat)
    pt_capa = _add(pb_sup, _muls(n_gsat, 0.5 * depth_gsat))
    pt_capb = _sub(pa_sup, _muls(n_gsat, 0.5 * depth_gsat))
    pt_glat = _where(g_have,
                     _muls(_add(_add(c1, _muls(n_gsat, ar)),
                                _sub(c2, _muls(n_gsat, br))), 0.5),
                     _muls(_add(pa_sup, pb_sup), 0.5))
    point_gsat = _where(g_bi < 0.5, pt_capa,
                        _where((g_bi > 0.5) & (g_bi < 1.5),
                               pt_capb, pt_glat))

    use_tt = perp & (depth_tt <= depth_gsat)
    g_nrm = _where(use_tt, n_tt, n_gsat)
    g_depth = torch.where(use_tt, depth_tt, depth_gsat)
    g_point = _where(use_tt, point_tt, point_gsat)
    g_hit = (gdist <= rsum) & (depth_gsat >= 0.0) & (perp | g_caphit)

    # ---- assemble K=4 slots (priority: parallel ring > tube-2 > single)
    use_ring = is_parallel & par_hit & cap_first & ring_ok
    use_cap1 = is_parallel & par_hit & cap_first & ~ring_ok
    use_tube2 = is_parallel & par_hit & ~cap_first
    use_np = ~is_parallel

    pt0 = _where(use_ring, r0,
          _where(use_cap1, cap_point,
          _where(use_tube2, tt0, g_point)))
    dp0 = torch.where(use_ring | use_cap1, cap_pen,
          torch.where(use_tube2, pen, g_depth))
    pt1 = _where(use_ring, r1, tt1)
    dp1 = torch.where(use_ring, cap_pen, pen)
    pt2 = r2
    dp2 = cap_pen
    pt3 = r3
    dp3 = cap_pen

    normal = _where(use_ring | use_cap1, cap_normal,
             _where(use_tube2, t_normal, g_nrm))

    m0 = (is_parallel & par_hit) | (use_np & g_hit)
    m1 = use_ring | use_tube2
    m2 = use_ring
    m3 = use_ring
    _branch_stats(stats, use_ring, use_tube2)

    return ([pt0, pt1, pt2, pt3], [dp0, dp1, dp2, dp3], normal,
            [m0, m1, m2, m3])
