"""Sphere-hull and capsule-hull contacts on component-major lane tuples —
the plain PyTorch form of the sphere-hull and capsule-hull recipes of
``csrc/fused_step.cu``, in the same operation order as the JAX package's
``ops/pallas/cm_hull.py``.

A sphere/capsule is a point/segment swept by a ball of its radius, so

    contact  <=>  dist(point_or_segment, hull) <= radius
    depth     =   radius - dist
    normal    =   (hull witness - core witness) / dist

with dist and witnesses from the distance GJK (gjk_distance.py). When the
core itself enters the hull, the contact is the point-in-hull minimum
translation from the hull's face planes instead.

All in HULL-LOCAL space; callers rotate in and out. Vertices arrive as a
list of V v3 tuples (padded vertices repeat the first one, harmless for a
support argmax); faces as lists of (normal v3, offset) with a parallel
validity list (padded faces masked out of the max).
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.ops.kernels.cm_narrowphase import (_add, _dot, _max,
                                                      _muls, _sub, _where)
from dxk_tpu_torch.ops.kernels.gjk_distance import gjk_distance

_BIG = 3.4e38


def sup_point(p, d):
    return p


def sup_segment(ab, d):
    a, b = ab
    return _where(_dot(d, a) > _dot(d, b), a, b)


def sup_verts(verts_list, d):
    """Support over a list of v3 vertices (first maximum wins)."""
    best = verts_list[0]
    bs = _dot(best, d)
    for v in verts_list[1:]:
        s = _dot(v, d)
        take = s > bs
        bs = torch.where(take, s, bs)
        best = _where(take, v, best)
    return best


def _face_mtv(p, planes, plane_valid):
    """Minimum translation for a point inside the hull: the face with the
    largest signed distance n.p + off (all negative inside). Returns
    (sd, n_out v3)."""
    best_sd = torch.full_like(p[0], -_BIG)
    best_n = (torch.zeros_like(p[0]), torch.ones_like(p[0]),
              torch.zeros_like(p[0]))
    for (n, off), ok in zip(planes, plane_valid):
        sd = _dot(n, p) + off
        sd = torch.where(ok, sd, -_BIG)
        take = sd > best_sd
        best_sd = torch.where(take, sd, best_sd)
        best_n = _where(take, n, best_n)
    return best_sd, best_n


def sphere_hull_core(sc, sr, verts_list, planes, plane_valid, stats=None):
    """Sphere (center sc, radius sr) vs local hull. Returns
    (point, depth, normal, hit): one contact, hull-local frame, normal
    pointing sphere -> hull. `stats` as in capsule_hull_core ("overlap":
    the centre is inside the hull)."""
    dist, qa, qb, overlap = gjk_distance(sup_point, sup_verts,
                                         sc, verts_list, stats=stats)
    inv_d = 1.0 / _max(dist, 1e-30)
    n_s = _muls(_sub(qb, qa), inv_d)
    depth_s = sr - dist
    point_s = _muls(_add(_add(sc, _muls(n_s, sr)), qb), 0.5)

    sd, n_f = _face_mtv(sc, planes, plane_valid)
    n_d = _muls(n_f, -1.0)
    depth_d = sr - sd
    point_d = _add(sc, _muls(n_f, -0.5 * sd))

    normal = _where(overlap, n_d, n_s)
    depth = torch.where(overlap, depth_d, depth_s)
    point = _where(overlap, point_d, point_s)
    hit = overlap | (depth_s >= 0.0)
    if stats is not None:
        stats["overlap"] = overlap
    return point, depth, normal, hit


def capsule_hull_core(ca, cb, cr, verts_list, planes, plane_valid,
                      stats=None):
    """Capsule (segment ca-cb, radius cr) vs local hull. Returns
    (point, depth, normal, hit): one contact, hull-local frame, normal
    pointing capsule -> hull. When `stats` is a dict it receives the
    distance GJK's "overlap" (the deep branch) and "iterations"."""
    dist, qa, qb, overlap = gjk_distance(sup_segment, sup_verts,
                                         (ca, cb), verts_list, stats=stats)
    inv_d = 1.0 / _max(dist, 1e-30)
    n_s = _muls(_sub(qb, qa), inv_d)
    depth_s = cr - dist
    point_s = _muls(_add(_add(qa, _muls(n_s, cr)), qb), 0.5)

    # deep: the segment reaches into the hull — face-plane minimum
    # translation of the deepest of 5 segment samples
    sd = n_f = p_deep = None
    for t in (0.0, 0.25, 0.5, 0.75, 1.0):
        p = _add(_muls(ca, 1.0 - t), _muls(cb, t))
        sd_t, n_t = _face_mtv(p, planes, plane_valid)
        if sd is None:
            sd, n_f, p_deep = sd_t, n_t, p
        else:
            deeper = sd_t < sd                 # deeper = more negative
            sd = torch.where(deeper, sd_t, sd)
            n_f = _where(deeper, n_t, n_f)
            p_deep = _where(deeper, p, p_deep)
    n_d = _muls(n_f, -1.0)
    depth_d = cr - sd
    point_d = _add(p_deep, _muls(n_f, -0.5 * sd))

    normal = _where(overlap, n_d, n_s)
    depth = torch.where(overlap, depth_d, depth_s)
    point = _where(overlap, point_d, point_s)
    hit = overlap | (depth_s >= 0.0)
    if stats is not None:
        stats["overlap"] = overlap
    return point, depth, normal, hit
