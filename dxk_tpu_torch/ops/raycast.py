"""Ray vs shape intersection — used by the poke interaction
(physics.apply_ray_impulse). Same formulas as the JAX package's
ops/raycast.py, broadcasting over leading batch dimensions.

All functions return (t, hit) with t >= 0 along the normalized direction
and t = 3.4e38 where there is no hit.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import (dot, quat_inv_rotate, sqrt,
                                      squared_length)

_INF = 3.4e38


def ray_sphere(o, d, center, radius):
    m = o - center
    b = dot(m, d)
    c = dot(m, m) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t < 0.0, -b + sq, t)   # inside: exit point
    hit = ok & (t >= 0.0) & ~((c > 0.0) & (b > 0.0))
    return torch.where(hit, t, _INF), hit


def ray_aabb(o, d, mn, mx):
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                            torch.where(d >= 0, 1e-12, -1e-12), d)
    t1 = (mn - o) * inv
    t2 = (mx - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0))
    t = torch.where(tmin >= 0.0, tmin, tmax)
    return torch.where(hit, t, _INF), hit


def ray_box(o, d, center, half, q):
    q = q.expand(*o.shape[:-1], 4)
    ol = quat_inv_rotate(q, o - center)
    dl = quat_inv_rotate(q, d)
    return ray_aabb(ol, dl, -half, half)


def _ray_infinite_cylinder(o, d, pa, axis, radius):
    """t for the infinite cylinder around `axis` through pa."""
    m = o - pa
    md = m - dot(m, axis)[..., None] * axis
    dd = d - dot(d, axis)[..., None] * axis
    a = squared_length(dd)
    b = dot(md, dd)
    c = squared_length(md) - radius * radius
    disc = b * b - a * c
    ok = (disc >= 0.0) & (a > 1e-12)
    sq = sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.clamp(a, min=1e-12)
    t = torch.where(t < 0.0, (-b + sq) / torch.clamp(a, min=1e-12), t)
    ok = ok & (t >= 0.0)
    return torch.where(ok, t, _INF), ok


def ray_capsule(o, d, pa, pb, radius):
    axis_v = pb - pa
    ln = sqrt(torch.clamp(squared_length(axis_v), min=1e-12))
    axis = axis_v / ln[..., None]
    t_cyl, ok_cyl = _ray_infinite_cylinder(o, d, pa, axis, radius)
    s = dot(o + t_cyl[..., None] * d - pa, axis)
    ok_cyl = ok_cyl & (s >= 0.0) & (s <= ln)
    t1, h1 = ray_sphere(o, d, pa, radius)
    t2, h2 = ray_sphere(o, d, pb, radius)
    t = torch.minimum(torch.where(ok_cyl, t_cyl, _INF),
                      torch.minimum(torch.where(h1, t1, _INF),
                                    torch.where(h2, t2, _INF)))
    return t, t < _INF


def ray_cylinder(o, d, pa, pb, radius):
    axis_v = pb - pa
    ln = sqrt(torch.clamp(squared_length(axis_v), min=1e-12))
    axis = axis_v / ln[..., None]
    t_cyl, ok_cyl = _ray_infinite_cylinder(o, d, pa, axis, radius)
    s = dot(o + t_cyl[..., None] * d - pa, axis)
    ok_side = ok_cyl & (s >= 0.0) & (s <= ln)

    # caps: ray vs the two disk planes
    def cap(p, n):
        dn = dot(d, n)
        t = dot(p - o, n) / torch.where(torch.abs(dn) < 1e-12, 1e-12, dn)
        hitp = o + t[..., None] * d
        inside = squared_length(hitp - p) <= radius * radius
        ok = (t >= 0.0) & inside & (torch.abs(dn) > 1e-12)
        return torch.where(ok, t, _INF)

    t = torch.minimum(torch.where(ok_side, t_cyl, _INF),
                      torch.minimum(cap(pa, axis), cap(pb, axis)))
    return t, t < _INF
