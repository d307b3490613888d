"""Ray vs shape intersection — used by the poke interaction
(physics.apply_ray_impulse) and editor picking. Same formulas as the JAX
package's ops/raycast.py, broadcasting over leading batch dimensions:
sphere, AABB, box, capsule, cylinder and convex hull, and the picking
extras plane, disk, rectangle, triangle and torus.

All functions return (t, hit) with t >= 0 along the normalized direction
and t = 3.4e38 where there is no hit.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import (cross, dot, noz, quat_inv_rotate,
                                      sqrt, squared_length)

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


def ray_hull(o, d, pos, q, verts, vmask, face_normals=None,
             face_offsets=None, face_mask=None):
    """Ray vs convex hull. With face planes (..., F, 3), (..., F), (..., F):
    the exact slab test over the faces (ray::intersectHull semantics);
    otherwise the conservative AABB of the masked vertices (..., V, 3)."""
    q = q.expand(*o.shape[:-1], 4)
    ol = quat_inv_rotate(q, o - pos)
    dl = quat_inv_rotate(q, d.expand_as(ol))
    big = _INF
    if face_normals is None:
        mn = torch.amin(torch.where(vmask[..., None], verts, big), dim=-2)
        mx = torch.amax(torch.where(vmask[..., None], verts, -big), dim=-2)
        return ray_aabb(ol, dl, mn, mx)
    # entry = max t over the faces the ray enters; exit = min t over the
    # faces it leaves; a hit if entry <= exit
    nd = torch.sum(face_normals * dl[..., None, :], dim=-1)      # (..., F)
    no = torch.sum(face_normals * ol[..., None, :], dim=-1) + face_offsets
    t = -no / torch.where(torch.abs(nd) < 1e-12,
                          torch.where(nd >= 0, 1e-12, -1e-12), nd)
    entering = nd < 0.0
    t_in = torch.where(face_mask & entering, t, -big)
    t_out = torch.where(face_mask & ~entering, t, big)
    # parallel to a face plane and outside it: a miss
    outside_parallel = torch.any(face_mask & (torch.abs(nd) < 1e-12)
                                 & (no > 0.0), dim=-1)
    t_enter = torch.amax(t_in, dim=-1)
    t_exit = torch.amin(t_out, dim=-1)
    hit = (t_enter <= t_exit) & (t_exit >= 0.0) & ~outside_parallel
    tt = torch.where(t_enter >= 0.0, t_enter, t_exit)
    return torch.where(hit, tt, big), hit


# -- editor-picking extras (ray::intersectPlane/Disk/Rectangle/Triangle/
# Torus of the reference's bounding_volumes.cpp)


def ray_plane(o, d, normal, point):
    """ray::intersectPlane. The reference returns t even when negative
    (behind the origin); `hit` here also requires t >= 0, like the rest of
    this module."""
    dn = dot(d, normal)
    safe = torch.where(torch.abs(dn) < 1e-6,
                       torch.where(dn >= 0, 1e-6, -1e-6), dn)
    t = dot(point - o, normal) / safe
    hit = (torch.abs(dn) >= 1e-6) & (t >= 0.0)
    return torch.where(hit, t, _INF), hit


def ray_disk(o, d, pos, normal, radius):
    """ray::intersectDisk: a plane hit within `radius` of `pos`."""
    t, hit = ray_plane(o, d, normal, pos)
    p = o + torch.where(hit, t, 0.0)[..., None] * d
    hit = hit & (squared_length(p - pos) <= radius * radius)
    return torch.where(hit, t, _INF), hit


def ray_rect(o, d, pos, tangent, bitangent, radius2):
    """ray::intersectRectangle: a plane hit whose projections on tangent
    and bitangent lie within the half-extents `radius2` (..., 2)."""
    n = cross(tangent, bitangent)
    t, hit = ray_plane(o, d, n, pos)
    off = o + torch.where(hit, t, 0.0)[..., None] * d - pos
    px = torch.abs(dot(off, tangent))
    py = torch.abs(dot(off, bitangent))
    hit = hit & (px <= radius2[..., 0]) & (py <= radius2[..., 1])
    return torch.where(hit, t, _INF), hit


def ray_triangle(o, d, a, b, c):
    """ray::intersectTriangle. Returns (t, hit, front_facing)."""
    n = noz(cross(b - a, c - a))
    t, hit = ray_plane(o, d, n, a)
    q = o + torch.where(hit, t, 0.0)[..., None] * d
    # barycentric point-in-triangle
    v0, v1, v2 = c - a, b - a, q - a
    d00, d01 = dot(v0, v0), dot(v0, v1)
    d11 = dot(v1, v1)
    d20, d21 = dot(v2, v0), dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    hit = hit & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    front = dot(d, n) < 0.0
    return torch.where(hit, t, _INF), hit, front


def ray_torus(o, d, pos, up_axis, major_radius, tube_radius, steps=96):
    """ray::intersectTorus, as the JAX package computes it: a
    fixed-iteration sphere trace of the exact torus SDF in the torus'
    frame (the reference solves the quartic). Accuracy ~1e-3 of the trace
    range; for picking, not the physics step."""
    axis = up_axis / torch.clamp(sqrt(squared_length(up_axis)),
                                 min=1e-12)[..., None]
    h = axis + torch.tensor([0.0, 1.0, 0.0], dtype=axis.dtype,
                            device=axis.device)
    hh = squared_length(h)

    def to_local(v):
        # the reflection mapping the axis to +y (Householder twice); the
        # axis -y is degenerate and flips y and z instead
        refl = v - 2.0 * dot(v, h)[..., None] * h / torch.clamp(
            hh, min=1e-12)[..., None]
        flipped = torch.stack([v[..., 0], -v[..., 1], -v[..., 2]], dim=-1)
        return torch.where(hh[..., None] > 1e-6, -refl, flipped)

    ol = to_local(o - pos)
    dl = to_local(d)

    def sdf(p):
        qx = sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - major_radius
        return sqrt(qx * qx + p[..., 1] ** 2) - tube_radius

    t = torch.zeros_like(dot(o, d))
    max_t = 2.0 * (sqrt(squared_length(ol)) + major_radius + tube_radius)
    for _ in range(steps):
        p = ol + t[..., None] * dl
        t = torch.minimum(t + sdf(p), max_t)
    hit = sdf(ol + t[..., None] * dl) < 1e-3 * torch.clamp(
        torch.as_tensor(major_radius + tube_radius), min=1.0)
    hit = hit & (t >= 0.0) & (t < max_t)
    return torch.where(hit, t, _INF), hit
