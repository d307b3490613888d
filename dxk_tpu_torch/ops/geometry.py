"""Closest-point primitives of the narrowphase, batched over any leading
dimensions: the port's counterpart of the JAX package's ops/geometry.py,
in the same operation order."""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import dot, squared_length


def _clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def closest_point_point_segment(q, a, b):
    """Closest point on segment [a, b] to point q."""
    ab = b - a
    t = _clamp01(dot(q - a, ab) / torch.clamp(squared_length(ab), min=1e-12))
    return a + t[..., None] * ab


def closest_point_point_aabb(q, min_corner, max_corner):
    return torch.minimum(torch.maximum(q, min_corner), max_corner)


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
    s = torch.where(ok, _clamp01((b * f - c * e) / torch.where(ok, denom, 1.0)),
                    0.0)
    t = (b * s + f) / torch.clamp(e, min=1e-12)

    s = torch.where(t < 0.0, _clamp01(-c / torch.clamp(a, min=1e-12)),
                    torch.where(t > 1.0,
                                _clamp01((b - c) / torch.clamp(a, min=1e-12)),
                                s))
    t = _clamp01(t)

    # degenerate segments
    both_pts = (a <= 1e-12) & (e <= 1e-12)
    s = torch.where(both_pts, 0.0, torch.where(a <= 1e-12, 0.0, s))
    t = torch.where(both_pts, 0.0, torch.where(e <= 1e-12, 0.0, t))

    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    return c1, c2, squared_length(c1 - c2)
