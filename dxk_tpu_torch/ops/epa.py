"""Fixed-iteration EPA (expanding polytope algorithm), batched over pairs:
the JAX package's ops/epa.py (after the reference's epaCollisionInfo,
collision_epa.h:96-168).

The polytope is a fixed-size triangle soup with an active mask:
  - each iteration recomputes the triangles' normals and distances from
    the point array;
  - the horizon of the new support point is the set of directed edges of
    removed (visible) triangles whose reverse edge is not also removed.
    The JAX package finds reverse edges through a (points x points)
    incidence built with one-hot matmuls (its TPU idiom); here the
    flagged edges are counted into a (points x points) integer table by
    index (scatter_add_ of 0 / 1, exact and order-free), which is then
    read at each edge's reverse;
  - the next triangle list is the surviving old triangles, then the
    horizon fan triangles, in order (a top-k over distinct scores).
Like the reference it returns its best approximation (the closest face)
when the iteration cap is hit. Point rows are (pA, pB, minkowski)
triples; the contact point comes from the closest face's barycentric
coordinates. Its 3-term sums are ops/gjk.py's, written out so that the
card adds as the CPU does.

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import cross, sqrt
from dxk_tpu_torch.ops.gjk import dot, squared_length

_BIG = 3.4e38


def _gather_points(mink, tris):
    """mink (P, NP, 3) at tris (P, T, 3) -> (P, T, 3, 3)."""
    P, T = tris.shape[:2]
    idx = tris.reshape(P, T * 3, 1).expand(P, T * 3, 3)
    return torch.gather(mink, 1, idx).reshape(P, T, 3, 3)


def _triangle_info(mink, tris):
    """Normals pointing away from the origin and distances to it, for
    every triangle slot (epa_simplex::getTriangleInfo)."""
    g = _gather_points(mink, tris)
    a, b, c = g[..., 0, :], g[..., 1, :], g[..., 2, :]
    n = cross(b - a, c - a)
    n = n / torch.clamp(sqrt(squared_length(n)), min=1e-12)[..., None]
    d = dot(n, a)
    n = torch.where((d < 0.0)[..., None], -n, n)
    return n, torch.abs(d)


def _row(x, i):
    """x (P, T, ...) at row i (P,) -> (P, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), i]


def epa(support_a, support_b, a_params, b_params, simplex,
        max_iterations=20):
    """simplex: (P, 4, 3, 3) from gjk_intersection. Returns (point (P, 3),
    normal (P, 3), depth (P,))."""
    NP = 4 + max_iterations                 # point capacity
    T = 4 + 2 * max_iterations + 4          # triangle slots
    P = simplex.shape[0]
    dev = simplex.device

    pts = torch.zeros((P, NP, 3, 3), dtype=simplex.dtype, device=dev)
    pts[:, :4] = simplex
    n_pts = torch.full((P,), 4, dtype=torch.int64, device=dev)
    tris = torch.zeros((P, T, 3), dtype=torch.int64, device=dev)
    tris[:, :4] = torch.tensor([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 2, 1]],
                               device=dev)
    active = torch.zeros((P, T), dtype=torch.bool, device=dev)
    active[:, :4] = True
    done = torch.zeros((P,), dtype=torch.bool, device=dev)
    slots = torch.arange(NP, device=dev)
    n4 = 4 * T
    cand_i = torch.arange(n4, device=dev)

    for _ in range(max_iterations):
        mink = pts[:, :, 2]
        normals, dists = _triangle_info(mink, tris)
        closest = torch.argmin(torch.where(active, dists, _BIG), dim=-1)
        n_c = _row(normals, closest)
        pa = support_a(a_params, n_c)
        pb = support_b(b_params, -n_c)
        w = pa - pb
        converged = (dot(w, n_c) - _row(dists, closest)) < 0.01
        step = ~done & ~converged

        # faces visible from w go; their edges without a visible reverse
        # edge are the horizon
        visible = active & (dot(normals, w[:, None, :]) > dists)
        edges = torch.cat([tris[..., [0, 1]], tris[..., [1, 2]],
                           tris[..., [2, 0]]], dim=1)         # (P, 3T, 2)
        eflag = torch.cat([visible, visible, visible], dim=1)
        u, v = edges[..., 0], edges[..., 1]
        count = torch.zeros((P, NP * NP), dtype=torch.int32, device=dev)
        count.scatter_add_(1, u * NP + v, eflag.to(torch.int32))
        rev_present = torch.gather(count, 1, v * NP + u) > 0
        horizon = eflag & ~rev_present

        new_tris = torch.stack([u, v, n_pts[:, None].expand_as(u)], dim=-1)
        cand_tris = torch.cat([tris, new_tris], dim=1)         # (P, 4T, 3)
        cand_flag = torch.cat([active & ~visible, horizon], dim=1)
        # order-keeping compaction: flagged slots first, each group in
        # index order (the scores are distinct)
        order_score = torch.where(cand_flag, n4 - cand_i, -cand_i)
        sel = torch.topk(order_score, T, dim=-1).indices
        tris_n = torch.gather(cand_tris, 1, sel[..., None].expand(P, T, 3))
        active_n = torch.gather(cand_flag, 1, sel)

        overflow = torch.sum(cand_flag, -1) > T
        added_any = horizon.any(-1) & (n_pts < NP) & ~overflow
        grow = step & added_any
        write = (slots == n_pts[:, None]) & grow[:, None]
        pts = torch.where(write[..., None, None],
                          torch.stack([pa, pb, w], dim=-2)[:, None], pts)
        n_pts = torch.where(grow, n_pts + 1, n_pts)
        done = done | converged | (step & ~added_any)
        tris = torch.where(grow[:, None, None], tris_n, tris)
        active = torch.where(grow[:, None], active_n, active)

    mink = pts[:, :, 2]
    normals, dists = _triangle_info(mink, tris)
    closest = torch.argmin(torch.where(active, dists, _BIG), dim=-1)
    tri = _row(tris, closest)                                  # (P, 3)
    n = _row(normals, closest)
    depth = _row(dists, closest)

    # barycentric coordinates of the origin's projection on the face
    # (getBarycentricCoordinates, math.cpp:1374-1398)
    a, b, c = (_row(mink, tri[:, k]) for k in range(3))
    p = n * depth[:, None]
    v0, v1, v2 = b - a, c - a, p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < 1e-6, 1.0, denom)
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    bu = 1.0 - bv - bw

    corner = [_row(pts, tri[:, k]) for k in range(3)]          # (P, 3, 3)
    pa = (bu[:, None] * corner[0][:, 0] + bv[:, None] * corner[1][:, 0]
          + bw[:, None] * corner[2][:, 0])
    pb = (bu[:, None] * corner[0][:, 1] + bv[:, None] * corner[1][:, 1]
          + bw[:, None] * corner[2][:, 1])
    return 0.5 * (pa + pb), n, depth
