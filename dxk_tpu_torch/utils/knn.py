"""Brute-force k-nearest-neighbour queries for editor picking: a dense
masked distance matrix and a sort, faster than a tree at the point counts
an engine scene holds. Counterpart of the JAX package's utils/knn.py."""

from __future__ import annotations

import torch


def knn(points, queries, k, mask=None):
    """points (..., N, 3), queries (..., Q, 3) -> (indices (..., Q, k)
    int64, sq_dists (..., Q, k)), nearest first; equal distances go to the
    lower index (as lax.top_k orders them: a stable sort). `mask` (..., N)
    marks the valid points."""
    d = queries[..., :, None, :] - points[..., None, :, :]
    sq = torch.sum(d * d, dim=-1)                           # (..., Q, N)
    if mask is not None:
        sq = torch.where(mask[..., None, :], sq, 3.4e38)
    sq_sorted, idx = torch.sort(sq, dim=-1, stable=True)
    return idx[..., :k], sq_sorted[..., :k]


def nearest(points, query, mask=None):
    """Nearest neighbour of one query point (..., 3): (index, sq_dist)."""
    idx, sq = knn(points, query[..., None, :], 1, mask)
    return idx[..., 0, 0], sq[..., 0, 0]
