"""Broadphase of the reference step, batched over environments: the port's
counterpart of the JAX package's ops/broadphase.py.

Two routes, chosen when the scene is finalized:

  - static candidate tables (``broadphase="table"``): each pair group is a
    pre-pruned (P, 2) table; a masked AABB test per pair, then compaction of
    the overlapping pairs into the group's fixed capacity with `topk`
    (lowest table index first). Dense tables (P within C^2 / 8 of all
    pairs) read a full (C, C) overlap matrix, built by the overlap-matrix
    kernel on a CUDA tensor; sparse ones test the gathered pairs;
  - dynamic broadphases (``broadphase="kselect"`` / ``"sap"``): one K-select
    or sort-and-sweep kernel pass over all colliders, then per pair-group
    compaction of the ~C*K candidates by class.

Overflow is counted, not dropped silently.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.ops.kernels.broadphase_kernel import aabb_overlap_matrix
from dxk_tpu_torch.ops.kernels.kselect_broadphase import (class_of,
                                                          kselect_broadphase)
from dxk_tpu_torch.ops.kernels.sap_broadphase import sap_broadphase


def is_dense(num_pairs: int, num_colliders: int) -> bool:
    """A table that is read from the full overlap matrix."""
    return num_pairs * 8 >= num_colliders * num_colliders


def aabb_overlap_mask(aabb_min, aabb_max, pairs, matrix=None):
    """aabb_min/max (B, C, 3); pairs (P, 2) collider indices. Returns
    (B, P) bool overlap. A dense table reads `matrix` (the (B, C, C) int8
    overlap matrix; built here when not given)."""
    B, c = aabb_min.shape[0], aabb_min.shape[1]
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    if is_dense(pairs.shape[0], c):
        if matrix is None:
            matrix = aabb_overlap_matrix(aabb_min, aabb_max)
        return matrix.reshape(B, c * c)[:, a * c + b] > 0
    mna, mxa = aabb_min[:, a], aabb_max[:, a]
    mnb, mxb = aabb_min[:, b], aabb_max[:, b]
    no = torch.any(mna > mxb, dim=-1) | torch.any(mnb > mxa, dim=-1)
    return ~no


def compact_pairs(pairs, mask, k):
    """Select up to `k` overlapping pairs per env, lowest pair index first.
    pairs (P, 2); mask (B, P). Returns (sel_pairs (B, k', 2),
    sel_mask (B, k'), num_dropped (B,)) with k' = min(k, P)."""
    B, p = mask.shape
    if k >= p:
        return (pairs[None].expand(B, p, 2),
                mask, torch.zeros(B, dtype=torch.int32, device=mask.device))
    idx = torch.arange(p, dtype=torch.int64, device=mask.device)
    score = torch.where(mask, p - idx, -idx)
    sel = torch.topk(score, k, dim=-1, sorted=True).indices
    sel_mask = torch.gather(mask, 1, sel)
    dropped = torch.clamp(torch.sum(mask, dim=-1, dtype=torch.int32) - k,
                          min=0)
    return pairs[sel], sel_mask, dropped


def kselect_group_pairs(scene, aabb_min, aabb_max):
    """Dynamic-broadphase path: one K-select (or sort-and-sweep) kernel pass
    over all colliders, then per pair-group compaction of the ~C*K
    candidates. Returns ({group_index: (pairs (B, cap, 2), mask (B, cap),
    dropped (B,))}, num_overlaps (B,), num_dropped_rows (B,))."""
    c = scene.colliders
    if scene.broadphase_kind == "sap":
        idx, cls, hits, wovf = sap_broadphase(
            aabb_min, aabb_max, c.body, c.owner_type, c.ctype,
            num_phases=scene.num_contact_phases, k_sel=scene.broadphase_k,
            window=scene.sap_window, broad_idx=scene.sap_broad)
        # the sweep accounts for its own loss (window overrun and K-select
        # drops); the dense side columns never drop
        row_dropped = wovf
    else:
        idx, cls, hits = kselect_broadphase(
            aabb_min, aabb_max, c.body, c.owner_type, c.ctype,
            num_phases=scene.num_contact_phases, k_sel=scene.broadphase_k)
        row_dropped = torch.sum(torch.clamp(hits - idx.shape[2], min=0),
                                dim=-1, dtype=torch.int32)
    B, C, K = idx.shape
    n = C * K
    flat_cls = cls.reshape(B, n)
    flat_j = idx.reshape(B, n)
    pos = torch.arange(n, dtype=torch.int64, device=idx.device)
    num_overlaps = torch.sum(hits, dim=-1, dtype=torch.int32)

    out = {}
    p = scene.num_contact_phases
    for gi, group in enumerate(scene.pair_groups):
        cls0 = class_of(group.type_a, group.type_b, group.phase, 0, p)
        cls1 = class_of(group.type_a, group.type_b, group.phase, 1, p)
        is_g = (flat_cls == cls0) | (flat_cls == cls1)
        cap = min(group.max_narrow, n)
        score = torch.where(is_g, n - pos, -pos)
        sel = torch.topk(score, cap, dim=-1, sorted=True).indices
        mask = torch.gather(is_g, 1, sel)
        i = (sel // K).to(torch.int32)
        j = torch.gather(flat_j, 1, sel)
        swapped = torch.gather(flat_cls, 1, sel) == cls1
        a = torch.where(swapped, j, i)
        b = torch.where(swapped, i, j)
        if group.type_a == group.type_b:
            # same-type pairs: lower collider index first, as in the tables
            a, b = torch.minimum(a, b), torch.maximum(a, b)
        # dead slots point at collider 0 (masked downstream)
        a = torch.where(mask, a, 0)
        b = torch.where(mask, b, 0)
        dropped = torch.clamp(torch.sum(is_g, dim=-1, dtype=torch.int32)
                              - cap, min=0)
        out[gi] = (torch.stack([a, b], dim=-1), mask, dropped)
    return out, num_overlaps, row_dropped
