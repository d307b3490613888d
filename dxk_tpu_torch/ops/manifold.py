"""Fixed-capacity contact-manifold machinery, batched over any leading
dimensions (the port's counterpart of the JAX package's ops/manifold.py):

  - `sutherland_hodgman`: polygon clipping with static-size (8-slot) buffers
    and a per-element vertex count;
  - `project_and_filter`: drop points behind the reference plane, project
    the rest onto it, compact them to the front;
  - `reduce_manifold`: 4-point manifold reduction (deepest / farthest /
    max-area selection with a relative tie margin).

A polygon is (verts (..., S, 3), depths (..., S), n (...,)) where slots
[0, n) are valid. The JAX package writes slots with one-hot matmuls; here
they are plain gathers and scatters. Every write target is unique, so both
give the same values.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import cross, dot, get_tangent, lerp

POLY_SLOTS = 8
_NEG = -3.4e38
# RELATIVE tie margin of reduce_manifold's vertex selection: a later vertex
# must beat the incumbent by REDUCE_TIE_TOL * (|best| + |cand|)
REDUCE_TIE_TOL = 1e-4


def signed_distance(p, plane):
    """plane = (nx, ny, nz, d); distance = n.p + d."""
    return dot(p, plane[..., :3]) + plane[..., 3]


def make_plane(point, normal):
    return torch.cat([normal, -dot(normal, point)[..., None]], dim=-1)


def _take(x, idx):
    """x (..., S) or (..., S, D); idx (..., K) int64 -> (..., K[, D])."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _put(idx, values, slots):
    """Write `values` at slot `idx` of a zero buffer of `slots` slots;
    indices >= slots are dropped. idx (..., K); values (..., K[, D])."""
    idx = torch.clamp(idx, max=slots)
    if values.dim() == idx.dim():
        out = values.new_zeros((*idx.shape[:-1], slots + 1))
        return out.scatter_(-1, idx, values)[..., :slots]
    d = values.shape[-1]
    out = values.new_zeros((*idx.shape[:-1], slots + 1, d))
    out.scatter_(-2, idx[..., None].expand(*idx.shape, d), values)
    return out[..., :slots, :]


def _clip_one_plane(verts, depths, n, plane):
    """One Sutherland-Hodgman pass. Emits, per input edge
    (v_i -> v_{i+1 mod n}): both inside -> [end]; start inside -> [clip];
    end inside -> [clip, end]; neither -> []."""
    S = verts.shape[-2]
    idx = torch.arange(S, device=verts.device)
    n_safe = torch.clamp(n, min=1)
    valid = idx < n[..., None]
    nxt = (idx + 1) % n_safe[..., None]

    end_v = _take(verts, nxt)
    end_d = _take(depths, nxt)

    sd_start = signed_distance(verts, plane[..., None, :])
    sd_end = signed_distance(end_v, plane[..., None, :])
    start_in = sd_start > 0.0
    end_in = sd_end > 0.0

    a_abs = torch.abs(sd_start)
    t = a_abs / torch.clamp(a_abs + torch.abs(sd_end), min=1e-12)
    clip_v = lerp(verts, end_v, t[..., None])
    clip_d = lerp(depths, end_d, t)

    emit_clip = (start_in != end_in) & valid
    emit_end = end_in & valid
    count = emit_clip.to(torch.int64) + emit_end.to(torch.int64)
    offset = torch.cumsum(count, dim=-1) - count
    new_n = torch.sum(count, dim=-1)

    first_v = torch.where(emit_clip[..., None], clip_v, end_v)
    first_d = torch.where(emit_clip, clip_d, end_d)
    i1 = torch.where(count >= 1, offset, S)
    i2 = torch.where(count == 2, offset + 1, S)
    tgt = torch.cat([i1, i2], dim=-1)
    out_v = _put(tgt, torch.cat([first_v, end_v], dim=-2), S)
    out_d = _put(tgt, torch.cat([first_d, end_d], dim=-1), S)
    return out_v, out_d, new_n


def sutherland_hodgman(verts, depths, n, planes):
    """Clip the polygon against each of `planes` (..., P, 4) in order."""
    for i in range(planes.shape[-2]):
        verts, depths, n = _clip_one_plane(verts, depths, n, planes[..., i, :])
    return verts, depths, n


def project_and_filter(verts, depths, n, ref_plane):
    """Drop points with depth < 0, project the survivors onto the reference
    plane and compact them to the front. Returns (verts, depths, n)."""
    S = verts.shape[-2]
    idx = torch.arange(S, device=verts.device)
    valid = (idx < n[..., None]) & (depths >= 0.0)
    verts = verts + ref_plane[..., None, :3] * depths[..., None]

    keep = valid.to(torch.int64)
    offset = torch.cumsum(keep, dim=-1) - keep
    new_n = torch.sum(keep, dim=-1)
    tgt = torch.where(valid, offset, S)
    return _put(tgt, verts, S), _put(tgt, depths, S), new_n


def reduce_manifold(verts, depths, n, normal):
    """Keep at most 4 points. Returns (points (..., 4, 3),
    pen_depths (..., 4), count (...,))."""
    S = verts.shape[-2]
    idx = torch.arange(S, device=verts.device)
    valid = idx < n[..., None]

    def masked_argmax(scores):
        # sequential first-wins max with a relative tie margin
        scores = torch.where(valid, scores, _NEG)
        best = scores[..., 0]
        bi = torch.zeros_like(n)
        for k in range(1, S):
            sk = scores[..., k]
            upd = sk > best + (REDUCE_TIE_TOL * (torch.abs(best)
                                                 + torch.abs(sk)) + 1e-9)
            best = torch.where(upd, sk, best)
            bi = torch.where(upd, k, bi)
        return bi

    def row(i):
        return _take(verts, i[..., None])[..., 0, :]

    # 1: extreme along a fixed tangent direction
    search = get_tangent(normal)
    i0 = masked_argmax(dot(verts, search[..., None, :]))
    p0 = row(i0)

    # 2: farthest from the first
    i1 = masked_argmax(torch.sum((verts - p0[..., None, :]) ** 2, dim=-1))
    p1 = row(i1)

    # 3: max signed triangle area with (p0, p1)
    nrm = normal[..., None, :]
    qa = p0[..., None, :] - verts
    qb = p1[..., None, :] - verts
    area3 = 0.5 * dot(cross(qa, qb), nrm)
    i2 = masked_argmax(area3)
    p2 = row(i2)

    # 4: max of the three sub-areas
    qc = p2[..., None, :] - verts
    a1 = 0.5 * dot(cross(qa, qb), nrm)
    a2 = 0.5 * dot(cross(qb, qc), nrm)
    a3 = 0.5 * dot(cross(qc, qa), nrm)
    i3 = masked_argmax(torch.maximum(torch.maximum(a1, a2), a3))

    sel = torch.stack([i0, i1, i2, i3], dim=-1)
    reduced_v = _take(verts, sel)
    reduced_d = _take(depths, sel)

    # n <= 4: keep the first n slots verbatim
    use_reduced = n > 4
    out_v = torch.where(use_reduced[..., None, None], reduced_v,
                        verts[..., :4, :])
    out_d = torch.where(use_reduced[..., None], reduced_d, depths[..., :4])
    count = torch.where(use_reduced, 4, n)
    return out_v, out_d, count
