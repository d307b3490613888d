"""Fused broadphase with per-row K-select, batched over environments.

Replaces the JAX package's ``ops/pallas/kselect_broadphase.py::
kselect_broadphase`` (body ``_kselect_kernel``). One pass over the C x C
pair space tests AABB overlap, prunes and classifies each pair inline from
the per-collider (owner kind, body, shape type) vectors, and keeps per row
the K lowest partner indices, their classes and the row's hit count. A
pair's class encodes (type bucket, contact phase, operand swap); see
`class_of`. Placement: dynamic-dynamic pairs in the lower-indexed row,
static-dynamic pairs in the dynamic row, so a large static ground never
fills its own row.

Holds `class_of`, the plain PyTorch version `kselect_broadphase_plain`, and
the wrapper `kselect_broadphase` around ``kselect_kernel`` of
``csrc/broadphase.cu`` (plain version for CPU tensors, kernel for CUDA
tensors, or it raises).

What bounds the kernel on an H100: operations (the pair tests; K + 1
integers per row leave the chip). A block takes one env and 32 rows, one
thread a row in each of its four warps, the row's AABB, body and shape type
in registers. It walks only the columns the placement rule admits, in
ascending order (the env's statics below the tile, listed with a ballot
over `owner_type`, then every column from the tile's first row on), cut
into four consecutive slices, one a warp. Each warp streams its slice
through shared memory as float4s read by all lanes at once, tests eight
columns at a time without a branch, and keeps its first K hits; warp 0
appends the others' in slice order and counts every hit. A row that is not
a rigid body writes padding and a count of 0 at once. For K > 16 one warp
walks the whole list (the slices' hits would not fit in shared memory).
Rigid bodies' indices must not be INT_MIN (the kernel's "no body" mark).
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
from dxk_tpu_torch.ops.kernels import build

BIG_J = 1 << 20

_LAUNCHES = 0


def launch_count() -> int:
    """Kernel launches made by the wrapper since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def class_of(ta, tb, phase, swap, num_phases):
    """Pair class id: 1 + ((bucket * num_phases + phase) * 2 + swap).
    bucket is the upper-triangle index over sorted shape types. Works on
    ints or int tensors; 0 means 'no candidate'."""
    if isinstance(ta, int):
        lo, hi = min(ta, tb), max(ta, tb)
    else:
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    bucket = lo * 5 - lo * (lo - 1) // 2 + (hi - lo)
    return 1 + (bucket * num_phases + phase) * 2 + swap


def overlap_3axes(rmn, rmx, cmn, cmx):
    """AABB overlap of rows against columns (broadcast), axis by axis."""
    ov = None
    for a in range(3):
        sep = (rmn[..., a] > cmx[..., a]) | (cmn[..., a] > rmx[..., a])
        ov = ~sep if ov is None else ov & ~sep
    return ov


def select_k(mask, cls, jj, k_sel):
    """K masked lane-min reductions over the last axis: the K lowest column
    indices `jj` where `mask`, with their classes; -1 / 0 padding."""
    idx_out, cls_out = [], []
    big = torch.full((), BIG_J, dtype=jj.dtype, device=jj.device)
    for _ in range(k_sel):
        jsel = torch.amin(torch.where(mask, jj, big), dim=-1)
        valid = jsel < BIG_J
        hitk = mask & (jj == jsel[..., None])
        clsk = torch.amax(torch.where(hitk, cls, 0), dim=-1)
        idx_out.append(torch.where(valid, jsel, -1))
        cls_out.append(clsk)
        mask = mask & ~hitk
    return (torch.stack(idx_out, -1).to(torch.int32),
            torch.stack(cls_out, -1).to(torch.int32))


def kselect_broadphase_plain(aabb_min, aabb_max, body, owner_type, ctype,
                             num_phases: int, k_sel: int):
    """Plain version. aabb_min/max (B, C, 3); body/owner_type/ctype (C,)."""
    C = aabb_min.shape[1]
    dev = aabb_min.device
    ov = overlap_3axes(aabb_min[:, :, None, :], aabb_max[:, :, None, :],
                       aabb_min[:, None, :, :], aabb_max[:, None, :, :])

    jj = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    ii = torch.arange(C, dtype=torch.int32, device=dev)[:, None]
    body = body.to(torch.int32)
    owner = owner_type.to(torch.int32)
    ctype = ctype.to(torch.int32)
    body_i, body_j = body[:, None], body[None, :]
    ctype_i, ctype_j = ctype[:, None], ctype[None, :]
    rb_i, rb_j = owner[:, None] == 0, owner[None, :] == 0
    st_j = owner[None, :] == 1

    dd = rb_i & rb_j
    placed = (dd & (jj > ii)) | (rb_i & st_j)
    allowed = placed & ~(dd & (body_i == body_j))
    dyn_min = torch.where(dd, torch.minimum(body_i, body_j),
                          torch.where(rb_i, body_i, body_j))
    is_sd = ~dd
    phase = (dyn_min + 2 * is_sd.to(torch.int32)) % num_phases
    swap = (ctype_i > ctype_j).to(torch.int32)
    cls_static = class_of(ctype_i, ctype_j, phase, swap, num_phases)
    cls = torch.where(allowed[None] & ov, cls_static[None], 0).to(torch.int32)

    mask = cls > 0
    cnt = torch.sum(mask, dim=-1, dtype=torch.int32)
    idx, cls_k = select_k(mask, cls, jj.expand(C, C), k_sel)
    return idx, cls_k, cnt


def kselect_broadphase(aabb_min, aabb_max, body, owner_type, ctype,
                       num_phases: int = 1, k_sel: int = 8):
    """aabb_min/max: (B, C, 3) float32; body/owner_type/ctype: (C,) int32.
    Returns (partner_idx (B, C, K) int32 with -1 padding,
             partner_cls (B, C, K) int32 with 0 padding,
             row_hits (B, C) int32).
    Candidate pair k of row i is (i, partner_idx[i, k]) with class
    partner_cls[i, k]; row_hits > K means dropped pairs. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    global _LAUNCHES
    if aabb_min.device.type == "cpu":
        return kselect_broadphase_plain(aabb_min, aabb_max, body, owner_type,
                                        ctype, num_phases, k_sel)
    who = "kselect_broadphase"
    B, C = aabb_min.shape[0], aabb_min.shape[1]
    build.check_cuda(who, "aabb_min", aabb_min, (B, C, 3))
    build.check_cuda(who, "aabb_max", aabb_max, (B, C, 3))
    for name, x in (("body", body), ("owner_type", owner_type),
                    ("ctype", ctype)):
        build.check_cuda(who, name, x, (C,), torch.int32)
    if B == 0 or C == 0 or C > bk.MAX_ROWS or k_sel < 1 or num_phases < 1:
        raise ValueError(f"{who}: needs B > 0, 0 < C <= {bk.MAX_ROWS}, "
                         f"K >= 1 and num_phases >= 1, got B={B}, C={C}, "
                         f"K={k_sel}, num_phases={num_phases}")
    lib = bk.load_library()
    dev = aabb_min.device
    idx = torch.empty((B, C, k_sel), dtype=torch.int32, device=dev)
    cls = torch.empty((B, C, k_sel), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, C), dtype=torch.int32, device=dev)
    build.raise_on_error(who, lib.dxk_kselect_launch(
        B, C, int(k_sel), int(num_phases), aabb_min.data_ptr(),
        aabb_max.data_ptr(), body.data_ptr(), owner_type.data_ptr(),
        ctype.data_ptr(), idx.data_ptr(), cls.data_ptr(), cnt.data_ptr(),
        build.stream_of(aabb_min)))
    _LAUNCHES += 1
    return idx, cls, cnt
