"""Sort-and-sweep broadphase, batched over environments.

Replaces the JAX package's ``ops/pallas/sap_broadphase.py::sap_broadphase``
(body ``_sap_kernel``):

  1. sort colliders by AABB x-min (a stable argsort per env);
  2. sweep a window of the sorted order: every pair that overlaps on x has
     its partner later in sorted order, within the next few sorted tiles.
     Row ii of row tile i0 = (ii // 128) * 128 visits columns
     [i0, i0 + window * 128) and keeps up to K partners with the same
     pruning and classification as the K-select broadphase;
  3. colliders with huge extents (the ground, arena walls; `broad_idx`) are
     left out of the sweep and paired by a dense (C x S) side pass.

A row whose x-interval reaches past its window sets a window-overflow flag.
Steps 1 and 3 and the scatter back to original collider indices are plain
tensor code in the JAX package too and stay PyTorch here; step 2 is the
kernel: `sap_sweep` wraps ``sap_kernel`` of ``csrc/broadphase.cu`` (plain
version `sap_sweep_plain` for CPU tensors; CUDA tensors launch the kernel or
raise).

What bounds the kernel on an H100: bytes at the box stack's sizes (K + 2
integers a row leave the chip), once each row's walk ends where its
x-interval does. A block takes one env and 32 rows of one tile, a thread a
row in each of its four warps. It finds each row's exact stop (`sweep_stops`
is its plain form): the first column past the row whose suffix minimum of
x-mins over the rest of the window, NaN read as -inf, exceeds the row's
max-x, so that every later column fails the x test whatever the order of
the input. It then walks only the columns from its first row on to the
largest stop, cut into four slices a warp each, staged in shared memory as
float4 pairs and tested eight at a time without a branch; the placement and
same-body rules run only on the columns that overlap. The slices' hits are
merged in order in a shared tile of the block's rows, which goes out as one
contiguous range. The overflow flag still reads the window's last column.
Past MAX_K partners a row the tile would not fit a block: one warp walks the
columns and each thread writes its row's hits straight into the outputs, in
ascending order, so any K runs on the card.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
from dxk_tpu_torch.ops.kernels import build
from dxk_tpu_torch.ops.kernels.kselect_broadphase import (class_of,
                                                          overlap_3axes,
                                                          select_k)

TILE = 128
BIG = 3.0e38
MAX_K = 256     # the most partners a row the kernel's shared tile keeps

_LAUNCHES = 0


def launch_count() -> int:
    """Kernel launches made by the wrapper since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def sap_sweep_plain(mn_s, mx_s, body_s, owner_s, ctype_s, num_phases: int,
                    k_sel: int, window: int):
    """Plain version of the sweep over sorted colliders. mn_s/mx_s
    (B, C, 3); body_s/owner_s/ctype_s (B, C) int32, all in sorted order.
    Returns (idx_s (B, C, K), cls_s (B, C, K), cnt_s (B, C),
    ovf_s (B, C)), partner indices in sorted space."""
    B, C = mn_s.shape[0], mn_s.shape[1]
    dev = mn_s.device
    rows = torch.arange(C, dtype=torch.int64, device=dev)
    i0 = (rows // TILE) * TILE
    W = window * TILE
    cols = i0[:, None] + torch.arange(W, dtype=torch.int64, device=dev)
    in_range = cols < C                                   # (C, W)
    colc = torch.clamp(cols, max=C - 1)

    def col(x):                                           # (B, C) -> (B, C, W)
        return x[:, colc]

    cmn = mn_s[:, colc]                                   # (B, C, W, 3)
    cmx = mx_s[:, colc]
    ov = overlap_3axes(mn_s[:, :, None, :], mx_s[:, :, None, :], cmn, cmx)
    ov = ov & in_range

    body_s, owner_s, ctype_s = (x.to(torch.int32)
                                for x in (body_s, owner_s, ctype_s))
    body_i, body_j = body_s[:, :, None], col(body_s)
    ctype_i, ctype_j = ctype_s[:, :, None], col(ctype_s)
    rb_i, st_i = owner_s[:, :, None] == 0, owner_s[:, :, None] == 1
    owner_j = col(owner_s)
    rb_j, st_j = owner_j == 0, owner_j == 1
    jj = cols.to(torch.int32)[None]
    ii = rows.to(torch.int32)[None, :, None]

    allowed = (jj > ii) & ((rb_i & (rb_j | st_j)) | (st_i & rb_j))
    dd = rb_i & rb_j
    allowed = allowed & ~(dd & (body_i == body_j)) & in_range
    dyn_min = torch.where(dd, torch.minimum(body_i, body_j),
                          torch.where(rb_i, body_i, body_j))
    phase = (dyn_min + 2 * (~dd).to(torch.int32)) % num_phases
    swap = (ctype_i > ctype_j).to(torch.int32)
    cls = torch.where(allowed & ov,
                      class_of(ctype_i, ctype_j, phase, swap, num_phases),
                      0).to(torch.int32)
    mask = cls > 0
    cnt = torch.sum(mask, dim=-1, dtype=torch.int32)

    # window overflow: the row's x-interval reaches the min-x of the
    # window's last column (+BIG past the end)
    last = i0 + W - 1
    end_minx = torch.where(last < C, mn_s[:, torch.clamp(last, max=C - 1), 0],
                           torch.full((), BIG, dtype=mn_s.dtype, device=dev))
    ovf = (mx_s[..., 0] >= end_minx).to(torch.int32)

    idx, cls_k = select_k(mask, cls, jj.expand(B, C, W), k_sel)
    return idx, cls_k, cnt, ovf


def sweep_stops(mn_s, mx_s, window: int):
    """Where the kernel ends each sorted row's walk, (B, C) int64: the first
    column j > ii of the row's window whose suffix minimum of x-mins over
    the rest of the window (NaN read as -inf) exceeds the row's max-x, else
    the window's end (capped at C). No column from there on passes the x
    test, sorted input or not, so no hit lies there."""
    B, C = mn_s.shape[0], mn_s.shape[1]
    dev = mn_s.device
    x = mn_s[..., 0]
    x = torch.where(torch.isnan(x), torch.full((), -float("inf"),
                                               dtype=x.dtype, device=dev), x)
    rows = torch.arange(C, dtype=torch.int64, device=dev)
    stops = []
    for t0 in range(0, C, TILE):
        je = min(t0 + window * TILE, C)
        sm = torch.flip(torch.cummin(torch.flip(x[:, t0:je], [1]), 1).values,
                        [1])                                 # (B, W)
        r = rows[t0:t0 + TILE]
        past = ((sm[:, None, :] > mx_s[:, t0:t0 + TILE, 0, None])
                & (rows[None, None, t0:je] > r[None, :, None]))
        stops.append(torch.where(past.any(-1),
                                 past.to(torch.int8).argmax(-1) + t0, je))
    return torch.cat(stops, dim=1)


def sap_sweep(mn_s, mx_s, body_s, owner_s, ctype_s, num_phases: int,
              k_sel: int, window: int):
    """The sweep over sorted colliders (see `sap_sweep_plain`). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global _LAUNCHES
    if mn_s.device.type == "cpu":
        return sap_sweep_plain(mn_s, mx_s, body_s, owner_s, ctype_s,
                               num_phases, k_sel, window)
    who = "sap_sweep"
    B, C = mn_s.shape[0], mn_s.shape[1]
    build.check_cuda(who, "mn_s", mn_s, (B, C, 3))
    build.check_cuda(who, "mx_s", mx_s, (B, C, 3))
    for name, x in (("body_s", body_s), ("owner_s", owner_s),
                    ("ctype_s", ctype_s)):
        build.check_cuda(who, name, x, (B, C), torch.int32)
    if (B == 0 or C == 0 or C > bk.MAX_ROWS or k_sel < 1
            or num_phases < 1 or window < 1):
        raise ValueError(f"{who}: needs B > 0, 0 < C <= {bk.MAX_ROWS}, "
                         f"K, num_phases and window >= 1, "
                         f"got B={B}, C={C}, K={k_sel}, "
                         f"num_phases={num_phases}, window={window}")
    lib = bk.load_library()
    dev = mn_s.device
    idx = torch.empty((B, C, k_sel), dtype=torch.int32, device=dev)
    cls = torch.empty((B, C, k_sel), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, C), dtype=torch.int32, device=dev)
    ovf = torch.empty((B, C), dtype=torch.int32, device=dev)
    build.raise_on_error(who, lib.dxk_sap_launch(
        B, C, int(k_sel), int(num_phases), int(window), mn_s.data_ptr(),
        mx_s.data_ptr(), body_s.data_ptr(), owner_s.data_ptr(),
        ctype_s.data_ptr(), idx.data_ptr(), cls.data_ptr(), cnt.data_ptr(),
        ovf.data_ptr(), build.stream_of(mn_s)))
    _LAUNCHES += 1
    return idx, cls, cnt, ovf


def sort_for_sweep(aabb_min, aabb_max, body, owner_type, ctype,
                   broad_idx: tuple = ()):
    """The sweep's inputs: colliders in ascending x-min order per env
    (stable, so equal x-mins keep their index order), the broad colliders
    given empty AABBs so they sort last. Returns (order (B, C) int64,
    mn_s, mx_s (B, C, 3), body_s, owner_s, ctype_s (B, C) int32)."""
    B, C = aabb_min.shape[0], aabb_min.shape[1]
    dev = aabb_min.device
    if broad_idx:
        big = torch.full((), BIG, dtype=aabb_min.dtype, device=dev)
        bsel = torch.zeros(C, dtype=torch.bool, device=dev)
        bsel[list(broad_idx)] = True
        swp_min = torch.where(bsel[:, None], big, aabb_min)
        swp_max = torch.where(bsel[:, None], -big, aabb_max)
    else:
        swp_min, swp_max = aabb_min, aabb_max
    order = torch.argsort(swp_min[..., 0], dim=-1, stable=True)
    o3 = order[..., None].expand(B, C, 3)
    return (order, torch.gather(swp_min, 1, o3).contiguous(),
            torch.gather(swp_max, 1, o3).contiguous(),
            *(x.to(torch.int32)[order].contiguous()
              for x in (body, owner_type, ctype)))


def sap_broadphase(aabb_min, aabb_max, body, owner_type, ctype,
                   num_phases: int = 1, k_sel: int = 8, window: int = 4,
                   broad_idx: tuple = ()):
    """Sort-and-sweep broadphase. aabb_min/max (B, C, 3); body/owner_type/
    ctype (C,) int32. Returns, in ORIGINAL collider index space,
    (partner_idx (B, C, K+S) int32 with -1 padding, partner_cls (B, C, K+S)
    int32 with 0 padding, row_hits (B, C) int32, window_overflow (B,) int32)
    where S = len(broad_idx): the broad colliders are paired densely
    against every collider in S extra partner columns."""
    B, C = aabb_min.shape[0], aabb_min.shape[1]
    dev = aabb_min.device
    body = body.to(torch.int32)
    owner_type = owner_type.to(torch.int32)
    ctype = ctype.to(torch.int32)
    order, mn_s, mx_s, body_s, owner_s, ctype_s = sort_for_sweep(
        aabb_min, aabb_max, body, owner_type, ctype, broad_idx)
    idx_s, cls_s, cnt_s, ovf_s = sap_sweep(
        mn_s, mx_s, body_s, owner_s, ctype_s, num_phases, k_sel, window)

    # partners back to original collider ids; rows scattered back (order is
    # a permutation, so every row is written)
    partner = torch.gather(order, 1, torch.clamp(idx_s, min=0).long()
                           .reshape(B, -1)).reshape(B, C, k_sel)
    idx_orig = torch.where(idx_s >= 0, partner.to(torch.int32), -1)
    ok = order[..., None].expand(B, C, k_sel)
    idx = torch.zeros_like(idx_s).scatter_(1, ok, idx_orig)
    cls = torch.zeros_like(cls_s).scatter_(1, ok, cls_s)
    hits = torch.zeros_like(cnt_s).scatter_(1, order, cnt_s)
    # overflow folds both loss modes: rows whose x-interval outran the
    # window, and rows whose in-window hits outran the K output slots
    window_overflow = (torch.sum(ovf_s, dim=-1, dtype=torch.int32)
                       + torch.sum(torch.clamp(cnt_s - k_sel, min=0), dim=-1,
                                   dtype=torch.int32))

    # dense side pass against the broad statics: S extra columns
    if broad_idx:
        bi = torch.tensor(broad_idx, dtype=torch.int64, device=dev)   # (S,)
        bmn, bmx = aabb_min[:, bi], aabb_max[:, bi]                   # (B, S, 3)
        no = (torch.any(aabb_min[:, :, None] > bmx[:, None], dim=-1)
              | torch.any(bmn[:, None] > aabb_max[:, :, None], dim=-1))
        ov = ~no                                                      # (B, C, S)
        rb_i = (owner_type == 0)[:, None]
        not_self = torch.arange(C, device=dev)[:, None] != bi[None]
        allowed = ov & rb_i & not_self
        ct_i = ctype[:, None]
        ct_b = ctype[bi][None]
        phase = (body[:, None] + 2) % num_phases
        swap = (ct_i > ct_b).to(torch.int32)
        bcls = torch.where(allowed,
                           class_of(ct_i, ct_b, phase, swap, num_phases),
                           0).to(torch.int32)
        bidx = torch.where(allowed, bi.to(torch.int32)[None, None], -1
                           ).to(torch.int32)
        idx = torch.cat([idx, bidx], dim=-1)
        cls = torch.cat([cls, bcls], dim=-1)
        hits = hits + torch.sum(allowed, dim=-1, dtype=torch.int32)

    return idx, cls, hits, window_overflow
