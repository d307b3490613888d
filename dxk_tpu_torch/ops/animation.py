"""Skeletal animation: clip sampling, pose blending, hierarchy composition,
skinning matrices and root-motion instances: the JAX package's
ops/animation.py (after the reference's src/animation/animation.cpp).

- Every joint's channels live in one padded (J, K) table; the keyframe
  search is a branchless count and the two keys are gathered by index
  (the JAX package sums one-hot products; the where-guards against
  0 x inf on the +inf padding stay). Rotations are sign-fixed, then
  NLERPed (sampleRotation).
- Root motion and the bake flags of sampleAnimation (animation.cpp:
  333-396); blendLocalTransforms without a hemisphere fix, as the
  reference.
- Hierarchy composition walks the joints in index order over the static
  `parents` (i > parents[i]), a Python loop over (I, ...) tensors.
- animation_instance::update: time advance, loop wrap (torch.remainder,
  which takes the divisor's sign as jnp.mod does) or clamp, delta root
  motion = invert(lastRootMotion) * rootMotion.

A clip is shared by every instance; times, poses and instances carry a
leading batch dimension (I, ...), or none. Products are broadcast
multiply-sums (no matmul, so no TF32 on the card).

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dxk_tpu_torch.core.maths import (quat_conj, quat_mul, quat_normalize,
                                      quat_rotate, quat_to_mat3)
from dxk_tpu_torch.scene.scene import _Struct

INF = np.float32(np.inf)


# -- trs algebra with scale (math.cpp:477-505)


@dataclass
class Trs(_Struct):
    pos: torch.Tensor     # (..., 3)
    rot: torch.Tensor     # (..., 4) xyzw
    scale: torch.Tensor   # (..., 3)


def trs_identity(batch_shape=(), device="cuda"):
    return Trs(pos=torch.zeros(batch_shape + (3,), device=device),
               rot=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
               .expand(batch_shape + (4,)),
               scale=torch.ones(batch_shape + (3,), device=device))


def trs_mul(a: Trs, b: Trs) -> Trs:
    """operator*(trs, trs) (math.cpp:477-488)."""
    return Trs(pos=quat_rotate(a.rot, a.scale * b.pos) + a.pos,
               rot=quat_mul(a.rot, b.rot), scale=a.scale * b.scale)


def trs_invert(t: Trs) -> Trs:
    """invert(trs) (math.cpp:491-505)."""
    inv_rot = quat_conj(t.rot)
    inv_scale = 1.0 / t.scale
    return Trs(pos=quat_rotate(inv_rot, inv_scale * -t.pos), rot=inv_rot,
               scale=inv_scale)


def trs_lerp(a: Trs, b: Trs, t) -> Trs:
    """lerp(trs) (math.h:675-681): component lerp, quaternion NLERP, no
    hemisphere fix."""
    t = torch.as_tensor(t, dtype=torch.float32, device=a.pos.device)[..., None]
    return Trs(pos=a.pos + (b.pos - a.pos) * t,
               rot=quat_normalize(a.rot + (b.rot - a.rot) * t),
               scale=a.scale + (b.scale - a.scale) * t)


def trs_to_mat4(t: Trs) -> torch.Tensor:
    """Rotation * scale in the upper 3x3, translation in the last
    column."""
    m3 = quat_to_mat3(t.rot) * t.scale[..., None, :]
    top = torch.cat([m3, t.pos[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=t.pos.device).expand(
        *t.pos.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


# -- clips: padded per-joint channel tables


@dataclass
class Channel(_Struct):
    """One keyframe channel for every joint: timestamps padded with +inf,
    values padded by repeating the last real keyframe."""

    ts: torch.Tensor      # (J, K)
    vals: torch.Tensor    # (J, K, D)
    count: torch.Tensor   # (J,) int32


@dataclass
class AnimationClip(_Struct):
    """animation_clip (animation.h:71-97) with flattened channels; the
    root-motion joint is the last row of each channel (index J)."""

    pos: Channel
    rot: Channel
    scale: Channel
    animated: torch.Tensor        # (J+1,) bool
    length: torch.Tensor          # () f32
    looping: bool = field(default=True)
    bake_root_rotation: bool = field(default=False)
    bake_root_xz: bool = field(default=False)
    bake_root_y: bool = field(default=False)


def _pack_channel(tracks, dim, default, device):
    """tracks: (timestamps, values) per joint (empty: unanimated)."""
    k = max(1, max((len(t) for t, _ in tracks), default=1))
    J = len(tracks)
    ts = np.full((J, k), INF, np.float32)
    vals = np.tile(np.asarray(default, np.float32), (J, k, 1))
    count = np.zeros((J,), np.int32)
    for j, (t, v) in enumerate(tracks):
        n = len(t)
        count[j] = n
        if n:
            ts[j, :n] = np.asarray(t, np.float32)
            vv = np.asarray(v, np.float32).reshape(n, dim)
            vals[j, :n] = vv
            vals[j, n:] = vv[-1]
    return Channel(ts=torch.from_numpy(ts).to(device),
                   vals=torch.from_numpy(vals).to(device),
                   count=torch.from_numpy(count).to(device))


def make_clip(pos_tracks, rot_tracks, scale_tracks, length, root_pos=None,
              root_rot=None, root_scale=None, looping=True,
              bake_root_rotation=False, bake_root_xz=False,
              bake_root_y=False, device="cuda") -> AnimationClip:
    """A clip from per-joint (timestamps, values) track lists; the
    optional root_* tracks become the root-motion row."""
    empty = ([], [])
    pos_tracks = list(pos_tracks) + [root_pos or empty]
    rot_tracks = list(rot_tracks) + [root_rot or empty]
    scale_tracks = list(scale_tracks) + [root_scale or empty]
    animated = np.array([len(t) > 0 or len(r) > 0 or len(s) > 0
                         for (t, _), (r, __), (s, ___)
                         in zip(pos_tracks, rot_tracks, scale_tracks)])
    return AnimationClip(
        pos=_pack_channel(pos_tracks, 3, (0.0, 0.0, 0.0), device),
        rot=_pack_channel(rot_tracks, 4, (0.0, 0.0, 0.0, 1.0), device),
        scale=_pack_channel(scale_tracks, 3, (1.0, 1.0, 1.0), device),
        animated=torch.from_numpy(animated).to(device),
        length=torch.tensor(length, dtype=torch.float32, device=device),
        looping=looping, bake_root_rotation=bake_root_rotation,
        bake_root_xz=bake_root_xz, bake_root_y=bake_root_y)


def _at_key(x, idx):
    """x (J, K, ...) at key idx (..., J) -> (..., J, ...)."""
    j = torch.arange(x.shape[0], device=x.device)
    return x[j, idx]


def _sample_channel(ch: Channel, time, length, hemi_fix=False):
    """samplePosition / Rotation / Scale (animation.cpp:220-330) of every
    joint at `time` (...,). Returns (..., J_rows, D)."""
    k = ch.ts.shape[1]
    last = _at_key(ch.vals, torch.clamp(ch.count.long() - 1, min=0))
    if k == 1:
        return last.expand(*time.shape, *last.shape)
    # first j with time < ts[j+1] == #{jj in [1, count-1]: ts[jj] <= time}
    # (the +inf padding never counts); clamped to count-2
    tt = time[..., None, None]
    jj = torch.arange(k, device=ch.ts.device)
    idx = torch.sum((jj >= 1) & (jj <= ch.count[:, None] - 1)
                    & (ch.ts <= tt), dim=-1)
    idx = torch.minimum(idx, torch.clamp(ch.count.long() - 2, min=0))
    t0 = _at_key(ch.ts, idx)
    t1 = _at_key(ch.ts, idx + 1)
    a = _at_key(ch.vals, idx)
    b = _at_key(ch.vals, idx + 1)
    if hemi_fix:                 # sampleRotation's dot < 0 flip
        s = torch.where(torch.sum(a * b, -1) < 0.0, -1.0, 1.0)
        b = b * s[..., None]
    time_j = time[..., None]
    # select, never multiply, across the +inf padding
    t = (time_j - t0) / torch.where(t1 == t0, 1.0, t1 - t0)
    out = a + (b - a) * t[..., None]
    if hemi_fix:                 # the quaternion lerp normalizes
        out = quat_normalize(out)
    deg = (ch.count <= 1) | (time_j >= length)
    return torch.where(deg[..., None], last, out)


def sample_clip(clip: AnimationClip, time):
    """sampleAnimation (animation.cpp:333-396) at `time` (...,). Returns
    (locals: Trs over J joints (..., J, .), root_motion: Trs (..., .))
    with the bake flags applied; unanimated rows are the identity."""
    time = torch.clamp(torch.as_tensor(time, dtype=torch.float32,
                                       device=clip.length.device),
                       0.0, clip.length)
    pos = _sample_channel(clip.pos, time, clip.length)
    rot = _sample_channel(clip.rot, time, clip.length, hemi_fix=True)
    scale = _sample_channel(clip.scale, time, clip.length)
    ident = trs_identity((), device=pos.device)
    an = clip.animated[:, None]
    pos = torch.where(an, pos, ident.pos)
    rot = torch.where(an, rot, ident.rot)
    scale = torch.where(an, scale, ident.scale)
    loc = Trs(pos=pos[..., :-1, :], rot=rot[..., :-1, :],
              scale=scale[..., :-1, :])
    root = Trs(pos=pos[..., -1, :], rot=rot[..., -1, :],
               scale=scale[..., -1, :])
    if clip.bake_root_rotation:
        r0 = Trs(pos=torch.zeros_like(root.pos), rot=root.rot,
                 scale=torch.ones_like(root.scale))
        j0 = trs_mul(r0, Trs(pos=loc.pos[..., 0, :], rot=loc.rot[..., 0, :],
                             scale=loc.scale[..., 0, :]))
        loc = Trs(pos=_set_row0(loc.pos, j0.pos),
                  rot=_set_row0(loc.rot, j0.rot),
                  scale=_set_row0(loc.scale, j0.scale))
        root = root.replace(rot=ident.rot.expand_as(root.rot))
    if clip.bake_root_xz:
        p0 = loc.pos[..., 0, :]
        p0 = torch.stack([p0[..., 0] + root.pos[..., 0], p0[..., 1],
                          p0[..., 2] + root.pos[..., 2]], -1)
        loc = loc.replace(pos=_set_row0(loc.pos, p0))
        root = root.replace(pos=root.pos * _mask3(0.0, 1.0, 0.0, root.pos))
    if clip.bake_root_y:
        p0 = loc.pos[..., 0, :]
        p0 = torch.stack([p0[..., 0], p0[..., 1] + root.pos[..., 1],
                          p0[..., 2]], -1)
        loc = loc.replace(pos=_set_row0(loc.pos, p0))
        root = root.replace(pos=root.pos * _mask3(1.0, 0.0, 1.0, root.pos))
    return loc, root


def _set_row0(x, row):
    """x (..., J, D) with joint 0 replaced by row (..., D)."""
    return torch.cat([row[..., None, :], x[..., 1:, :]], dim=-2)


def _mask3(x, y, z, like):
    return torch.tensor([x, y, z], dtype=like.dtype, device=like.device)


def blend_local(l1: Trs, l2: Trs, t) -> Trs:
    """blendLocalTransforms (animation.cpp:403-410)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=l1.pos.device)
    return trs_lerp(l1, l2, torch.clamp(t, 0.0, 1.0))


def _edge_root_transform(clip: AnimationClip, first: bool) -> Trs:
    """getFirst / LastRootTransform (animation.cpp:502-556)."""
    j = clip.pos.ts.shape[0] - 1

    def key(ch):
        i = 0 if first else torch.clamp(ch.count[j].long() - 1, min=0)
        return ch.vals[j, i]
    ident = trs_identity((), device=clip.length.device)
    animated = clip.animated[j]
    t = Trs(pos=torch.where(animated, key(clip.pos), ident.pos),
            rot=torch.where(animated, key(clip.rot), ident.rot),
            scale=torch.where(animated, key(clip.scale), ident.scale))
    if clip.bake_root_rotation:
        t = t.replace(rot=ident.rot)
    if clip.bake_root_xz:
        t = t.replace(pos=t.pos * _mask3(0.0, 1.0, 0.0, t.pos))
    if clip.bake_root_y:
        t = t.replace(pos=t.pos * _mask3(1.0, 0.0, 1.0, t.pos))
    return t


def first_root_transform(clip):
    return _edge_root_transform(clip, True)


def last_root_transform(clip):
    return _edge_root_transform(clip, False)


# -- hierarchy composition and skinning


def global_transforms(parents, local: Trs, world: Trs = None) -> Trs:
    """The parent walk of getSkinningMatricesFromLocalTransforms
    (animation.cpp:434-455). `parents`: a numpy int array (-1 = root),
    joints topologically sorted (i > parents[i]); local (..., J, .)."""
    parents = np.asarray(parents)
    if world is None:
        world = trs_identity((), device=local.pos.device)
    out = []
    for i in range(parents.shape[0]):
        li = Trs(pos=local.pos[..., i, :], rot=local.rot[..., i, :],
                 scale=local.scale[..., i, :])
        parent = world if parents[i] < 0 else out[parents[i]]
        out.append(trs_mul(parent, li))
    return Trs(pos=torch.stack([t.pos for t in out], dim=-2),
               rot=torch.stack([t.rot for t in out], dim=-2),
               scale=torch.stack([t.scale for t in out], dim=-2))


def skinning_matrices(global_t: Trs, inv_bind) -> torch.Tensor:
    """trsToMat4(global) * invBindTransform (animation.cpp:430, 452).
    inv_bind: (J, 4, 4)."""
    m = trs_to_mat4(global_t)
    inv_bind = torch.as_tensor(inv_bind, dtype=torch.float32,
                               device=m.device)
    return torch.sum(m[..., :, :, None] * inv_bind[..., None, :, :], dim=-2)


def skin_points(mats, points, joint_ids, weights):
    """Linear-blend skinning. mats (..., J, 4, 4), points (V, 3),
    joint_ids (V, W) int, weights (V, W) -> (..., V, 3)."""
    p4 = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    m = mats[..., joint_ids.long(), :, :]                # (..., V, W, 4, 4)
    skinned = torch.sum(m * p4[:, None, None, :], dim=-1)     # (..., V, W, 4)
    return torch.sum(skinned * weights[..., None], dim=-2)[..., :3]


# -- instances (time and root-motion tracking)


@dataclass
class AnimationInstance(_Struct):
    """animation_instance (animation.h:135-152), batched: time (I,)."""

    time: torch.Tensor
    last_root: Trs


def instance_init(clip: AnimationClip, start_time=0.0,
                  batch=1) -> AnimationInstance:
    """`batch` instances at `start_time` (a number or an (I,) tensor)."""
    dev = clip.length.device
    time = torch.as_tensor(start_time, dtype=torch.float32, device=dev)
    time = time.expand(batch).clone() if time.dim() == 0 else time
    first = first_root_transform(clip)
    return AnimationInstance(time=time, last_root=first.map_tensors(
        lambda x: x.expand(time.shape[0], *x.shape).clone()))


def instance_update(clip: AnimationClip, inst: AnimationInstance, dt):
    """animation_instance::update (animation.cpp:570-594): advance, wrap
    (looping) or clamp, sample, and the delta root motion
    invert(lastRootMotion) * rootMotion. Returns (inst', locals, delta)."""
    time = inst.time + dt
    wrapped = time >= clip.length
    if clip.looping:
        time = torch.where(wrapped, torch.remainder(time, clip.length), time)
        first = first_root_transform(clip)
        w = wrapped[:, None]
        last_root = Trs(pos=torch.where(w, first.pos, inst.last_root.pos),
                        rot=torch.where(w, first.rot, inst.last_root.rot),
                        scale=torch.where(w, first.scale,
                                          inst.last_root.scale))
    else:
        time = torch.minimum(time, clip.length)
        last_root = inst.last_root
    loc, root = sample_clip(clip, time)
    delta = trs_mul(trs_invert(last_root), root)
    return AnimationInstance(time=time, last_root=root), loc, delta
