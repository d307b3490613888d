"""World-space collider flattening and AABB computation, batched over
environments: every collider of every env is transformed at once and the
right per-type formula selected by mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dxk_tpu_torch.core.maths import (quat_mul, quat_rotate, quat_to_mat3,
                                      sqrt)
from dxk_tpu_torch.scene.scene import (SHAPE_BOX, SHAPE_CAPSULE,
                                       SHAPE_CYLINDER, SHAPE_SPHERE, Scene)


@dataclass
class WorldColliders:
    """World-space collider parameters. `a`, `b`, `rot` carry the env
    batch dimension; the static per-collider fields do not. For boxes `b`
    remains the half-extents."""

    ctype: torch.Tensor        # (C,)
    a: torch.Tensor            # (B, C, 3)
    b: torch.Tensor            # (B, C, 3)
    r: torch.Tensor            # (C,)
    rot: torch.Tensor          # (B, C, 4)
    friction: torch.Tensor     # (C,)
    restitution: torch.Tensor  # (C,)
    body: torch.Tensor         # (C,)
    hull_id: torch.Tensor      # (C,)


def world_colliders(scene: Scene, pos, rot) -> WorldColliders:
    """Transform all colliders by their owning body's transform.
    pos (B, N+1, 3), rot (B, N+1, 4)."""
    c = scene.colliders
    body = c.body.long()
    bpos = pos[:, body]
    brot = rot[:, body]

    a_w = quat_rotate(brot, c.a) + bpos
    b_seg = quat_rotate(brot, c.b) + bpos      # capsule/cylinder endpoint
    rot_w = quat_mul(brot, c.rot.expand_as(brot))  # box orientation

    is_seg = (c.ctype == SHAPE_CAPSULE) | (c.ctype == SHAPE_CYLINDER)
    b_w = torch.where(is_seg[:, None], b_seg, c.b)  # boxes keep half-extents

    return WorldColliders(
        ctype=c.ctype, a=a_w, b=b_w, r=c.r, rot=rot_w,
        friction=c.friction, restitution=c.restitution,
        body=c.body, hull_id=c.hull_id)


def collider_aabbs(scene: Scene, w: WorldColliders):
    """Per-collider world AABBs. Returns (min (B, C, 3), max (B, C, 3))."""
    r = w.r[:, None]

    sph_min = w.a - r
    sph_max = w.a + r

    cap_min = torch.minimum(w.a, w.b) - r
    cap_max = torch.maximum(w.a, w.b) + r

    axis = w.b - w.a
    aa = torch.clamp(torch.sum(axis * axis, dim=-1, keepdim=True), min=1e-12)
    e = r * sqrt(torch.clamp(1.0 - axis * axis / aa, min=0.0))
    cyl_min = torch.minimum(w.a - e, w.b - e)
    cyl_max = torch.maximum(w.a + e, w.b + e)

    R = quat_to_mat3(w.rot)
    ext = torch.sum(torch.abs(R) * w.b[..., None, :], dim=-1)
    box_min = w.a - ext
    box_max = w.a + ext

    # hull: the rotated padded vertices, masked min/max
    if scene.hulls is not None:
        hid = w.hull_id.long()
        verts = scene.hulls.vertices[hid]                # (C, V, 3)
        mask = scene.hulls.vertex_mask[hid][..., None]   # (C, V, 1)
        vw = quat_rotate(w.rot[:, :, None], verts) + w.a[:, :, None]
        big = 3.4e38
        hull_min = torch.amin(torch.where(mask, vw, big), dim=2)
        hull_max = torch.amax(torch.where(mask, vw, -big), dim=2)
    else:
        hull_min, hull_max = sph_min, sph_max

    t = w.ctype[:, None]
    mn = torch.where(t == SHAPE_SPHERE, sph_min,
         torch.where(t == SHAPE_CAPSULE, cap_min,
         torch.where(t == SHAPE_CYLINDER, cyl_min,
         torch.where(t == SHAPE_BOX, box_min, hull_min))))
    mx = torch.where(t == SHAPE_SPHERE, sph_max,
         torch.where(t == SHAPE_CAPSULE, cap_max,
         torch.where(t == SHAPE_CYLINDER, cyl_max,
         torch.where(t == SHAPE_BOX, box_max, hull_max))))
    return mn, mx
