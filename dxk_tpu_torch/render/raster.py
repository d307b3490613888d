"""Debug depth / RGB ray-caster over the physics colliders, batched over
environments: the JAX package's render/raster.py (which stands in for the
reference's D3D12 renderer, render build only).

Every ray is tested against every collider with each shape's ray test
(ops/raycast.py) and the one of the collider's type is kept; the nearest
hit (the first collider on ties) is shaded by a per-body hue and a
Lambert term. The rays of all envs go through in chunks of pixels, so
that the (B, rays, C) temporaries stay within MAX_ELEMENTS.

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from dxk_tpu_torch.core.maths import (cross, dot, normalize, quat_inv_rotate,
                                      quat_rotate, sqrt)
from dxk_tpu_torch.ops import raycast as rc
from dxk_tpu_torch.ops.geometry import closest_point_point_segment
from dxk_tpu_torch.ops.shapes import world_colliders
from dxk_tpu_torch.scene.scene import (SHAPE_BOX, SHAPE_CAPSULE,
                                       SHAPE_CYLINDER, SHAPE_SPHERE)

_INF = 3.4e38
MAX_ELEMENTS = 1 << 24     # ray-collider pairs a chunk


def _linspace(start, stop, num):
    """jnp.linspace's float32 formula: start * (1 - s) + stop * s with
    s = i / (num - 1), and the last entry `stop` itself."""
    i = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    s = i / float(num - 1)
    return torch.cat([start * (1.0 - s) + stop * s, stop.reshape(1)])


def camera_rays(eye, target, up=(0.0, 1.0, 0.0), fov_deg=60.0, width=128,
                height=128, device="cuda"):
    """Pinhole camera ray grid. Returns (origin (3,), dirs (H, W, 3))."""
    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    eye, target, up = f32(eye), f32(target), f32(up)
    fwd = normalize(target - eye)
    right = normalize(cross(fwd, up))
    cam_up = cross(right, fwd)

    aspect = width / height
    tan_h = torch.tan(f32(fov_deg) * (np.pi / 180.0) * 0.5)
    ys = _linspace(tan_h, -tan_h, height)
    xs = _linspace(-tan_h * aspect, tan_h * aspect, width)
    dirs = (fwd[None, None] + xs[None, :, None] * right[None, None]
            + ys[:, None, None] * cam_up[None, None])
    return eye, dirs / sqrt(torch.sum(dirs * dirs, -1, keepdim=True))


def _hit_all_colliders(scene, w, origin, dirs):
    """Nearest hit over all colliders for the rays `dirs` (R, 3) from
    `origin` in every env of `w`. Returns (t (B, R), collider (B, R))."""
    B, C = w.a.shape[:2]
    R = dirs.shape[0]
    shape = (B, R, C, 3)
    o = origin.expand(shape)
    d = dirs[None, :, None, :].expand(shape)
    a = w.a[:, None].expand(shape)
    b = w.b[:, None].expand(shape)
    q = w.rot[:, None].expand(B, R, C, 4)

    t_sph, _ = rc.ray_sphere(o, d, a, w.r)
    t_cap, _ = rc.ray_capsule(o, d, a, b, w.r)
    t_cyl, _ = rc.ray_cylinder(o, d, a, b, w.r)
    t_box, _ = rc.ray_box(o, d, a, b, q)
    if scene.hulls is not None:
        h = scene.hulls
        hid = w.hull_id.long()
        t_hull, _ = rc.ray_hull(o, d, a, q, h.vertices[hid],
                                h.vertex_mask[hid], h.face_normals[hid],
                                h.face_offsets[hid], h.face_mask[hid])
    else:
        t_hull = torch.full_like(t_sph, _INF)

    ct = w.ctype
    t = torch.where(ct == SHAPE_SPHERE, t_sph,
        torch.where(ct == SHAPE_CAPSULE, t_cap,
        torch.where(ct == SHAPE_CYLINDER, t_cyl,
        torch.where(ct == SHAPE_BOX, t_box, t_hull))))
    t_min, ci = torch.min(t, dim=-1)
    return t_min, ci


def _surface_normal(w, ci, p):
    """Analytic outward normal of collider ci (B, R) at surface points p
    (B, R, 3). Hulls take the sphere normal, as in the JAX package."""
    def at(x):
        return torch.gather(x, 1, ci[..., None].expand(*ci.shape,
                                                       x.shape[-1]))
    a, b, q = at(w.a), at(w.b), at(w.rot)
    ctype = w.ctype[ci][..., None]

    n_sphere = normalize(p - a + 1e-9)
    n_capsule = normalize(p - closest_point_point_segment(p, a, b) + 1e-9)

    axis = normalize(b - a + 1e-9)
    s = dot(p - a, axis)[..., None]
    ln = sqrt(torch.sum((b - a) * (b - a), -1))[..., None]
    lateral = normalize(p - (a + s * axis) + 1e-9)
    n_cyl = torch.where(s < 1e-4, -axis,
                        torch.where(s > ln - 1e-4, axis, lateral))

    pl = quat_inv_rotate(q, p - a) / torch.clamp(b, min=1e-9)
    face = torch.argmax(torch.abs(pl), dim=-1, keepdim=True)
    onehot = torch.arange(3, device=p.device) == face
    n_box = quat_rotate(q, torch.sign(pl) * onehot)
    return torch.where(ctype == SHAPE_SPHERE, n_sphere,
           torch.where(ctype == SHAPE_CAPSULE, n_capsule,
           torch.where(ctype == SHAPE_CYLINDER, n_cyl,
           torch.where(ctype == SHAPE_BOX, n_box, n_sphere))))


def render(scene, state, eye, target, width=128, height=128, fov_deg=60.0,
           light_dir=(0.4, -0.8, 0.3)):
    """Render every env of `state` (B envs): RGB (B, H, W, 3) and depth
    (B, H, W) (0 where a ray hits nothing)."""
    dev = state.pos.device
    w = world_colliders(scene, state.pos, state.rot)
    origin, dirs = camera_rays(eye, target, fov_deg=fov_deg, width=width,
                               height=height, device=dev)
    light = -normalize(torch.as_tensor(np.asarray(light_dir, np.float32),
                                       device=dev))

    # per-body colour from a low-discrepancy hue sequence
    n1 = scene.num_bodies + 1
    hues = torch.remainder(torch.arange(n1 + 1, device=dev)
                           .to(torch.float32) * 0.61803398875, 1.0)
    palette = _hsv_to_rgb(hues, 0.6, 0.95)           # (n1 + 1, 3)
    sky = torch.tensor([0.05, 0.07, 0.12], dtype=torch.float32, device=dev)

    flat = dirs.reshape(-1, 3)
    B, C = w.a.shape[:2]
    per = C * (1 + (scene.hulls.face_normals.shape[1]
                    if scene.hulls is not None else 0))
    chunk = max(1, MAX_ELEMENTS // max(1, B * per))
    rgb, depth = [], []
    for lo in range(0, flat.shape[0], chunk):
        d = flat[lo:lo + chunk]
        t, ci = _hit_all_colliders(scene, w, origin, d)
        hit = t < 1e9
        p = origin + t[..., None] * d
        n = _surface_normal(w, ci, p)
        lambert = 0.25 + 0.75 * torch.clamp(dot(n, light), min=0.0)
        body = w.body.long()[ci]
        color = palette[torch.where(hit, body, n1)] * lambert[..., None]
        rgb.append(torch.where(hit[..., None], color, sky))
        depth.append(torch.where(hit, t, 0.0))
    return (torch.cat(rgb, 1).reshape(B, height, width, 3),
            torch.cat(depth, 1).reshape(B, height, width))


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    vv = torch.full_like(h, v)
    pp = torch.full_like(h, p)

    def select(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(vv, q, pp, pp, t, vv),
                        select(t, vv, vv, q, pp, pp),
                        select(pp, pp, t, vv, vv, q)], dim=-1)
