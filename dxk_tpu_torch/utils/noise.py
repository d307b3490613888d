"""Perlin-style gradient noise (the reference's src/core/perlin.*, used there
for terrain): the JAX package's utils/noise.py on torch tensors.

The lattice hash wraps in 32-bit signed integers, as the JAX package's
int32 arithmetic does. Here it runs in int64 and is wrapped back to the
int32 range after every product and sum, so that no step relies on the
overflow behaviour of a device's int32 multiply.
"""

from __future__ import annotations

import torch


def _wrap32(h):
    """An int64 tensor reduced to the int32 range, two's complement."""
    return ((h + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _hash2(ix, iy, seed):
    """ix, iy: int64 lattice coordinates in the int32 range; returns the
    hash in the int32 range (as int64). >> on a negative int64 is an
    arithmetic shift, as on the JAX package's int32."""
    h = _wrap32(_wrap32(ix * 374761393) + _wrap32(iy * 668265263)
                + _wrap32(seed * 1442695041))
    h = _wrap32((h ^ (h >> 13)) * 1274126177)
    return h ^ (h >> 16)


def _gradient(ix, iy, seed):
    h = _hash2(ix, iy, seed)
    angle = (h & 0xFFFF).to(torch.float32) * (2.0 * torch.pi / 65536.0)
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def perlin(x, y, seed=0):
    """2D gradient noise in ~[-0.7, 0.7]. x, y: float32 tensors of sample
    coordinates (same shape)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    fx = x - ix.to(torch.float32)
    fy = y - iy.to(torch.float32)
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)

    def dot_grad(ox, oy):
        g = _gradient(_wrap32(ix + ox), _wrap32(iy + oy), seed)
        return g[..., 0] * (fx - ox) + g[..., 1] * (fy - oy)

    def fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    u, v = fade(fx), fade(fy)
    n00, n10 = dot_grad(0, 0), dot_grad(1, 0)
    n01, n11 = dot_grad(0, 1), dot_grad(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def fbm(x, y, octaves=4, lacunarity=2.0, gain=0.5, seed=0):
    """Fractal Brownian motion over `perlin`, terrain-style heightfields."""
    total = torch.zeros_like(x, dtype=torch.float32)
    amp = 1.0
    freq = 1.0
    for i in range(octaves):
        total = total + amp * perlin(x * freq, y * freq, seed + i)
        amp *= gain
        freq *= lacunarity
    return total


def terrain_heightfield(size=64, cell_size=1.0, height_scale=3.0,
                        feature_scale=0.08, seed=0, device="cuda"):
    """A (size, size) float32 heightfield on `device`, indexed [z, x], for
    SceneBuilder.set_heightfield (which takes it as numpy:
    `.cpu().numpy()`). `cell_size` is unused, as in the JAX package."""
    idx = torch.arange(size, dtype=torch.float32, device=device)
    xs, zs = torch.meshgrid(idx * feature_scale, idx * feature_scale,
                            indexing="xy")
    h = fbm(xs, zs, seed=seed)
    return (h - h.min()) * height_scale
