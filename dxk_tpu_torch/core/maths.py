"""Batched vector / quaternion / matrix math for the physics core.

Same semantics and operation order as the JAX package's ``core/maths.py``
(which follows the reference engine's math.h / math.cpp), on torch tensors
with arbitrary leading batch dimensions:

  - vectors: (..., 3) float32
  - quaternions: (..., 4) float32, layout (x, y, z, w)
  - 3x3 matrices: (..., 3, 3) float32, row-major
"""

from __future__ import annotations

import torch

_CONSTS = {}


def const(values, like):
    """A small constant tensor with the dtype and device of `like`, made
    once per (values, dtype, device): building it anew on the card would
    copy it from the host and wait for the device on every call."""
    key = (tuple(values), like.dtype, like.device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=like.dtype,
                                    device=like.device)
    return _CONSTS[key]


def sqrt(x):
    """Square root, rounded correctly in float32 on every device. PyTorch's
    float32 sqrt on the CPU is one ulp off on a small share of inputs (about
    0.7 % on an AVX-512 build), where the card's sqrt, the CUDA kernels' and
    the JAX package's round correctly; a float64 root rounded once to
    float32 is the correctly rounded float32 root. A one-ulp difference can
    tip a branch of a contact recipe, so the plain versions use this."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Component cross product (broadcasts, unlike torch.linalg.cross on
    mismatched batch shapes)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return sqrt(torch.sum(v * v, dim=-1))


def squared_length(v):
    return torch.sum(v * v, dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def normalize(v):
    """Plain normalize; caller guarantees nonzero length."""
    return v / length(v)[..., None]


def noz(v):
    """Normalize-or-zero: returns 0 for ~zero input."""
    sq = squared_length(v)
    ok = sq > 1e-12
    safe = torch.where(ok, sq, 1.0)
    return torch.where(ok[..., None], v * sqrt(1.0 / safe)[..., None],
                       0.0)


def quat(v3, w):
    """Assemble a quaternion from vector part and scalar part."""
    return torch.cat([v3, w[..., None]], dim=-1)


def quat_mul(a, b):
    """Hamilton product: w = aw*bw - av.bv ; v = av*bw + bv*aw + av x bv."""
    av, aw = a[..., :3], a[..., 3:4]
    bv, bw = b[..., :3], b[..., 3:4]
    w = aw[..., 0] * bw[..., 0] - dot(av, bv)
    v = av * bw + bv * aw + cross(av, bv)
    return quat(v, w)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    return q / sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_rotate(q, v):
    """v' = v + 2*(w*(u x v) + u x (u x v)), u = q.xyz."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_inv_rotate(q, v):
    """Rotate by the conjugate (inverse for unit quats)."""
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, angle):
    """axis assumed normalized; q = (axis*sin(a/2), cos(a/2))."""
    half = angle * 0.5
    return quat(axis * torch.sin(half)[..., None], torch.cos(half))


def quat_to_mat3(q):
    """Rotation matrix from a unit quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*m.shape[:-1], 3, 3)


def mat3_T(m):
    return m.transpose(-1, -2)


def rotate_from_to(_from, _to):
    """Shortest-arc rotation between two vectors, branchless over the
    three cases (identity / antiparallel / general)."""
    f = normalize(_from)
    t = normalize(_to)
    d = dot(f, t)

    s = sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-30))
    invs = 1.0 / s
    c = cross(f, t)
    q_general = quat_normalize(quat(c * invs[..., None], s * 0.5))

    ax1 = cross(const((1.0, 0.0, 0.0), f), f)
    ax2 = cross(const((0.0, 1.0, 0.0), f), f)
    use2 = (squared_length(ax1) < 1e-12)[..., None]
    axis = normalize(torch.where(use2, ax2, ax1) + 1e-30)
    q_pi = quat(axis, torch.zeros_like(d))

    anti = (d < (1e-6 - 1.0))[..., None]
    q = torch.where(anti, q_pi, q_general)
    ident = const((0.0, 0.0, 0.0, 1.0), q).expand(q.shape)
    return torch.where((d >= 1.0)[..., None], ident, q)


def get_axis_rotation(q):
    """Axis + angle of a quaternion; angle is 2*acos(w) in [0, 2*pi]."""
    v = q[..., :3]
    sq = squared_length(v)
    ok = sq > 0.0
    angle = torch.where(ok, 2.0 * torch.acos(torch.clamp(q[..., 3], -1.0,
                                                         1.0)), 0.0)
    inv_len = torch.where(ok, 1.0 / sqrt(torch.where(ok, sq, 1.0)),
                          0.0)
    axis = torch.where(ok[..., None], v * inv_len[..., None],
                       const((1.0, 0.0, 0.0), q))
    return axis, angle


def get_tangent(normal):
    """Branch on |n.x| >= 0.57735, then normalize."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = (torch.abs(nx) >= 0.57735)[..., None]
    zero = torch.zeros_like(nx)
    t = torch.where(use_x,
                    torch.stack([ny, -nx, zero], dim=-1),
                    torch.stack([zero, nz, -ny], dim=-1))
    return normalize(t)


def get_tangents(normal):
    """tangent = get_tangent(n); bitangent = n x tangent."""
    t = get_tangent(normal)
    return t, cross(normal, t)


def solve_2x2(A, b):
    """Solve A x = b for (..., 2, 2) A by the explicit inverse (zero where
    the determinant is zero)."""
    a11, a12 = A[..., 0, 0], A[..., 0, 1]
    a21, a22 = A[..., 1, 0], A[..., 1, 1]
    det = a11 * a22 - a12 * a21
    ok = det != 0.0
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    x = inv_det * (a22 * b[..., 0] - a12 * b[..., 1])
    y = inv_det * (a11 * b[..., 1] - a21 * b[..., 0])
    return torch.stack([x, y], dim=-1)


def solve_3x3(A, b):
    """Solve A x = b for (..., 3, 3) A by Cramer's rule on its columns
    (zero where the determinant is zero)."""
    ex = A[..., :, 0]
    ey = A[..., :, 1]
    ez = A[..., :, 2]
    eyz = cross(ey, ez)
    det = dot(ex, eyz)
    ok = det != 0.0
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    x = inv_det * dot(b, eyz)
    y = inv_det * dot(ex, cross(b, ez))
    z = inv_det * dot(ex, cross(ey, b))
    return torch.stack([x, y, z], dim=-1)


def skew(r):
    """Cross-product matrix [r]x, (..., 3, 3)."""
    zero = torch.zeros_like(r[..., 0])
    m = torch.stack([zero, -r[..., 2], r[..., 1],
                     r[..., 2], zero, -r[..., 0],
                     -r[..., 1], r[..., 0], zero], dim=-1)
    return m.reshape(*m.shape[:-1], 3, 3)
