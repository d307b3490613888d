"""Inverse-trig polynomials shared by the plain joint prep and the CUDA
fused-step kernel.

The hinge and cone-twist preps compare angles against limits every step; a
different arctangent approximation (``torch.atan2``, CUDA's ``atan2f``)
moves those comparisons and breaks step parity with the JAX package. Both
the plain torch code and ``csrc/fused_step.cu`` therefore evaluate the same
Cephes atanf minimax polynomial, coefficient for coefficient and in the
same operation order, as the JAX package's ``core/fastmath.py``.
"""

from __future__ import annotations

import torch

from dxk_tpu_torch.core.maths import sqrt

_PI = 3.14159265358979323846
_PI_2 = _PI / 2
_PI_4 = _PI / 4
_TAN_PI_8 = 0.4142135623730950


def _atan_01(t):
    """atan on [0, 1]: one Cephes range split at tan(pi/8), branchless."""
    hi = t > _TAN_PI_8
    tr = torch.where(hi, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * tr + tr
    return torch.where(hi, _PI_4 + p, p)


def atan2(y, x):
    """Four-quadrant arctangent, atan2(0, 0) = 0."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    t = torch.minimum(ax, ay) / torch.where(mx > 0.0, mx, 1.0)
    r = _atan_01(t)
    r = torch.where(ay > ax, _PI_2 - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


def acos(x):
    """arccos via atan2(sqrt((1-x)(1+x)), x) — well-conditioned at +-1."""
    xc = torch.clamp(x, -1.0, 1.0)
    s = sqrt(torch.clamp((1.0 - xc) * (1.0 + xc), min=0.0))
    return atan2(s, xc)


def asin(x):
    xc = torch.clamp(x, -1.0, 1.0)
    s = sqrt(torch.clamp((1.0 - xc) * (1.0 + xc), min=0.0))
    return atan2(xc, s)
