"""Port parity, modules core/maths.py and core/fastmath.py: the same numpy
inputs go through the JAX functions and their PyTorch counterparts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.core import fastmath as jfm
from dxk_tpu.core import maths as jm
from dxk_tpu_torch.core import fastmath as tfm
from dxk_tpu_torch.core import maths as tm

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

N = 4096


def _rng():
    return np.random.default_rng(7)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ulps(a, b):
    """Distance in float32 units in the last place."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


class TestFastmath:
    # Same polynomial, same operation order, float32 throughout. XLA:CPU
    # may contract a*b+c into a fused multiply-add where PyTorch rounds
    # twice, so the results are held to 1 ulp of the output magnitude
    # (absolute 1.2e-7 * max(|value|, 1)), not to bit equality.
    def _close(self, got, want):
        tol = 1.2e-7 * np.maximum(np.abs(want), 1.0) * 2.0
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()

    def test_atan2(self):
        rng = _rng()
        y = rng.uniform(-3, 3, N).astype(np.float32)
        x = rng.uniform(-3, 3, N).astype(np.float32)
        # axes, origin, equal magnitudes and the range split at tan(pi/8)
        y[:8] = [0, 0, 1, -1, 0, 1, -1, 0.41421357]
        x[:8] = [1, -1, 0, 0, 0, 1, -1, 1.0]
        got = tfm.atan2(_t(y), _t(x)).numpy()
        want = np.asarray(jfm.atan2(jnp.asarray(y), jnp.asarray(x)))
        self._close(got, want)
        assert np.abs(got - np.arctan2(y, x)).max() < 1e-6

    @pytest.mark.parametrize("name", ["acos", "asin"])
    def test_inverse_trig(self, name):
        rng = _rng()
        x = rng.uniform(-1.1, 1.1, N).astype(np.float32)
        x[:5] = [-1, 1, 0, 0.99999994, -0.99999994]
        got = getattr(tfm, name)(_t(x)).numpy()
        want = np.asarray(getattr(jfm, name)(jnp.asarray(x)))
        self._close(got, want)


# quaternion / vector helpers: same operation order, ≤1e-6 absolute on
# unit-scale inputs (differences are fused-multiply-add contraction only)
TOL = 1e-6


def _cmp(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate",
                                  "quat_inv_rotate", "cross"])
def test_binary_ops(name):
    rng = _rng()
    q = _quats(rng, N)
    p = _quats(rng, N)
    v = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    u = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    a, b = {"quat_mul": (q, p), "cross": (v, u)}.get(name, (q, v))
    _cmp(getattr(tm, name)(_t(a), _t(b)),
         getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)), 4e-6)


@pytest.mark.parametrize("name", ["quat_conj", "quat_normalize",
                                  "quat_to_mat3"])
def test_quat_unary(name):
    q = _quats(_rng(), N) * np.float32(1.7)
    _cmp(getattr(tm, name)(_t(q)), getattr(jm, name)(jnp.asarray(q)))


def test_mat3_T():
    m = _rng().normal(size=(N, 3, 3)).astype(np.float32)
    _cmp(tm.mat3_T(_t(m)), jm.mat3_T(jnp.asarray(m)), 0.0)


def test_noz_and_get_tangent():
    rng = _rng()
    v = rng.normal(size=(N, 3)).astype(np.float32)
    v[:4] = [[0, 0, 0], [1e-7, 0, 0], [0.57735, 0.57735, 0.57735],
             [0.5773, 0.6, 0.55]]
    _cmp(tm.noz(_t(v)), jm.noz(jnp.asarray(v)))
    n = v[2:] / np.linalg.norm(v[2:], axis=-1, keepdims=True)
    n = n.astype(np.float32)
    _cmp(tm.get_tangent(_t(n)), jm.get_tangent(jnp.asarray(n)))


def test_rotate_from_to_and_axis_rotation():
    rng = _rng()
    f = rng.normal(size=(N, 3)).astype(np.float32)
    t = rng.normal(size=(N, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t[:3] = f[:3]             # identical
    t[3:6] = -f[3:6]          # antiparallel
    f[6], t[6] = [1, 0, 0], [-1, 0, 0]
    q_t = tm.rotate_from_to(_t(f), _t(t))
    q_j = jm.rotate_from_to(jnp.asarray(f), jnp.asarray(t))
    _cmp(q_t, q_j, 2e-6)
    ax_t, an_t = tm.get_axis_rotation(q_t)
    ax_j, an_j = jm.get_axis_rotation(jnp.asarray(q_t.numpy()))
    # the angle goes through arccos near w = +-1, where one ulp of w moves
    # the angle by ~3e-4; compare where the function is well conditioned
    ok = np.abs(q_t.numpy()[:, 3]) < 0.999
    assert np.abs(an_t.numpy() - np.asarray(an_j))[ok].max() < 1e-5
    assert np.abs(ax_t.numpy() - np.asarray(ax_j))[ok].max() < 1e-5


# -- the remaining helpers: the same numpy inputs through both packages


@pytest.mark.parametrize("name", ["clamp", "clamp01", "deg2rad", "quat_v",
                                  "quat_w", "angle_to_npi_pi"])
def test_elementwise_helpers(name):
    """Exact (0.0): one rounding each, in the same order. The angles
    reach +-20 rad, past several wraps, and hit the wrap points."""
    rng = _rng()
    x = rng.uniform(-20, 20, (N, 4)).astype(np.float32)
    x[0, :3] = [np.pi, -np.pi, 3 * np.pi]
    args = {"clamp": lambda a: (a, -0.5, 1.5)}.get(name, lambda a: (a,))
    _cmp(getattr(tm, name)(*args(_t(x))),
         getattr(jm, name)(*args(jnp.asarray(x))), 0.0)
    if name == "deg2rad":
        # a Python number: float32 in both
        assert tm.deg2rad(60.0).dtype == torch.float32
        _cmp(tm.deg2rad(60.0), jm.deg2rad(60.0), 0.0)


def test_quat_identity_and_outer():
    """Exact: constants and single products."""
    _cmp(tm.quat_identity((3, 2), device="cpu"), jm.quat_identity((3, 2)),
         0.0)
    rng = _rng()
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    _cmp(tm.outer(_t(a), _t(b)), jm.outer(jnp.asarray(a), jnp.asarray(b)),
         0.0)


def test_mat3_products_and_inverse():
    """Products: 3-term sums, 1e-6 of unit-scale entries (XLA:CPU's dot
    may contract multiply-adds). Inverse: the port's adjugate against
    jnp.linalg.inv's LU on matrices with condition number below ~50,
    within 1e-5 of max(1, the largest entry)."""
    rng = _rng()
    m = rng.normal(size=(N, 3, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3, 3)).astype(np.float32)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    _cmp(tm.mat3_mul(_t(m), _t(n)), jm.mat3_mul(jnp.asarray(m),
                                                jnp.asarray(n)), 4e-6)
    _cmp(tm.mat3_vec(_t(m), _t(v)), jm.mat3_vec(jnp.asarray(m),
                                                jnp.asarray(v)), 4e-6)
    ok = np.linalg.cond(m.astype(np.float64)) < 50.0
    got = tm.mat3_inverse(_t(m[ok])).numpy()
    want = np.asarray(jm.mat3_inverse(jnp.asarray(m[ok])))
    scale = np.maximum(1.0, np.abs(want).max(axis=(1, 2)))
    assert (np.abs(got - want).max(axis=(1, 2)) / scale).max() <= 1e-5


def test_transforms_and_twist_swing():
    """Rotations as quat_rotate's: 4e-6 absolute on unit-scale inputs
    (test_binary_ops' bound)."""
    rng = _rng()
    q = _quats(rng, N)
    pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    for name in ("transform_position", "inverse_transform_position"):
        _cmp(getattr(tm, name)(_t(pos), _t(q), _t(p)),
             getattr(jm, name)(jnp.asarray(pos), jnp.asarray(q),
                               jnp.asarray(p)), 4e-6)
    for name in ("transform_direction", "inverse_transform_direction"):
        _cmp(getattr(tm, name)(_t(q), _t(p)),
             getattr(jm, name)(jnp.asarray(q), jnp.asarray(p)), 4e-6)
    axis = rng.normal(size=(N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    tw, sw = tm.twist_swing_decompose(_t(q), _t(axis))
    jtw, jsw = jm.twist_swing_decompose(jnp.asarray(q), jnp.asarray(axis))
    # away from a twist of zero length (the vector part normal to the
    # axis and w ~ 0), where the normalize divides by ~0
    ok = np.linalg.norm(np.asarray(jtw), axis=-1) > 0.5
    ok &= np.abs((q[:, :3] * axis).sum(-1)) + np.abs(q[:, 3]) > 1e-2
    assert np.abs(tw.numpy() - np.asarray(jtw))[ok].max() <= 4e-6
    assert np.abs(sw.numpy() - np.asarray(jsw))[ok].max() <= 4e-6


@pytest.mark.parametrize("case", ["sentinel", "full", "vector"])
def test_evaluate_spline(case):
    """The smoke pool's spline (knots [0, 1] then the -1 sentinel), a full
    8-knot spline and (N, 2) values, at t across and outside the knots
    and on the knots: within 1e-6 (the same polynomial in the same
    order; the JAX package picks the controls by one-hot sums, exact)."""
    rng = _rng()
    if case == "sentinel":
        ts = np.array([0.0, 1.0] + [-1.0] * 6, np.float32)
        vals = np.array([1.0, 0.4] + [0.0] * 6, np.float32)
    else:
        ts = np.sort(rng.uniform(0, 4, 8)).astype(np.float32)
        ts[0] = 0.0
        vals = rng.normal(size=(8,) if case == "full" else (8, 2)) \
            .astype(np.float32)
    t = rng.uniform(-0.5, float(ts.max()) + 0.5, 1000).astype(np.float32)
    t[:8] = np.where(ts >= 0, ts, 0.5)
    got = tm.evaluate_spline(_t(ts), _t(vals), _t(t))
    want = jm.evaluate_spline(jnp.asarray(ts), jnp.asarray(vals),
                              jnp.asarray(t))
    _cmp(got, want, 1e-6)
