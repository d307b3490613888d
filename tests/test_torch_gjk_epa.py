"""Port parity, modules ops/gjk.py, ops/epa.py and
ops/narrowphase._gjk_epa_point: the JAX package's tests/test_gjk_epa.py
cases through both packages, seeded pair soups against the JAX functions
compiled under vmap, and the port's GJK+EPA against the port's analytic
cylinder-box and cylinder-cylinder recipes on the JAX test's soups.

The JAX package and the port run the same float32 operations in the same
order, so hit flags are held equal and the simplex, point, normal and
depth within TOL. 0.0 is seen under tests/conftest.py's XLA flags (the
fusion pass off); with XLA:CPU's fusion on, a compiled JAX GJK contracts
multiply-adds and parts from the port (and from the JAX package op by
op) on about one box-box pair in 200. The analytic comparisons keep the
JAX test's own bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.ops import epa as jepa
from dxk_tpu.ops import gjk as jgjk
from dxk_tpu.ops import narrowphase as jnp_aos
from dxk_tpu_torch.ops import epa as tepa
from dxk_tpu_torch.ops import gjk as tgjk
from dxk_tpu_torch.ops import narrowphase as tnp

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

TOL = 1e-5
IDQ = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
SUPPORTS = {"sphere": "support_sphere", "capsule": "support_capsule",
            "cylinder": "support_cylinder", "box": "support_box",
            "hull": "support_hull"}


def _t(params):
    return tuple(torch.from_numpy(np.array(p)) for p in params)


def _jax(kind_a, kind_b, pa, pb, epa_iters=20):
    """The JAX GJK + EPA of every pair, compiled under vmap."""
    sa, sb = (getattr(jgjk, SUPPORTS[k]) for k in (kind_a, kind_b))

    def one(pa, pb):
        hit, s = jgjk.gjk_intersection(sa, sb, pa, pb)
        p, n, d = jepa.epa(sa, sb, pa, pb, s, max_iterations=epa_iters)
        return hit, s, p, n, d
    out = jax.jit(jax.vmap(one))(tuple(jnp.asarray(x) for x in pa),
                                 tuple(jnp.asarray(x) for x in pb))
    return [np.asarray(x) for x in out]


def _port(kind_a, kind_b, pa, pb, epa_iters=20):
    sa, sb = (getattr(tgjk, SUPPORTS[k]) for k in (kind_a, kind_b))
    hit, s = tgjk.gjk_intersection(sa, sb, _t(pa), _t(pb))
    p, n, d = tepa.epa(sa, sb, _t(pa), _t(pb), s, max_iterations=epa_iters)
    return [x.numpy() for x in (hit, s, p, n, d)]


def _hold(got, want):
    hit, s, p, n, d = got
    jhit, js, jp, jn, jd = want
    assert np.array_equal(hit, jhit)
    assert np.abs(s - js)[jhit].max(initial=0.0) <= TOL
    for a, b in ((p, jp), (n, jn), (d, jd)):
        assert np.abs(a - b)[jhit].max(initial=0.0) <= TOL


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _shape(kind, rng, n, centre):
    if kind == "sphere":
        return (centre, rng.uniform(0.2, 1.0, n).astype(np.float32))
    if kind in ("capsule", "cylinder"):
        axis = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
        return (centre - axis, centre + axis,
                rng.uniform(0.1, 0.5, n).astype(np.float32))
    if kind == "box":
        return (centre, rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32),
                _quats(rng, n))
    verts = rng.normal(size=(n, 12, 3)).astype(np.float32) * 0.6
    mask = np.ones((n, 12), bool)
    mask[:, 10:] = False                         # padded slots
    return (centre, _quats(rng, n), verts, mask)


PAIRS = [("sphere", "sphere"), ("box", "box"), ("capsule", "box"),
         ("sphere", "box"), ("cylinder", "box"), ("cylinder", "cylinder"),
         ("capsule", "hull"), ("hull", "hull")]


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_soup_matches_jax(pair):
    """96 seeded pairs of each pairing at centre distances that give hits
    and misses."""
    rng = np.random.default_rng(100 + PAIRS.index(pair))
    n = 96
    ca = rng.normal(size=(n, 3)).astype(np.float32)
    cb = (ca + rng.normal(size=(n, 3)) * 0.9).astype(np.float32)
    pa, pb = _shape(pair[0], rng, n, ca), _shape(pair[1], rng, n, cb)
    want = _jax(*pair, pa, pb)
    _hold(_port(*pair, pa, pb), want)
    assert 0 < want[0].sum() < n


def test_support_functions():
    """Each support function at seeded directions, and the extruded
    triangle's: exact but for quat_rotate's rounding (1e-6)."""
    rng = np.random.default_rng(1)
    n = 512
    d = rng.normal(size=(n, 3)).astype(np.float32)
    c = rng.normal(size=(n, 3)).astype(np.float32)
    for kind, name in SUPPORTS.items():
        p = _shape(kind, rng, n, c)
        want = jax.vmap(getattr(jgjk, name))(
            tuple(jnp.asarray(x) for x in p), jnp.asarray(d))
        got = getattr(tgjk, name)(_t(p), torch.from_numpy(d))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6, kind
    tri = rng.normal(size=(n, 6, 3)).astype(np.float32)
    want = jax.vmap(jgjk.support_extruded_triangle)(jnp.asarray(tri),
                                                    jnp.asarray(d))
    got = tgjk.support_extruded_triangle(torch.from_numpy(tri),
                                         torch.from_numpy(d))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _one(*xs):
    return tuple(np.asarray(x, np.float32)[None] for x in xs)


def test_jax_test_cases():
    """tests/test_gjk_epa.py's TestGJK and TestEPA cases through the
    port, with the JAX test's own bounds, and held against JAX."""
    sph = lambda c, r: _one(c, r)                        # noqa: E731
    box = lambda c, h: _one(c, h, IDQ)                   # noqa: E731
    cap = lambda a, b, r: _one(a, b, r)                  # noqa: E731
    a = sph([0, 0, 0], 1.0)
    assert _port("sphere", "sphere", a, sph([1.5, 0, 0], 1.0))[0][0]
    assert not _port("sphere", "sphere", a, sph([2.5, 0, 0], 1.0))[0][0]
    ba = box([0, 0, 0], [1, 1, 1])
    assert _port("box", "box", ba, box([1.5, 0, 0], [1, 1, 1]))[0][0]
    assert not _port("box", "box", ba, box([2.5, 0.1, 0], [1, 1, 1]))[0][0]
    assert _port("capsule", "box", cap([0, 1.2, -0.5], [0, 1.2, 0.5], 0.3),
                 ba)[0][0]
    assert not _port("capsule", "box", cap([0, 1.5, -0.5], [0, 1.5, 0.5],
                                           0.3), ba)[0][0]
    cases = [
        ("sphere", "sphere", a, sph([1.5, 0, 0], 1.0), 0.5, 0, 0.05),
        ("box", "box", ba, box([1.7, 0, 0], [1, 1, 1]), 0.3, 0, 0.02),
        ("capsule", "box", cap([-0.5, 1.2, 0], [0.5, 1.2, 0], 0.3), ba, 0.1,
         1, 0.02),
        ("sphere", "box", sph([0, 0.8, 0], 0.1), ba, 0.3, 1, 0.05)]
    for ka, kb, pa, pb, depth, axis, tol in cases:
        got = _port(ka, kb, pa, pb)
        _hold(got, _jax(ka, kb, pa, pb))
        hit, _s, p, n, d = got
        assert hit[0] and abs(float(d[0]) - depth) < tol
        assert abs(float(n[0, axis])) > 0.95
    # the capsule lying on the box: the normal from the capsule to the box
    assert float(_port(*cases[2][:4])[3][0, 1]) < -0.98


def _soup(seed, pairs):
    """The JAX test's cylinder soups (jax.random, as numpy)."""
    key = jax.random.PRNGKey(seed)
    N = 256
    ks = jax.random.split(key, 8)
    u = lambda k, s, lo, hi: jax.random.uniform(k, s, jnp.float32, lo, hi)  # noqa: E731,E501
    aa = u(ks[0], (N, 3), -1.5 if pairs == "box" else -1.0,
           1.5 if pairs == "box" else 1.0)
    ab = aa + u(ks[1], (N, 3), -1.5, 1.5)
    ar = u(ks[2], (N,), 0.1, 0.5)
    if pairs == "box":
        bh = u(ks[3], (N, 3), 0.3, 1.0)
        aa = aa.at[:64, 0].set(u(ks[4], (64,), -0.5, 0.5))
        aa = aa.at[:64, 2].set(u(ks[5], (64,), -0.5, 0.5))
        aa = aa.at[:64, 1].set(u(ks[6], (64,), 0.2, 1.2))
        ab = ab.at[:64].set(aa[:64] + jnp.array([0.0, 1.0, 0.0]))
        return [np.asarray(x) for x in (aa, ab, ar, bh)]
    ba = u(ks[3], (N, 3), -1.0, 1.0)
    bb = ba + u(ks[4], (N, 3), -1.5, 1.5)
    br = u(ks[5], (N,), 0.1, 0.5)
    return [np.asarray(x) for x in (aa, ab, ar, ba, bb, br)]


def _hold_analytic(hit, rhit, nrm, rn, dps, rd, valid):
    """The JAX test's bounds (tests/test_gjk_epa.py:113-216)."""
    assert ((hit == rhit) | ~valid).mean() >= 0.995
    both = hit & rhit & valid & (rd < 0.3)
    nd = (nrm * rn).sum(-1)
    dd = np.abs(dps[:, 0] - rd)
    ok = (nd > 0.9) | (dd < 0.01)
    assert ok[both].mean() > 0.9
    assert np.percentile(dd[both], 90) < 0.05
    assert dd[both].max() < 0.15


def test_cylinder_box_analytic_vs_epa():
    aa, ab, ar, bh = _soup(0, "box")
    N = aa.shape[0]
    bc = np.zeros((N, 3), np.float32)
    idq = np.tile(IDQ, (N, 1))
    hit, s = tgjk.gjk_intersection(tgjk.support_cylinder, tgjk.support_box,
                                   _t((aa, ab, ar)), _t((bc, bh, idq)))
    _p, rn, rd = tepa.epa(tgjk.support_cylinder, tgjk.support_box,
                          _t((aa, ab, ar)), _t((bc, bh, idq)), s,
                          max_iterations=24)
    _pts, dps, nrm, _cnt, ahit = tnp.cylinder_box_contact(
        *_t((aa, ab, ar, bc, bh, idq)))
    _hold_analytic(ahit.numpy(), hit.numpy(), nrm.numpy(), rn.numpy(),
                   dps.numpy(), rd.numpy(), np.ones(N, bool))
    # and a slice of the soup against the JAX GJK+EPA
    sl = slice(0, 48)
    _hold(_port("cylinder", "box", (aa[sl], ab[sl], ar[sl]),
                (bc[sl], bh[sl], idq[sl]), 24),
          _jax("cylinder", "box", (aa[sl], ab[sl], ar[sl]),
               (bc[sl], bh[sl], idq[sl]), 24))


def test_cylinder_cylinder_analytic_vs_epa():
    aa, ab, ar, ba, bb, br = _soup(1, "cylinder")
    A, B = _t((aa, ab, ar)), _t((ba, bb, br))
    hit, s = tgjk.gjk_intersection(tgjk.support_cylinder,
                                   tgjk.support_cylinder, A, B)
    _p, rn, rd = tepa.epa(tgjk.support_cylinder, tgjk.support_cylinder, A,
                          B, s, max_iterations=24)
    _pts, dps, nrm, _cnt, ahit = tnp.cylinder_cylinder_contact(
        *_t((aa, ab, ar, ba, bb, br)))
    u_a = (ab - aa) / np.linalg.norm(ab - aa, axis=-1, keepdims=True)
    u_b = (bb - ba) / np.linalg.norm(bb - ba, axis=-1, keepdims=True)
    nonpar = np.abs((u_a * u_b).sum(-1)) <= 0.99
    _hold_analytic(ahit.numpy(), hit.numpy(), nrm.numpy(), rn.numpy(),
                   dps.numpy(), rd.numpy(), nonpar)


def test_gjk_epa_point():
    """The one-contact manifold of sphere-box pairs against the JAX
    package's _gjk_epa_point, compiled under vmap."""
    rng = np.random.default_rng(4)
    n = 64
    c = rng.normal(size=(n, 3)).astype(np.float32)
    sp = _shape("sphere", rng, n, c + rng.normal(size=(n, 3)).astype(
        np.float32) * 0.6)
    bx = _shape("box", rng, n, c)
    want = jax.jit(jax.vmap(lambda a, b: jnp_aos._gjk_epa_point(
        jgjk.support_sphere, jgjk.support_box, a, b)))(
        tuple(jnp.asarray(x) for x in sp), tuple(jnp.asarray(x) for x in bx))
    got = tnp._gjk_epa_point(tgjk.support_sphere, tgjk.support_box, _t(sp),
                             _t(bx))
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert np.abs(g.numpy().astype(np.float64)
                      - np.asarray(w).astype(np.float64)).max() <= TOL
    assert 0 < int(got[4].sum()) < n
