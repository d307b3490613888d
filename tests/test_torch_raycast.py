"""Port parity, module ops/raycast.py (the convex-hull ray test and the
picking extras) and physics.apply_ray_impulse on a scene with hulls.

- ray_hull on the octahedron of tests/test_hull.py::test_ray_hull_exact;
- ray_hull (face-slab test and AABB fallback), ray_plane, ray_disk,
  ray_rect, ray_triangle and ray_torus on seeded rays against the JAX
  functions run eagerly under vmap: hits equal, t within 1e-5 (the torus:
  1e-4, a 96-step sphere trace);
- apply_ray_impulse on BASELINE config 3's scene (the ragdoll beside its
  hull debris, chip_smoke.settle_builder) against the JAX function under
  vmap, on seeded rays of which a quarter hit the hull first: the same
  poked body, accumulators within 1e-3 of a 1000 N poke.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.ops import raycast as jrc
from dxk_tpu.physics import apply_ray_impulse as jax_apply_ray_impulse
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.models.ragdoll import add_ragdoll
from dxk_tpu_torch.ops import raycast as trc
from dxk_tpu_torch.physics import apply_ray_impulse
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import state_from_numpy

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

T_TOL = 1e-5
TORUS_TOL = 1e-4
POKE_TOL = 1e-3
OCTA = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                 [0, 0, 1], [0, 0, -1]], np.float64) * 0.5


def _octa_hulls():
    b = SceneBuilder()
    hid = b.add_hull_geometry_from_mesh(OCTA)
    b.add_hull_collider(b.add_body(), hid)
    return b.finalize(device="cpu").hulls


def test_ray_hull_exact():
    """Mirror of tests/test_hull.py::test_ray_hull_exact: the octahedron
    |x|+|y|+|z| <= 0.5 is hit at its vertex x = 0.5 (t = 1.5), and a ray
    past its corner that would hit its AABB misses."""
    h = _octa_hulls()
    idq = torch.tensor([0.0, 0, 0, 1.0])
    tabs = (h.vertices[0], h.vertex_mask[0], h.face_normals[0],
            h.face_offsets[0], h.face_mask[0])
    d = torch.tensor([-1.0, 0.0, 0.0])
    t, hit = trc.ray_hull(torch.tensor([2.0, 0.0, 0.0]), d, torch.zeros(3),
                          idq, *tabs)
    assert bool(hit) and abs(float(t) - 1.5) < 1e-4
    _t2, hit2 = trc.ray_hull(torch.tensor([2.0, 0.4, 0.4]), d,
                             torch.zeros(3), idq, *tabs)
    assert not bool(hit2)
    # the AABB fallback (no face planes) hits that ray
    _t3, hit3 = trc.ray_hull(torch.tensor([2.0, 0.4, 0.4]), d,
                             torch.zeros(3), idq, *tabs[:2])
    assert bool(hit3)


def _rays(rng, n, spread=2.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    o[:, 1] += 3.0
    # aim at seeded points near the origin so that about half hit
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = tgt - o + rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _case(name, rng, n):
    """Seeded per-ray arguments of ray_<name> after (o, d), numpy."""
    if name in ("hull", "hull_aabb"):
        h = _octa_hulls()
        pos = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
        q = rng.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        tabs = [np.repeat(x.numpy()[None], n, 0) for x in (
            h.vertices[0], h.vertex_mask[0], h.face_normals[0],
            h.face_offsets[0], h.face_mask[0])]
        return [pos, q] + (tabs if name == "hull" else tabs[:2])
    if name == "plane":
        return [_unit(rng, n), rng.uniform(-0.5, 0.5, (n, 3)).astype(
            np.float32)]
    if name == "disk":
        return [rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
                _unit(rng, n), rng.uniform(0.2, 1.0, n).astype(np.float32)]
    if name == "rect":
        t = _unit(rng, n)
        bt = np.cross(t, _unit(rng, n))
        bt /= np.linalg.norm(bt, axis=-1, keepdims=True)
        return [rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32), t,
                bt.astype(np.float32),
                rng.uniform(0.2, 1.0, (n, 2)).astype(np.float32)]
    if name == "triangle":
        return [rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
                for _ in range(3)]
    if name == "torus":
        return [rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                _unit(rng, n), rng.uniform(0.4, 0.8, n).astype(np.float32),
                rng.uniform(0.1, 0.3, n).astype(np.float32)]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["hull", "hull_aabb", "plane", "disk",
                                  "rect", "triangle", "torus"])
def test_ray_functions_match_jax(name):
    """Each new ray function on 512 seeded rays against the JAX function
    run eagerly under vmap: the same hits (and front faces), the miss value
    exactly, t within 1e-5 (the torus' 96-step sphere trace within 1e-4)."""
    rng = np.random.default_rng(["hull", "hull_aabb", "plane", "disk", "rect",
                                 "triangle", "torus"].index(name) + 40)
    n = 512
    o, d = _rays(rng, n)
    extra = _case(name, rng, n)
    fn = "hull" if name == "hull_aabb" else name
    jout = jax.vmap(getattr(jrc, f"ray_{fn}"))(
        jnp.asarray(o), jnp.asarray(d), *[jnp.asarray(x) for x in extra])
    tout = getattr(trc, f"ray_{fn}")(
        torch.from_numpy(o), torch.from_numpy(d),
        *[torch.from_numpy(x) for x in extra])
    jt, hit = np.asarray(jout[0]), np.asarray(jout[1])
    tt = tout[0].numpy()
    assert np.array_equal(hit, tout[1].numpy())
    assert hit.any() and not hit.all(), hit.mean()
    if name == "triangle":
        assert np.array_equal(np.asarray(jout[2]), tout[2].numpy())
    assert np.array_equal(jt[~hit], tt[~hit])
    tol = TORUS_TOL if name == "torus" else T_TOL
    assert np.abs(jt[hit] - tt[hit]).max() <= tol


def _settle_scenes():
    return (chip_smoke.settle_builder(JaxSceneBuilder,
                                      jax_add_ragdoll).finalize(),
            chip_smoke.settle_builder(SceneBuilder, add_ragdoll).finalize(
                device="cpu"))


def _diff(a, b):
    """Max abs difference; NaNs must sit at the same places."""
    a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.abs(np.nan_to_num(a) - np.nan_to_num(b)).max(initial=0.0))


def test_apply_ray_impulse_on_hull_scene():
    """Config 3's scene (ragdoll plus a hull debris cube), its bodies moved
    at random; 64 rays, the first 16 aimed at the debris from above its
    neighbours (the hull is their first hit), the rest at ragdoll parts,
    the last 8 far off (misses). The same bodies poked as in the JAX
    package, force and torque accumulators within 1e-3 of a 1000 N poke (a
    miss leaves NaN in the dummy body's accumulators in both packages)."""
    jscene, tscene = _settle_scenes()
    rng = np.random.default_rng(7)
    n, nb = 64, tscene.num_bodies
    n1 = nb + 1
    debris = nb - 1
    pos = np.asarray(jscene.init_pos)[None] + rng.normal(
        size=(n, n1, 3)) * 0.05
    rot = np.asarray(jscene.init_rot)[None] + rng.normal(
        size=(n, n1, 4)) * 0.1
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    f = dict(pos=pos, rot=rot, lin_vel=np.zeros((n, n1, 3)),
             ang_vel=np.zeros((n, n1, 3)), force_acc=np.zeros((n, n1, 3)),
             torque_acc=np.zeros((n, n1, 3)))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    target_body = np.where(np.arange(n) < 16, debris,
                           rng.integers(0, nb - 1, n))
    target = f["pos"][np.arange(n), target_body]
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d[:16] += np.array([0.0, -1.0, 0.0], np.float32)    # down onto the hull
    d[16:] += rng.normal(size=(n - 16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origin = (target - 3.0 * d).astype(np.float32)
    origin[-8:] += 50.0                                   # these miss
    base = jscene.initial_state()
    js = base.replace(controls=None,
                      **{k: jnp.asarray(v) for k, v in f.items()})
    jp = jax.vmap(lambda s, o, dd: jax_apply_ray_impulse(
        jscene, s, o, dd, 1000.0))(js, jnp.asarray(origin), jnp.asarray(d))
    ts = state_from_numpy(dict(f, controls=None), device="cpu")
    tp = apply_ray_impulse(tscene, ts, torch.from_numpy(origin),
                           torch.from_numpy(d), 1000.0)
    jf = np.nan_to_num(np.asarray(jp.force_acc))
    poked = np.abs(jf).sum(-1) > 0
    assert np.array_equal(
        poked, tp.force_acc.nan_to_num().abs().sum(-1).numpy() > 0)
    # the hull is the first hit of most of the rays aimed at it
    assert poked[:16, debris].sum() >= 8, poked[:16].argmax(-1)
    assert poked[16:-8, :nb - 1].any(-1).sum() >= 24
    assert _diff(jp.force_acc, tp.force_acc) <= POKE_TOL
    assert _diff(jp.torque_acc, tp.torque_acc) <= POKE_TOL
