"""Port parity, module render/raster.py (the debug ray-caster):
camera_rays, and render of a scene with every collider type (a sphere, a
capsule, a cylinder, a box, a hull and a ground box) on seeded posed
states, against the JAX package's render run eagerly per env; the
batched render against per-env renders of the port.

Directions within 2e-7: an ulp of unit vectors, as jnp.linspace runs
compiled and its float32 formula, start * (1 - s) + stop * s, is rounded
differently there (XLA:CPU's multiply-adds); no plain float32 order
reproduces it bit for bit. The render is compared twice:
  - on the JAX package's own ray grid (the port's camera_rays swapped for
    it): depth within DEPTH_TOL x max(1, depth), rgb within RGB_TOL;
  - on the port's ray grid: depth within GRID_DEPTH_TOL x max(1, depth),
    rgb within GRID_RGB_TOL. An ulp of a direction moves a grazing ray's
    discriminant b^2 - c (b ~ 8 m, c ~ 64 m^2 at these distances) by an
    ulp of 64, 7.6e-6 m^2, and t = -b - sqrt(disc) by that over
    2 sqrt(disc): 1e-4 m where disc ~ 1e-3 (1.3e-4 seen on a cylinder's
    rim); the normal at the hit point moves by that over the radius
    (0.2 m), and the Lambert term by 0.75 of it.
A pixel whose ray grazes a silhouette could flip its hit between the
packages; EXCUSED_PIXELS of them are allowed (none flips at these
sizes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.render import raster as jr
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.render import raster as tr
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import state_from_numpy
from test_torch_particles import debris_builder

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DEPTH_TOL = 1e-6
RGB_TOL = 1e-6
GRID_DEPTH_TOL = 5e-5
GRID_RGB_TOL = 1e-3
EXCUSED_PIXELS = 0
EYE, TARGET = (6.0, 4.0, 7.0), (0.0, 1.0, 0.0)
W, H = 48, 36


def render_builder(builder):
    b = debris_builder(builder)
    g = b.add_static(position=(0.0, -1.0, 0.0))
    b.add_box_collider(g, (0, 0, 0), (6.0, 1.0, 6.0))
    return b


def test_camera_rays():
    for kw in (dict(width=160, height=120), dict(width=7, height=5,
                                                 fov_deg=75.0)):
        o, d = tr.camera_rays(EYE, TARGET, device="cpu", **kw)
        jo, jd = jr.camera_rays(EYE, TARGET, **kw)
        assert np.array_equal(o.numpy(), np.asarray(jo))
        assert np.abs(d.numpy() - np.asarray(jd)).max() <= 2e-7


def _posed(scene, B, seed):
    rng = np.random.default_rng(seed)
    nb = scene.num_bodies
    pos = np.repeat(scene.init_pos.numpy()[None], B, 0)
    pos[:, :nb] += rng.uniform(-0.3, 0.3, (B, nb, 3)).astype(np.float32)
    rot = rng.normal(size=(B, nb + 1, 4)).astype(np.float32)
    rot[:, nb] = [0, 0, 0, 1]
    rot[0] = [0, 0, 0, 1]                     # env 0 unturned
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    z = np.zeros((B, nb + 1, 3), np.float32)
    return dict(pos=pos, rot=rot, lin_vel=z, ang_vel=z, force_acc=z,
                torque_acc=z, controls=None, cloth=None)


@pytest.mark.parametrize("grid", ["jax", "port"])
def test_render_matches_jax(grid, monkeypatch):
    jscene = render_builder(JaxSceneBuilder).finalize()
    scene = render_builder(SceneBuilder).finalize(device="cpu")
    B = 3
    st = _posed(scene, B, 23)
    if grid == "jax":
        def jax_rays(eye, target, device, **kw):
            return tuple(torch.from_numpy(np.array(x)) for x in
                         jr.camera_rays(eye, target, **kw))
        monkeypatch.setattr(tr, "camera_rays", jax_rays)
        depth_tol, rgb_tol = DEPTH_TOL, RGB_TOL
    else:
        depth_tol, rgb_tol = GRID_DEPTH_TOL, GRID_RGB_TOL
    rgb, depth = tr.render(scene, state_from_numpy(st, device="cpu"),
                           EYE, TARGET, width=W, height=H)
    assert rgb.shape == (B, H, W, 3) and depth.shape == (B, H, W)
    w = tr.world_colliders(scene, *(torch.from_numpy(st[k])
                                    for k in ("pos", "rot")))
    _o, dirs = tr.camera_rays(EYE, TARGET, width=W, height=H, device="cpu")
    t, ci = tr._hit_all_colliders(scene, w, _o, dirs.reshape(-1, 3))
    seen = set(scene.colliders.ctype[ci[t < 1e9]].tolist())
    assert seen == {0, 1, 2, 3, 4}            # every collider type is hit
    for e in range(B):
        js = jscene.initial_state().replace(pos=jnp.asarray(st["pos"][e]),
                                            rot=jnp.asarray(st["rot"][e]))
        jrgb, jdepth = (np.asarray(x) for x in jr.render(
            jscene, js, EYE, TARGET, width=W, height=H))
        hit, jhit = depth[e].numpy() > 0, jdepth > 0
        flips = int((hit != jhit).sum())
        assert flips <= EXCUSED_PIXELS
        both = hit & jhit
        dd = np.abs(depth[e].numpy() - jdepth)[both]
        assert (dd <= depth_tol * np.maximum(1.0, jdepth[both])).all()
        assert np.abs(rgb[e].numpy() - jrgb)[both].max() <= rgb_tol
        assert np.array_equal(rgb[e].numpy()[~hit], jrgb[~jhit])
        assert 0.05 < both.mean() < 0.95
    # the batched render, in any chunking, equals one render per env
    monkeypatch.setattr(tr, "MAX_ELEMENTS", 5000)    # many small chunks
    for e in range(B if grid == "port" else 0):
        one = {k: (v[e:e + 1] if isinstance(v, np.ndarray) else v)
               for k, v in st.items()}
        r1, d1 = tr.render(scene, state_from_numpy(one, device="cpu"), EYE,
                           TARGET, width=W, height=H)
        assert torch.equal(r1[0], rgb[e]) and torch.equal(d1[0], depth[e])
