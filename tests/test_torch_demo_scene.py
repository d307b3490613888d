"""Port parity of the slice as a whole: dxk_tpu_torch/examples/demo_scene.py
against the JAX package's examples/demo_scene.py.

- build_demo_scene gives the JAX scene's arrays (ints exactly, floats to
  1e-7), on the JAX package's terrain heights; with the port's own noise
  the heights are within the noise test's HEIGHT_TOL;
- two frames of the demo loop at one env, two steps each, from the
  initial state with sphere 0 raised to 8 m and sphere 1 falling onto it
  at 4 m/s from 3 cm above (their impact is the first frame's last step,
  so a begin event, an audible sound trigger and a debris burst all come
  within the short horizon; the burst emits in the second frame). The
  JAX side is its physics_step compiled once, then its particle_step and collision
  events, sound triggers and render as the JAX example calls them; the
  port side is run_frame on its plain path with the JAX step's uniforms
  as `draws` and the JAX package's ray grid (tests/test_torch_raster.py
  holds the port's own grid). Each frame's state within
  test_torch_scan_step's tolerances (positions and rotations 1e-6,
  velocities 1e-5 of max(1, the largest)), begin events equal (impulses
  within IMPULSE_TOL of the largest), sound triggers equal (volumes within
  IMPULSE_TOL), pools as tests/test_torch_particles.py holds them, rgb
  and depth as tests/test_torch_raster.py holds them on the JAX grid;
- main(["--device", "cuda"]) raises without a card.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import examples.demo_scene as jdemo
from dxk_tpu.events import collision_events as jax_collision_events
from dxk_tpu.ops import particles as jp
from dxk_tpu.ops.shapes import world_colliders as jax_world_colliders
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.render import raster as jr
from dxk_tpu.utils import sound as jsound
from dxk_tpu.utils.noise import terrain_heightfield as jax_terrain
from dxk_tpu_torch.examples import demo_scene as tdemo
from dxk_tpu_torch.ops.cloth import collider_groups
from dxk_tpu_torch.render import raster as tr
from dxk_tpu_torch.utils.convert import scene_arrays
from test_torch_noise import HEIGHT_TOL
from test_torch_particles import _hold as hold_pool
from test_torch_raster import DEPTH_TOL, RGB_TOL
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

POS_TOL = 1e-6
VEL_TOL = 1e-5
IMPULSE_TOL = 1e-5
STEPS = 2
W, H = 40, 30
REST_Y = 8.0                      # sphere 0's height; sphere 1 falls onto
DROP_Y, DROP_V = 10.03, -4.0      # it from 3 cm above at 4 m/s


def _heights():
    return np.asarray(jax_terrain(**tdemo.TERRAIN))


def _scenes():
    jb, jspheres = jdemo.build_demo_scene()
    tb, tspheres = tdemo.build_demo_scene(heights=_heights())
    assert jspheres == tspheres
    return (jb.finalize(max_narrow_pairs_per_group=64),
            tdemo.finalize_demo(tb, "cpu"), tspheres)


def test_scene_arrays_equal():
    jscene, tscene, _ = _scenes()
    want = {}
    _flatten_jax("", jscene, want)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, k
        else:
            assert np.array_equal(g, w), k
    # 13 bodies, 12 colliders and the terrain, a trigger, six ball joints
    assert tscene.num_bodies == 13 and tscene.colliders.ctype.shape == (12,)
    own, _ = tdemo.build_demo_scene(device="cpu")
    h = own.finalize(device="cpu").heightfield.heights.numpy()
    assert np.abs(h - _heights()).max() <= HEIGHT_TOL


def _draw(ps):
    _key, k_emit = jax.random.split(ps.key)
    return np.asarray(jax.random.uniform(k_emit, (ps.pos.shape[0], 6)))


def _jax_frame(jscene, step, jstate, pools, prev_info, rng):
    """The JAX example's frame (examples/demo_scene.py:113-146) at STEPS
    steps and W x H; returns what it made and the uniforms each pool
    drew."""
    info = None
    for _ in range(STEPS):
        jstate, info = step(jstate)
    draws = {}
    for name in ("fire", "smoke"):
        p, ps = pools[name]
        draws[name] = _draw(ps)
        pools[name] = (p, jp.particle_step(p, ps, 0.5))
    p, ps = pools["debris"]
    draws["debris"] = _draw(ps)
    ps = jp.particle_step(p, ps, 0.5, world=jax_world_colliders(
        jscene, jstate.pos, jstate.rot), hulls=jscene.hulls,
        heightfield=jscene.heightfield)
    p = p.replace(emit_rate=0.0)
    begins, _ends = jax_collision_events(jscene, prev_info, info,
                                         min_impulse=1e-3)
    sounds = jsound.collision_sound_triggers(jscene, begins, rng=rng)
    if begins:
        at = np.asarray(jstate.pos[begins[0].body_a])
        p = jp.debris_params(emit_positions=at[None, :], emit_rate=400.0)
    pools["debris"] = (p, ps)
    rgb, depth = jr.render(jscene, jstate, eye=tdemo.EYE,
                           target=tdemo.TARGET, width=W, height=H)
    return (jstate, info, pools, begins, sounds, np.asarray(rgb),
            np.asarray(depth), draws)


def _hold_state(got, want):
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k)[0].numpy()
        tol = POS_TOL if k in ("pos", "rot") else VEL_TOL * max(
            1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max())


def test_two_frames_match_jax(monkeypatch):
    jscene, scene, spheres = _scenes()
    s0, s1 = spheres[:2]
    js = jscene.initial_state()
    js = js.replace(pos=js.pos.at[s0, 1].set(REST_Y).at[s1, 1].set(DROP_Y),
                    lin_vel=js.lin_vel.at[s1, 1].set(DROP_V))
    st = scene.initial_state(1)
    st.pos[0, s0, 1] = REST_Y
    st.pos[0, s1, 1] = DROP_Y
    st.lin_vel[0, s1, 1] = DROP_V
    settings = JaxPhysicsSettings()
    step = jax.jit(lambda s: jax_physics_step(jscene, s, settings,
                                              tdemo.DT))
    jpools = {"fire": (jp.fire_params(emit_position=tdemo.TORCH_POSITION,
                                      emit_rate=150.0),
                       jp.init_particles(256, seed=1)),
              "smoke": (jp.smoke_params(emit_position=(25.0, 1.5, -5.0),
                                        emit_rate=40.0),
                        jp.init_particles(256, seed=2)),
              "debris": (jp.debris_params(emit_positions=np.zeros((1, 3)),
                                          emit_rate=0.0),
                         jp.init_particles(256, seed=3))}
    pools = tdemo.init_pools(1, "cpu")
    groups = collider_groups(scene.colliders.ctype.numpy(),
                             scene.hulls is not None, "cpu")

    def jax_rays(eye, target, device, **kw):
        return tuple(torch.from_numpy(np.array(x)) for x in
                     jr.camera_rays(eye, target, **kw))
    monkeypatch.setattr(tr, "camera_rays", jax_rays)

    jrng, trng = (np.random.default_rng(tdemo.SOUND_SEED) for _ in "jt")
    jprev = tprev = None
    n_begins = n_sounds = 0
    for _ in range(2):
        (js, jinfo, jpools, jbegins, jsounds, jrgb, jdepth,
         draws) = _jax_frame(jscene, step, js, jpools, jprev, jrng)
        fr = tdemo.run_frame(scene, st, pools, tprev, groups=groups,
                             rng=trng, steps=STEPS, width=W, height=H,
                             draws={k: torch.from_numpy(v[None].copy())
                                    for k, v in draws.items()})
        st, pools, tprev, jprev = fr.state, fr.pools, fr.info, jinfo
        assert set(fr.seconds) == {"steps", "particles", "events", "render"}
        assert all(v >= 0.0 for v in fr.seconds.values())
        _hold_state(st, js)
        begins, _ends = fr.events[0]
        assert len(begins) == len(jbegins)
        n_begins += len(jbegins)
        scale = max([1.0] + [abs(e.impulse) for e in jbegins])
        for a, b in zip(begins, jbegins):
            assert (a.collider_a, a.collider_b, a.body_a, a.body_b) == (
                b.collider_a, b.collider_b, b.body_a, b.body_b)
            assert abs(a.impulse - b.impulse) <= IMPULSE_TOL * scale
        assert len(fr.sounds[0]) == len(jsounds)
        for a, b in zip(fr.sounds[0], jsounds):
            assert {k: v for k, v in a.items() if k != "volume"} == {
                k: v for k, v in b.items() if k != "volume"}
            assert abs(a["volume"] - b["volume"]) <= IMPULSE_TOL
        n_sounds += len(jsounds)
        for name, (jparams, jstate) in jpools.items():
            hold_pool(pools[name][1], [jstate])
            params = pools[name][0]
            for f in dataclasses.fields(params):
                want = np.asarray(getattr(jparams, f.name), np.float32)
                got = getattr(params, f.name).numpy()
                assert np.abs(got.reshape(-1) - want.reshape(-1)).max(
                    initial=0.0) <= POS_TOL, (name, f.name)
        hit = fr.depth[0].numpy() > 0
        assert np.array_equal(hit, jdepth > 0)
        assert (np.abs(fr.depth[0].numpy() - jdepth)[hit]
                <= DEPTH_TOL * np.maximum(1.0, jdepth[hit])).all()
        assert np.abs(fr.rgb[0].numpy() - jrgb).max() <= RGB_TOL
        assert 0.0 < hit.mean() < 1.0
    assert n_begins > 0 and n_sounds > 0
    assert int(jp.alive_count(jpools["debris"][1])) > 0     # the burst


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo runs there")
    with pytest.raises(RuntimeError):
        tdemo.main(["--device", "cuda"])
