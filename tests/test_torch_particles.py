"""Port parity, module ops/particles.py: the four particle systems through
the JAX package's particle_step and the port's on the same pools, with the
JAX step's own uniforms passed to the port as `draws`.

- fire, smoke and boid: 256-slot pools of two envs (their own emit
  positions and rates) over four frames from empty;
- debris: 192-slot pools of two envs against a scene with a sphere, a
  capsule, a cylinder, a box, a hull and a heightfield patch (turned at
  random per env), seeded alive particles around each surface plus an
  emission from two emit points, over three frames;
- render_order, rel_life and alive_count on the resulting pools;
- the carriers of utils/convert.py (JAX pool and packs -> port -> numpy).

Alive counts and emit_accum are held exactly (integer counts and the same
float32 accumulate); positions, velocities and lives within
PARTICLE_TOL x max(1, their largest): the same float32 operations, but
sqrt, cos and sin of the two packages may round an ulp apart."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.ops import particles as jp
from dxk_tpu.ops.shapes import world_colliders as jax_world_colliders
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.ops import particles as tp
from dxk_tpu_torch.ops.cloth import collider_groups
from dxk_tpu_torch.ops.shapes import world_colliders
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import (particle_params_from_numpy,
                                         particle_state_from_numpy,
                                         state_from_numpy)

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

PARTICLE_TOL = 1e-5
FIELDS = ("pos", "vel", "life", "max_life", "rot")
KINDS = {"fire": (jp.fire_params, ((0.0, 0.5, 0.0), (3.0, 1.0, -2.0)),
                  (150.0, 37.5)),
         "smoke": (jp.smoke_params, ((0.0, 1.5, 0.0), (1.0, 2.0, 1.0)),
                   (40.0, 61.0)),
         "boid": (jp.boid_params, ((0.0, 0.0, 0.0), (2.0, 1.0, 0.0)),
                  (50.0, 13.3))}


def _np(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.name != "key"}


def _stack(dicts):
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _jax_frame(params, states, dt, **kw):
    """Each env's JAX step and the uniforms it drew, (B, N, 6)."""
    outs, draws = [], []
    for p, s, extra in zip(params, states, kw.pop("per_env", None)
                           or [{}] * len(states)):
        _key, k_emit = jax.random.split(s.key)
        draws.append(np.asarray(jax.random.uniform(k_emit,
                                                   (s.pos.shape[0], 6))))
        outs.append(jp.particle_step(p, s, dt, **extra, **kw))
    return outs, torch.from_numpy(np.stack(draws))


def _hold(tstate, jstates):
    want = _stack([_np(s) for s in jstates])
    got = tstate
    alive_t = tp.alive_count(got).numpy()
    alive_j = np.array([int(jp.alive_count(s)) for s in jstates])
    assert np.array_equal(alive_t, alive_j)
    assert np.array_equal(got.emit_accum.numpy(), want["emit_accum"])
    for k in FIELDS:
        w = want[k]
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(getattr(got, k).numpy() - w).max())
        assert err <= PARTICLE_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_emitters_match_jax(kind):
    make, positions, rates = KINDS[kind]
    jparams = [make(emit_position=p, emit_rate=r)
               for p, r in zip(positions, rates)]
    jstates = [jp.init_particles(256, seed=s) for s in (11, 12)]
    tparams = particle_params_from_numpy(kind, _stack([_np(p)
                                                       for p in jparams]),
                                         device="cpu")
    if kind == "smoke":         # the spline's knots are shared
        tparams = tparams.replace(
            life_spline_ts=tparams.life_spline_ts[0],
            life_spline_vals=tparams.life_spline_vals[0])
    tstate = tp.init_particles(256, batch=2, device="cpu")
    dt = 0.5 if kind != "boid" else 0.1
    for _ in range(4):
        jstates, draws = _jax_frame(jparams, jstates, dt)
        tstate = tp.particle_step(tparams, tstate, dt, draws=draws)
        _hold(tstate, jstates)
    assert int(tp.alive_count(tstate).min()) > 0


def debris_builder(builder):
    """A sphere, a capsule, a cylinder, a box and the golden hull, each on
    a body of its own, over a 9 x 9 patch of config 4's terrain."""
    b = builder()
    b.set_heightfield(chip_smoke.terrain_heights()[:9, :9], cell_size=1.0,
                      min_corner=(-4.0, 0.0, -4.0), friction=1.0)
    s = b.add_body(position=(-2.0, 1.5, -2.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.4)
    c = b.add_body(position=(0.0, 1.5, -2.0))
    b.add_capsule_collider(c, (-0.3, 0, 0), (0.3, 0, 0), 0.2)
    y = b.add_body(position=(2.0, 1.5, -2.0))
    b.add_cylinder_collider(y, (0, -0.3, 0), (0, 0.3, 0), 0.3)
    x = b.add_body(position=(-2.0, 1.5, 2.0))
    b.add_box_collider(x, (0, 0, 0), (0.3, 0.2, 0.4))
    h = b.add_body(position=(2.0, 1.5, 2.0))
    b.add_hull_collider(h, b.add_hull_geometry_from_mesh(
        chip_smoke.GOLDEN_HULL))
    return b


def _debris_inputs(scene, rng, B, N):
    """Envs with the bodies turned at random; N slots of which the first
    two thirds are alive within 0.5 m of a surface (slot i by surface i mod
    6, the terrain last) and moving at random, the rest dead."""
    nb = scene.num_bodies
    rot = rng.normal(size=(B, nb + 1, 4)).astype(np.float32)
    rot[:, nb] = [0, 0, 0, 1]
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    pos = np.repeat(scene.init_pos.numpy()[None], B, 0)
    target = np.arange(N) % 6
    p = pos[:, np.minimum(target, nb - 1)] + rng.uniform(
        -0.5, 0.5, (B, N, 3)).astype(np.float32)
    ter = target == 5
    p[:, ter, 1] = rng.uniform(-0.1, 0.6, (B, int(ter.sum())))
    life = rng.uniform(0.5, 5.0, (B, N)).astype(np.float32)
    life[:, 2 * N // 3:] = 0.0
    ang = rng.uniform(0, 2 * np.pi, (B, N)).astype(np.float32)
    pool = dict(pos=p.astype(np.float32),
                vel=rng.normal(size=(B, N, 3)).astype(np.float32) * 2.0,
                life=life, max_life=np.full((B, N), 5.5, np.float32),
                rot=np.stack([np.sin(ang), np.cos(ang)], -1),
                emit_accum=np.array([0.25, 0.75], np.float32))
    z = np.zeros((B, nb + 1, 3), np.float32)
    state = dict(pos=pos, rot=rot, lin_vel=z, ang_vel=z, force_acc=z,
                 torque_acc=z, controls=None, cloth=None)
    return pool, state


def test_debris_matches_jax():
    jscene = debris_builder(JaxSceneBuilder).finalize()
    scene = debris_builder(SceneBuilder).finalize(device="cpu")
    rng = np.random.default_rng(17)
    B, N = 2, 192
    pool, st = _debris_inputs(scene, rng, B, N)
    tstate = state_from_numpy(st, device="cpu")
    w = world_colliders(scene, tstate.pos, tstate.rot)
    groups = collider_groups(scene.colliders.ctype.numpy(),
                             scene.hulls is not None, "cpu")
    jparams = jp.debris_params(emit_positions=[[0.0, 2.5, 0.0],
                                               [1.0, 2.0, 1.0]],
                               emit_rate=100.0)
    tparams = particle_params_from_numpy("debris", _np(jparams), "cpu")
    jstates = [jp.ParticleState(**{k: jnp.asarray(v[e])
                                   for k, v in pool.items()},
                                key=jax.random.PRNGKey(20 + e))
               for e in range(B)]
    jworld = [dict(world=jax_world_colliders(jscene,
                                             jnp.asarray(st["pos"][e]),
                                             jnp.asarray(st["rot"][e])))
              for e in range(B)]
    tpool = particle_state_from_numpy(pool, device="cpu")
    hits = 0
    for _ in range(3):
        jstates, draws = _jax_frame(
            [jparams] * B, jstates, 1.0 / 30.0, per_env=jworld,
            hulls=jscene.hulls, heightfield=jscene.heightfield)
        before = tpool.vel
        tpool = tp.particle_step(tparams, tpool, 1.0 / 30.0, world=w,
                                 hulls=scene.hulls,
                                 heightfield=scene.heightfield,
                                 groups=groups, draws=draws)
        _hold(tpool, jstates)
        # bounces: upward velocity where gravity and drag alone pull down
        hits += int(((tpool.vel[..., 1] > before[..., 1] + 1e-3)
                     & (tpool.life > 0)).sum())
    assert hits > 20


def test_debris_needs_groups():
    scene = debris_builder(SceneBuilder).finalize(device="cpu")
    st = scene.initial_state(1)
    w = world_colliders(scene, st.pos, st.rot)
    with pytest.raises(ValueError):
        tp.particle_step(tp.debris_params([[0.0, 1.0, 0.0]], device="cpu"),
                         tp.init_particles(8, device="cpu"), 0.1, world=w)


def test_render_order_rel_life_and_carriers():
    jstate = jp.init_particles(256, seed=4)
    jparams = jp.fire_params(emit_position=(0.0, 0.5, 0.0), emit_rate=300.0)
    for _ in range(3):
        jstate = jp.particle_step(jparams, jstate, 0.3)
    tstate = particle_state_from_numpy(_np(jstate), device="cpu", batch=1)
    # the carrier: the JAX pool through the port and back, bit for bit
    for k, v in _np(jstate).items():
        assert np.array_equal(getattr(tstate, k)[0].numpy(), v)
    tparams = particle_params_from_numpy("fire", _np(jparams), "cpu")
    for f in dataclasses.fields(tparams):
        assert np.array_equal(getattr(tparams, f.name).numpy(),
                              np.asarray(getattr(jparams, f.name)))
    cam = (4.0, 3.0, -2.0)
    for ftb in (False, True):
        order, alive = tp.render_order(tstate, cam, front_to_back=ftb)
        jorder, jalive = jp.render_order(jstate, cam, front_to_back=ftb)
        # distances of distinct positions differ; dead slots tie at +inf
        # and keep their index order (both sorts are stable)
        assert np.array_equal(order[0].numpy(), np.asarray(jorder))
        assert np.array_equal(alive[0].numpy(), np.asarray(jalive))
    assert np.abs(tp.rel_life(tstate)[0].numpy()
                  - np.asarray(jp.rel_life(jstate))).max() <= 1e-7
    assert int(tp.alive_count(tstate)[0]) == int(jp.alive_count(jstate))
