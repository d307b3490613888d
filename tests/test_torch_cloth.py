"""Port parity, module ops/cloth.py and the cloth half of scene/builder.py,
against the JAX package's ops/cloth.py and SceneBuilder.

  - the baked ClothParams of one cloth, a rotated cloth and two merged
    cloths: every array exact (both builders bake in float64 and cast once);
  - the greedy colour groups, exact; the "scan" sweep's dependency levels
    (each level's constraints share no particle, every particle's
    constraints in rising levels in constraint order);
  - apply_wind_force, each solve in both modes, and cloth_step with
    velocity, position and drift iterations and non-zero velocities, on
    seeded positions of 6 envs; each solve of one env bit for bit against
    the JAX package's run op by op;
  - _particle_collider_sdf on seeded particles around a sphere, a capsule,
    a cylinder, a box and a hull (chip_smoke.sdf_case_builder's scene, 8
    envs of random body turns), and collide_particles with its heightfield,
    one-way and two-way (jsum / tsum);
  - chip_smoke's cloth scene (the terrain, config 3's ragdoll, the debris
    and both sheets) on the fused branch at one env, 3 steps from the
    port's state after PHASE_WARM steps (the thick sheet on the ragdoll and
    the terrain), each step's cloth substep against the JAX package's
    _cloth_substep on the inputs the port's step handed its own (the state
    before and after the rigid step, the solver bodies; the colliders of
    the state before). The JAX package's eager fused step of this scene
    takes 123 s for its first step and 17 s for each later one at 3 solver
    iterations (193 s and 62 s at 30), past a test file's time; its rigid
    step is held by tests/test_torch_terrain.py, and the whole fused step
    with cloth bit for bit by tests/test_torch_cloth_step.py.

The JAX side runs under jax.jit(jax.vmap(...)). XLA:CPU contracts
multiply-adds there, which the port's eager operations do not, so values
are held to TOL relative to max(1, the largest value): 1e-6 for one pass,
TOL_STEP for whole cloth steps (five passes and (pos - prev) / dt, which
scales a position's rounding by 120). The eager JAX step is matched bit
for bit (tests/test_torch_cloth_step.py). Inputs come from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu import physics as jax_physics
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.ops import cloth as jcloth
from dxk_tpu.ops.integrator import SolverBodies as JaxSolverBodies
from dxk_tpu.ops.integrator import integrate_forces as jax_integrate_forces
from dxk_tpu.ops.shapes import world_colliders as jax_world_colliders
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene.scene import ClothState as JaxClothState
from dxk_tpu_torch import physics
from dxk_tpu_torch.ops import cloth as tcloth
from dxk_tpu_torch.ops.integrator import integrate_forces
from dxk_tpu_torch.ops.shapes import world_colliders
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.scene import ClothState
from dxk_tpu_torch.utils.convert import scene_arrays
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = np.float32(1.0 / 120.0)
TOL = 1e-6
TOL_STEP = 1e-5
TOL_STEP_VEL = 1e-4
ENVS = 6
WIND = (0.0, 2.0, 30.0)


def _cloth_builder(builder, kind):
    b = builder()
    if kind == "one":
        b.add_cloth(width=2.0, height=2.0, grid_x=8, grid_y=8,
                    total_mass=1.0, transform_pos=(0, 3, 0))
    elif kind == "small":
        b.add_cloth(width=1.0, height=1.0, grid_x=4, grid_y=5,
                    total_mass=1.0, transform_pos=(0, 2, 0))
    elif kind == "rotated":
        b.add_cloth(width=1.5, height=2.5, grid_x=7, grid_y=9,
                    total_mass=2.0, stiffness=0.6, damping=0.3,
                    gravity_factor=0.8, transform_pos=(1.0, 2.0, -0.5),
                    transform_rot=(0.2, 0.3, -0.1, 0.927), thickness=0.03)
    else:
        b.add_cloth(width=2.0, height=2.0, grid_x=6, grid_y=6,
                    total_mass=1.0, damping=0.5, transform_pos=(0, 3, 0))
        b.add_cloth(width=2.0, height=2.0, grid_x=6, grid_y=5,
                    total_mass=1.5, damping=0.9, stiffness=0.005,
                    transform_pos=(5, 4, 0), thickness=0.05)
    b.add_force_field(WIND)
    return b


KINDS = ("one", "rotated", "merged")


def scenes(kind):
    return (_cloth_builder(JaxSceneBuilder, kind).finalize(),
            _cloth_builder(SceneBuilder, kind).finalize(device="cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_baked_cloth_params(kind):
    jscene, tscene = scenes(kind)
    prefixes = ("cloth.", "global_ff_force", "ff_forces")
    got = {k: v for k, v in scene_arrays(tscene).items()
           if k.startswith(prefixes)}
    want = {}
    _flatten_jax("", jscene, want)
    want = {k: v for k, v in want.items() if k.startswith(prefixes)}
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tscene.cloth.grids == jscene.cloth.grids


@pytest.mark.parametrize("kind", KINDS)
def test_colour_groups(kind):
    jscene, tscene = scenes(kind)
    want = jcloth._constraint_colors(jscene.cloth)
    got = tscene.cloth.color_index
    assert len(got) == len(want)
    cons = tscene.cloth.constraints.numpy()
    for (idx, ia, ib), w in zip(got, want):
        np.testing.assert_array_equal(idx.numpy(), w)
        np.testing.assert_array_equal(ia.numpy(), cons[w, 0])
        np.testing.assert_array_equal(ib.numpy(), cons[w, 1])


@pytest.mark.parametrize("kind", KINDS)
def test_scan_levels_are_the_sweep(kind):
    """Each level's constraints touch distinct particles, every constraint
    is in exactly one level, and each particle meets its constraints in
    rising levels in constraint order: solving the levels in turn is the
    sequential sweep."""
    cl = scenes(kind)[1].cloth
    cons = cl.constraints.numpy()
    level_of = np.full(len(cons), -1)
    for lv, (idx, ia, ib) in enumerate(cl.scan_levels):
        ends = np.concatenate([ia.numpy(), ib.numpy()])
        assert len(np.unique(ends)) == len(ends)
        np.testing.assert_array_equal(cons[idx.numpy()],
                                      np.stack([ia, ib], -1))
        assert (level_of[idx.numpy()] == -1).all()
        level_of[idx.numpy()] = lv
    assert (level_of >= 0).all()
    for p in np.unique(cons):
        lv = level_of[np.flatnonzero((cons == p).any(-1))]
        assert (np.diff(lv) > 0).all()


def _seeded(tscene, seed, spread=0.05):
    """ENVS envs of the cloth's particles moved by a seeded normal spread
    (pinned ones too, as the solves see any input), velocities normal."""
    rng = np.random.default_rng(seed)
    p0 = tscene.cloth.init_positions.numpy()
    pos = (p0 + rng.normal(scale=spread, size=(ENVS,) + p0.shape)
           ).astype(np.float32)
    vel = rng.normal(scale=0.5, size=pos.shape).astype(np.float32)
    prev = (pos - vel * DT).astype(np.float32)
    return pos, prev, vel


def _jax_vmap(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*args))


def _hold(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_wind_force(kind):
    jscene, tscene = scenes(kind)
    pos, _prev, _vel = _seeded(tscene, 1)
    forces = np.random.default_rng(2).normal(size=pos.shape).astype(
        np.float32)

    def jf(p, f):
        st = JaxClothState(positions=p, prev_positions=p,
                           velocities=jnp.zeros_like(p), forces=f)
        return jcloth.apply_wind_force(jscene.cloth, st,
                                       jscene.global_ff_force).forces
    want = _jax_vmap(jf, pos, forces)
    t = torch.from_numpy
    st = ClothState(positions=t(pos), prev_positions=t(pos),
                    velocities=torch.zeros_like(t(pos)), forces=t(forces))
    got = tcloth.apply_wind_force(tscene.cloth, st, tscene.global_ff_force)
    _hold(got.forces, want, TOL, "forces")
    assert np.abs(want - forces).max() > 1e-3


def _groups(tscene, mode):
    return (tscene.cloth.color_index if mode == "colored"
            else tscene.cloth.scan_levels)


def _grad_inputs(tscene, prev):
    """The velocity pass's gradients and inverse scaled squared gradients,
    as cloth_step makes them, in numpy float32."""
    cons = tscene.cloth.constraints.numpy()
    ims = tscene.cloth.inv_mass_sums.numpy()
    grad = prev[:, cons[:, 1]] - prev[:, cons[:, 0]]
    denom = np.sum(grad * grad, -1) * ims
    inv = np.where(ims == 0.0, np.float32(0.0),
                   np.float32(1.0) / np.maximum(denom, np.float32(1e-30)))
    return grad.astype(np.float32), inv.astype(np.float32)


@pytest.mark.parametrize("mode", ["scan", "colored"])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_positions(kind, mode):
    jscene, tscene = scenes(kind)
    pos, _prev, _vel = _seeded(tscene, 3, spread=0.1)
    jfn = getattr(jcloth, f"_solve_positions_{mode}")
    want = _jax_vmap(lambda p: jfn(jscene.cloth, p), pos)
    got = tcloth._solve_positions(tscene.cloth, torch.from_numpy(pos),
                                  _groups(tscene, mode))
    _hold(got, want, TOL, "positions")
    assert np.abs(want - pos).max() > 1e-3


@pytest.mark.parametrize("mode", ["scan", "colored"])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_velocities(kind, mode):
    jscene, tscene = scenes(kind)
    _pos, prev, vel = _seeded(tscene, 4, spread=0.1)
    grad, inv = _grad_inputs(tscene, prev)
    jfn = getattr(jcloth, f"_solve_velocities_{mode}")
    want = _jax_vmap(lambda v, g, i: jfn(jscene.cloth, v, g, i), vel, grad,
                     inv)
    t = torch.from_numpy
    got = tcloth._solve_velocities(tscene.cloth, t(vel), t(grad), t(inv),
                                   _groups(tscene, mode))
    _hold(got, want, TOL, "velocities")
    assert np.abs(want - vel).max() > 1e-3


@pytest.mark.parametrize("mode", ["scan", "colored"])
def test_solves_bit_equal_to_eager_jax(mode):
    """The sweep's dependency levels and the colour groups against the JAX
    package's solves run op by op (jax.disable_jit(), one env of a 4 x 5
    cloth: the eager lax.scan takes ~60 ms a constraint): positions and
    velocities bit for bit."""
    jscene, tscene = scenes("small")
    pos, prev, vel = _seeded(tscene, 6, spread=0.1)
    grad, inv = _grad_inputs(tscene, prev)
    with jax.disable_jit():
        want_p = np.asarray(getattr(jcloth, f"_solve_positions_{mode}")(
            jscene.cloth, jnp.asarray(pos[0])))
        want_v = np.asarray(getattr(jcloth, f"_solve_velocities_{mode}")(
            jscene.cloth, jnp.asarray(vel[0]), jnp.asarray(grad[0]),
            jnp.asarray(inv[0])))
    t = torch.from_numpy
    groups = _groups(tscene, mode)
    got_p = tcloth._solve_positions(tscene.cloth, t(pos[:1]), groups)
    got_v = tcloth._solve_velocities(tscene.cloth, t(vel[:1]), t(grad[:1]),
                                     t(inv[:1]), groups)
    np.testing.assert_array_equal(got_p[0].numpy(), want_p)
    np.testing.assert_array_equal(got_v[0].numpy(), want_v)


ITERS = dict(num_cloth_velocity_iterations=2,
             num_cloth_position_iterations=2, num_cloth_drift_iterations=1)


@pytest.mark.parametrize("mode", ["scan", "colored"])
@pytest.mark.parametrize("kind", KINDS)
def test_cloth_step(kind, mode):
    """cloth_step without colliders: wind, gravity, the three passes and
    damping, from seeded positions with non-zero velocities."""
    jscene, tscene = scenes(kind)
    pos, prev, vel = _seeded(tscene, 5)
    js = JaxPhysicsSettings(cloth_solver_mode=mode, **ITERS)

    def jf(p, q, v):
        st = JaxClothState(positions=p, prev_positions=q, velocities=v,
                           forces=jnp.zeros_like(p))
        out, imp = jcloth.cloth_step(jscene.cloth, st, js,
                                     jscene.global_ff_force, jnp.float32(DT))
        assert imp is None
        return out.positions, out.prev_positions, out.velocities
    want = jax.jit(jax.vmap(jf))(pos, prev, vel)
    t = torch.from_numpy
    st = ClothState(positions=t(pos), prev_positions=t(prev),
                    velocities=t(vel), forces=torch.zeros_like(t(pos)))
    got, imp = tcloth.cloth_step(
        tscene.cloth, st, PhysicsSettings(cloth_solver_mode=mode, **ITERS),
        tscene.global_ff_force, float(DT))
    assert imp is None
    for name, g, w in zip(("positions", "prev_positions", "velocities"),
                          (got.positions, got.prev_positions,
                           got.velocities), want):
        _hold(g, w, TOL_STEP, name)
    assert not got.forces.any()


# ---------------------------------------------------------------------------
# the particle SDF and the push-out, on chip_smoke's SDF case

SDF_ENVS = 8


@pytest.fixture(scope="module")
def sdf_case():
    """chip_smoke.cloth_sdf_case's inputs at SDF_ENVS envs, and the JAX
    package's scene of the same builder."""
    keep = chip_smoke.SDF_CASE_ENVS
    chip_smoke.SDF_CASE_ENVS = SDF_ENVS
    try:
        tscene, st, p, vel = chip_smoke.cloth_sdf_case(7)
    finally:
        chip_smoke.SDF_CASE_ENVS = keep
    jscene = chip_smoke.sdf_case_builder(JaxSceneBuilder).finalize()
    return jscene, tscene, st, p, vel


def test_collider_groups(sdf_case):
    _j, tscene, *_ = sdf_case
    groups = {n: i.tolist() for n, i in tscene.cloth.collider_groups}
    assert groups == {"sphere": [0], "capsule": [1], "cylinder": [2],
                      "box": [3], "hull": [4]}


def test_particle_collider_sdf(sdf_case):
    jscene, tscene, st, p, _vel = sdf_case
    pos, rot = st.pos.numpy(), st.rot.numpy()

    def jf(ps, rs, pp):
        w = jax_world_colliders(jscene, ps, rs)
        return jcloth._particle_collider_sdf(w, jscene.hulls, pp)
    wsd, wn = jax.jit(jax.vmap(jf))(pos, rot, p.numpy())
    w = world_colliders(tscene, st.pos, st.rot)
    sd, n = tcloth._particle_collider_sdf(w, tscene.hulls, p,
                                          tscene.cloth.collider_groups)
    _hold(sd, wsd, TOL, "sd")
    _hold(n, wn, TOL, "normal")
    target = np.arange(p.shape[1]) % 6
    for c in range(5):
        own = sd[:, c, torch.from_numpy(target == c)]
        assert (own > 0).any() and (own <= 0).any(), c


@pytest.mark.parametrize("two_way", [False, True])
def test_collide_particles(sdf_case, two_way):
    jscene, tscene, st, p, vel = sdf_case
    dt = float(DT)

    def jf(ps, rs, lv, av, pp, vv):
        jst = jscene.initial_state().replace(pos=ps, rot=rs, lin_vel=lv,
                                             ang_vel=av)
        w = jax_world_colliders(jscene, ps, rs)
        bodies = jax_integrate_forces(jscene, jst, jnp.float32(dt))
        return jcloth.collide_particles(
            jscene.cloth, w, jscene.hulls, jscene.heightfield, pp, vv,
            bodies=bodies if two_way else None,
            colbody=jscene.colliders.body if two_way else None)
    want = jax.jit(jax.vmap(jf))(*(x.numpy() for x in (
        st.pos, st.rot, st.lin_vel, st.ang_vel, p, vel)))
    w = world_colliders(tscene, st.pos, st.rot)
    bodies = integrate_forces(tscene, st, dt)
    got = tcloth.collide_particles(
        tscene.cloth, w, tscene.hulls, tscene.heightfield, p, vel,
        bodies=bodies if two_way else None,
        colbody=tscene.colliders.body if two_way else None)
    names = ("pos", "vel", "jsum", "tsum")
    assert len(got) == len(want) == (4 if two_way else 2)
    for name, g, wv in zip(names, got, want):
        _hold(g, wv, TOL_STEP if name in ("jsum", "tsum") else TOL, name)
    moved = (got[0] - p).abs().amax(-1)
    terrain = torch.from_numpy(np.arange(p.shape[1]) % 6 == 5)
    assert (moved[:, terrain] > 0).any() and (moved[:, ~terrain] > 0).any()
    if two_way:
        assert float(got[2][:, :5].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the cloth substep of chip_smoke's cloth scene on the fused branch
PHASE_WARM = 105
PHASE_STEPS = 3
PHASE_ITERS = 3


def _jax_cloth(cl, e=0):
    return JaxClothState(**{f.name: jnp.asarray(getattr(cl, f.name)[e])
                            for f in dataclasses.fields(JaxClothState)})


def _jax_state(jscene, st, e=0):
    return jscene.initial_state().replace(
        pos=jnp.asarray(st.pos[e]), rot=jnp.asarray(st.rot[e]),
        lin_vel=jnp.asarray(st.lin_vel[e]),
        ang_vel=jnp.asarray(st.ang_vel[e]),
        force_acc=jnp.asarray(st.force_acc[e]),
        torque_acc=jnp.asarray(st.torque_acc[e]),
        cloth=_jax_cloth(st.cloth, e))


def test_cloth_phase_substep_matches_jax(monkeypatch):
    kw = dict(solver_mode="fused", num_rigid_solver_iterations=PHASE_ITERS,
              cloth_solver_mode="colored", cloth_two_way=True)
    tscene = chip_smoke.cloth_scene("cpu")
    jscene = chip_smoke.cloth_builder(JaxSceneBuilder,
                                      jax_add_ragdoll).finalize()
    settings = PhysicsSettings(**kw)
    st = tscene.initial_state(1)
    for _ in range(PHASE_WARM):
        st = physics_step(tscene, st, settings, DT)[0]
    hits = chip_smoke.cloth_contacts(tscene, st,
                                     chip_smoke.cloth_kinds(tscene))[0][0]
    assert hits[0] > 0 and hits[2] > 0, hits        # ragdoll and terrain

    calls = []
    real = physics._cloth_substep

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(physics, "_cloth_substep", spy)
    js = JaxPhysicsSettings(**kw)
    substep = jax.jit(lambda ns, s, b: jax_physics._cloth_substep(
        jscene, ns, s, js, jnp.float32(DT),
        jax_world_colliders(jscene, s.pos, s.rot), b))
    impulse = 0.0
    for _ in range(PHASE_STEPS):
        st = physics_step(tscene, st, settings, DT)[0]
        (_scene, new_state, state, _s, _dt, _w, bodies), out = calls[-1]
        jstate = _jax_state(jscene, state)
        jnew = jscene.initial_state().replace(
            pos=jnp.asarray(new_state.pos[0]),
            rot=jnp.asarray(new_state.rot[0]),
            lin_vel=jnp.asarray(new_state.lin_vel[0]),
            ang_vel=jnp.asarray(new_state.ang_vel[0]),
            cloth=_jax_cloth(state.cloth))
        jb = JaxSolverBodies(**{
            f.name: jnp.asarray(getattr(bodies, f.name)[0]
                                if f.name not in ("local_cog", "inv_mass")
                                else getattr(bodies, f.name))
            for f in dataclasses.fields(JaxSolverBodies)})
        want = substep(jnew, jstate, jb)
        for k, tol in (("lin_vel", TOL_STEP_VEL), ("ang_vel", TOL_STEP_VEL),
                       ("positions", TOL), ("velocities", TOL_STEP_VEL)):
            cloth = k in ("positions", "prev_positions", "velocities")
            w_ = np.asarray(getattr(want.cloth if cloth else want, k))
            g = getattr(out.cloth if cloth else out, k)[0].numpy()
            scale = max(1.0, float(np.abs(w_).max()))
            err = float(np.abs(g - w_).max())
            assert err <= tol * scale, (k, err, scale)
        impulse = max(impulse, float((out.lin_vel - new_state.lin_vel)[
            0, :-1].abs().max()))
        assert torch.equal(out.cloth.positions, st.cloth.positions)
    assert impulse > 0.0            # the sheet pushed a body back
