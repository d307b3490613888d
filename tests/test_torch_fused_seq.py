"""Port parity for the sequential fused step (solver_mode="fused_seq") and
for the fused step fed joint rows prepared outside the kernel
(joint_prep_in_kernel=False): the six joint preps of ops/solver.py,
batched_solver.pack_joint_type and the sequential joint solve, the plain
version of the fused step in both modes, physics.py's routing and
LocoEnv(solver_mode="fused_seq"), against the JAX package.

Inputs are made from a numpy seed. The JAX preps run under
jax.jit(jax.vmap(...)). The JAX fused step runs unbatched, op by op under
jax.disable_jit() (a compiled JAX fused_seq step of these scenes takes
minutes and many GB to build on the CPU), at 3 solver iterations instead of
30, which keeps one eager step at 5-20 s; the 30-iteration kernel is held
against the plain version and the goldens on the card (chip_smoke.py).
Each JAX reference is computed once per module and shared by the tests
that read it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.envs.loco_env import LocoEnv as JaxLocoEnv
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.ops import solver as jsolver
from dxk_tpu.ops.integrator import integrate_forces as jax_integrate_forces
from dxk_tpu.ops.pallas import batched_solver as jbs
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.envs.loco_env import DT as LOCO_DT
from dxk_tpu_torch.envs.loco_env import LocoEnv
from dxk_tpu_torch.ops.integrator import integrate_forces
from dxk_tpu_torch.ops.kernels import batched_solver as tbs
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.ops.shapes import world_colliders
from dxk_tpu_torch.ops.solver import prep_joints
from dxk_tpu_torch.physics import PhysicsSettings, joint_inputs, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
ITERS = 3
BP = 6                   # envs of the prep tests
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")
PREP_TOL = 1e-6          # relative to max(1, the column's largest value)
# (B, J * ROWS) table columns that hold a limit flag, by joint type and name
LIMIT_ROWS = {"hinge": {"limit": 40}, "slider": {"limit": 51},
              "cone_twist": {"swing_limit": 45, "twist_limit": 48}}


def _mixed_builder(builder):
    """tests/test_fused_seq.py::_mixed_scene with a `builder` class: three
    stacked boxes, a sphere and a capsule on ball joint to the ground."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    for i in range(3):
        bd = b.add_body(position=(0.02 * i, 0.5 + 1.001 * i, -0.01 * i))
        b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
    s = b.add_body(position=(2.0, 1.0, 0.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.5)
    c = b.add_body(position=(-2.0, 1.0, 0.0))
    b.add_capsule_collider(c, (0, -0.3, 0), (0, 0.3, 0), 0.2)
    b.add_ball_constraint(g, c, (-2.0, 2.0, 0.0))
    return b


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, port scene): a golden scene, the mixed scene of
    tests/test_fused_seq.py, or the loco env's."""
    if name == "loco":
        return JaxLocoEnv().scene, LocoEnv(solver_mode="fused",
                                           device="cpu").scene
    if name == "mixed":
        return (_mixed_builder(JaxSceneBuilder).finalize(),
                _mixed_builder(SceneBuilder).finalize(device="cpu"))
    return (chip_smoke.golden_builder(JaxSceneBuilder, name,
                                      jax_add_ragdoll).finalize(),
            chip_smoke.shapes_scene(name, "cpu"))


def _rel_diff(got, want):
    """Largest |got - want| of a (B, columns) table, each column over
    max(1, its largest |want|)."""
    want = np.asarray(want, np.float64)
    scale = np.maximum(1.0, np.abs(want).max(axis=0))
    return float((np.abs(np.asarray(got, np.float64) - want) / scale).max(
        initial=0.0))


@pytest.mark.parametrize("name", ["box_stack", "double_pendulum",
                                  "constraint_zoo", "ragdoll_settle",
                                  "mixed"])
def test_scene_arrays_equal(name):
    """chip_smoke.py's copies of the golden scenes (the fidelity row runs
    them on the card) and of the mixed scene build the JAX package's
    arrays: ints exactly, floats to 1e-7; the fused step takes each."""
    jscene, tscene = scenes(name)
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
    assert fs.fused2_eligible(tscene)


# ---------------------------------------------------------------------------
# seeded states


def _np_quat(axis, angle):
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    return np.concatenate([axis * np.sin(angle / 2)[..., None],
                           np.cos(angle / 2)[..., None]], -1)


def _np_qmul(a, b):
    av, aw = a[..., :3], a[..., 3:]
    bv, bw = b[..., :3], b[..., 3:]
    return np.concatenate([av * bw + bv * aw + np.cross(av, bv),
                           aw * bw - (av * bv).sum(-1, keepdims=True)], -1)


def moved_state(name, batch, seed):
    """Numpy fields of `batch` envs of a scene's initial state with every
    dynamic body turned about a seeded axis by 0.6-1.6 rad, moved by up to
    0.6 m and given seeded velocities of up to 1 m/s and 2 rad/s: far enough
    to put the zoo chain's hinge, swing, twist and slider limits past their
    bounds. Motor controls: seeded motor types, targets and torques, motors
    on in about two of three joints."""
    _jscene, tscene = scenes(name)
    rng = np.random.default_rng(seed)
    init = tscene.initial_state(batch)
    n1 = init.pos.shape[1]
    dyn = tscene.body_params.inv_mass.numpy() > 0.0
    axis = rng.normal(size=(batch, n1, 3))
    turn = _np_quat(axis, rng.uniform(0.6, 1.6, (batch, n1)))
    rot = init.rot.numpy().astype(np.float64)
    rot = np.where(dyn[None, :, None], _np_qmul(turn, rot), rot)
    pos = init.pos.numpy() + dyn[None, :, None] * rng.uniform(
        -0.6, 0.6, (batch, n1, 3))
    lin = dyn[None, :, None] * rng.uniform(-1.0, 1.0, (batch, n1, 3))
    ang = dyn[None, :, None] * rng.uniform(-2.0, 2.0, (batch, n1, 3))
    ctl = {}
    for f, v in vars(init.controls).items():
        shape = tuple(v.shape)
        if f.endswith("motor_type"):
            ctl[f] = rng.integers(0, 2, shape).astype(np.int32)
        elif f.startswith(("hinge_max", "ct_swing_max", "ct_twist_max",
                           "slider_max")):
            ctl[f] = rng.choice([0.0, 60.0], shape, p=[0.35, 0.65])
        elif f == "ct_swing_axis_angle":
            ctl[f] = rng.uniform(-np.pi, np.pi, shape)
        else:
            ctl[f] = rng.uniform(-1.2, 1.2, shape)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return dict(pos=f32(pos), rot=f32(rot), lin_vel=f32(lin),
                ang_vel=f32(ang), force_acc=f32(init.force_acc.numpy()),
                torque_acc=f32(init.torque_acc.numpy()),
                controls={k: (np.ascontiguousarray(v) if v.dtype == np.int32
                              else f32(v)) for k, v in ctl.items()})


def _jax_state(jscene, fields, e):
    """Env `e` of numpy state fields as an unbatched JAX State."""
    st = jscene.initial_state()
    ctl = st.controls.replace(**{k: jnp.asarray(v[e])
                                 for k, v in fields["controls"].items()})
    return st.replace(controls=ctl, **{k: jnp.asarray(fields[k][e])
                                       for k in FIELDS})


# ---------------------------------------------------------------------------
# (a) the six joint preps and pack_joint_type


@functools.lru_cache(maxsize=None)
def packed_tables(name, seed):
    """{joint type: (port table, JAX table)}: each type's prep of the
    integrated bodies of moved_state, packed by pack_joint_type; the JAX
    preps run compiled, vmapped over the envs."""
    jscene, tscene = scenes(name)
    fields = moved_state(name, BP, seed)
    dt32 = np.float32(DT)
    tst = state_from_numpy(fields, device="cpu")
    bodies = integrate_forces(tscene, tst, float(dt32))
    preps = prep_joints(tscene, bodies, tst.controls, dt32)
    jst = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_jax_state(jscene, fields, e)
                                     for e in range(BP)])
    jdt = jnp.float32(DT)
    # compiled: a few times quicker than op by op here, as the JAX package
    # runs these preps inside its compiled step
    jbodies = jax.jit(jax.vmap(
        lambda s: jax_integrate_forces(jscene, s, jdt)))(jst)
    out = {}
    for (name_t, _ab), prep in zip(tbs.scene_joint_ab(tscene), preps):
        joints = getattr(jscene, name_t)
        fn = getattr(jsolver, f"prep_{name_t}")
        if name_t in ("distance", "ball", "fixed"):
            jprep = jax.jit(jax.vmap(lambda b: fn(b, joints, jdt)))(jbodies)
        else:
            jprep = jax.jit(jax.vmap(lambda b, c: fn(b, joints, c, jdt)))(
                jbodies, jst.controls)
        out[name_t] = (tbs.pack_joint_type(name_t, prep).numpy(),
                       np.asarray(jbs.pack_joint_type(name_t, jprep)))
    return out


PREP_CASES = [("constraint_zoo", t) for t in chip_smoke.ZOO_JOINTS] + [
    ("loco", "hinge"), ("loco", "cone_twist"), ("mixed", "ball")]


@pytest.mark.parametrize("name,joint", PREP_CASES,
                         ids=[f"{n}-{j}" for n, j in PREP_CASES])
def test_prep_and_pack_match_jax(name, joint):
    """Every column of the packed table of one joint type within 1e-6 of
    the JAX package's, relative to max(1, the column's largest value): six
    envs of seeded rigid moves and motor controls."""
    got, want = packed_tables(name, 1)[joint]
    assert got.shape == want.shape == (BP, want.shape[1])
    R = tbs.JOINT_SPECS[joint][0]
    assert want.shape[1] % R == 0
    assert _rel_diff(got, want) <= PREP_TOL


def test_moved_zoo_limits_and_motors_live():
    """The moved zoo chain puts each limit past its bound in some env, the
    loco ragdoll's seeded motors are on in some joints, and both packages
    agree on every flag."""
    on = {}
    for name, joint in (("constraint_zoo", "hinge"),
                        ("constraint_zoo", "cone_twist"),
                        ("constraint_zoo", "slider"), ("loco", "hinge"),
                        ("loco", "cone_twist")):
        got, want = packed_tables(name, 1)[joint]
        R = tbs.JOINT_SPECS[joint][0]
        flags = dict(LIMIT_ROWS[joint], motor={"hinge": 41, "slider": 55,
                                               "cone_twist": 56}[joint])
        for key, r in flags.items():
            g = got.reshape(BP, -1, R)[..., r]
            assert np.array_equal(g, want.reshape(BP, -1, R)[..., r])
            on[f"{name}.{joint}.{key}"] = int((g > 0.5).sum())
    assert all(n > 0 for n in on.values()), on


def test_joint_rows_field_major_layout():
    """The wrapper's permute of the packed tables matches the kernel's
    shared-memory layout: per type at its descriptor's row offset, row r
    of joint j at r * J + j."""
    _jscene, tscene = scenes("constraint_zoo")
    tab = fs.fused_tables(tscene, "cpu")
    tables = [torch.from_numpy(packed_tables("constraint_zoo", 1)[n][0])
              for n, _ab in tbs.scene_joint_ab(tscene)]
    flat = fs.joint_rows_field_major(tab, tables, tables[0])
    assert flat.shape == (BP, tab.joint_row_floats)
    desc = np.asarray(tab.joint_desc).reshape(6, fs.DESC_INTS)
    for (name, ab), t in zip(tbs.scene_joint_ab(tscene), tables):
        J, R = len(ab), tbs.JOINT_SPECS[name][0]
        row0 = desc[tbs.JOINT_ORDER.index(name), 1]
        for r in range(R):
            for j in range(J):
                assert torch.equal(flat[:, row0 + r * J + j],
                                   t[:, j * R + r])
    with pytest.raises(ValueError):
        fs.joint_rows_field_major(tab, tables[:-1], tables[0])


# ---------------------------------------------------------------------------
# (b), (c) the fused step, one env, against the JAX package's


def _initial_fields(name, seed):
    """One env of the scene's initial state, with the seeded 0.01 m/s
    velocity noise of chip_smoke's phases."""
    _jscene, tscene = scenes(name)
    st = chip_smoke.shapes_initial_state(tscene, 1, seed)
    f = {k: getattr(st, k).numpy() for k in FIELDS}
    f["controls"] = {k: v.numpy() for k, v in vars(st.controls).items()}
    return f


def _trajectory(name, fields, steps, mode, prep_in_kernel=True):
    """`steps` steps of env 0: the JAX package's eager unbatched step and
    the port's plain version, ITERS iterations, with the StepInfo of both."""
    jscene, tscene = scenes(name)
    jsettings = JaxPhysicsSettings(num_rigid_solver_iterations=ITERS,
                                   solver_mode=mode,
                                   joint_prep_in_kernel=prep_in_kernel)
    tsettings = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                                solver_mode=mode,
                                joint_prep_in_kernel=prep_in_kernel)
    jst = _jax_state(jscene, fields, 0)
    tst = state_from_numpy({k: v[:1] for k, v in fields.items()
                            if k != "controls"}
                           | {"controls": {k: v[:1] for k, v
                                           in fields["controls"].items()}},
                           device="cpu")
    out = []
    for _ in range(steps):
        with jax.disable_jit():
            jst, jinfo = jax_physics_step(jscene, jst, jsettings, DT)
        tst, tinfo = physics_step(tscene, tst, tsettings, DT)
        out.append((jst, jinfo, tst, tinfo))
    return out


TRAJ = {
    # key: (scene, state, steps, solver_mode, joint_prep_in_kernel)
    "mixed": ("mixed", lambda: _initial_fields("mixed", 2), 1, "fused_seq",
              True),
    "double_pendulum": ("double_pendulum",
                        lambda: _initial_fields("double_pendulum", 3), 3,
                        "fused_seq", True),
    "constraint_zoo": ("constraint_zoo",
                       lambda: _initial_fields("constraint_zoo", 4), 1,
                       "fused_seq", True),
    # every limit past its bound and seeded motors: the averaged solve on
    # joint rows prepared outside the kernel
    "constraint_zoo_moved_prepped": ("constraint_zoo",
                                     lambda: moved_state("constraint_zoo",
                                                         1, 4),
                                     1, "fused", False),
}


@functools.lru_cache(maxsize=None)
def trajectory(key):
    """TRAJ[key]'s steps, computed once per process."""
    name, make, steps, mode, jp = TRAJ[key]
    return _trajectory(name, make(), steps, mode, jp)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b[0].numpy()).max())


@pytest.mark.parametrize("key", sorted(TRAJ))
def test_one_step_matches_jax(key):
    """After one step: positions and rotations within 1e-6, velocities and
    the per-row contact impulses within 1e-5, the live contact rows equal.
    The moved zoo chain's bodies are thrown at up to 2 rad/s with their
    joints pulled apart, and its velocities reach ~10: they are held within
    1e-5 of max(1, the largest velocity)."""
    jst, jinfo, tst, tinfo = trajectory(key)[0]
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    for k in ("lin_vel", "ang_vel"):
        scale = 1.0
        if key.endswith("_moved_prepped"):
            scale = max(1.0, float(np.abs(np.asarray(getattr(jst, k))).max()))
        assert _diff(getattr(jst, k), getattr(tst, k)) <= 1e-5 * scale, k
    assert np.array_equal(np.asarray(jinfo.contact_mask),
                          tinfo.contact_mask[0].numpy())
    assert _diff(jinfo.contact_impulse, tinfo.contact_impulse) <= 1e-5
    if key == "mixed":
        assert bool(tinfo.contact_mask.any())          # the sequential
        assert float(tinfo.contact_impulse.max()) > 1.0  # contact solve ran
    assert bool(torch.isfinite(tst.ang_vel).all())


def test_three_steps_match_jax_double_pendulum():
    """The double pendulum, 1e-4 on every state field after each of three
    steps."""
    out = trajectory("double_pendulum")
    assert len(out) == 3
    for jst, _ji, tst, _ti in out:
        for k in ("pos", "rot", "lin_vel", "ang_vel"):
            assert _diff(getattr(jst, k), getattr(tst, k)) <= 1e-4, k


def test_solver_options_all_run():
    """make_fused_step_solver takes all four combinations of `sequential`
    and `joint_prep_in_kernel`, as the JAX package's does. On the moved
    loco ragdoll (six hinges and seven cone-twists sharing bodies) the
    sequential and averaged solves part ways, and each solve gives the same
    velocities within 1e-5 of the largest one (up to ~170 rad/s for the
    light limbs thrown here) from the joint rows of the in-kernel prep's
    plain version (cm_joint_prep) and from ops/solver.py's preps (the two
    preps round differently)."""
    _jscene, tscene = scenes("loco")
    st = state_from_numpy(moved_state("loco", 2, 5), device="cpu")
    dt32 = np.float32(DT)
    bodies = integrate_forces(tscene, st, float(dt32))
    wcol = world_colliders(tscene, st.pos, st.rot)
    inv_dt = float(np.float32(1.0) / dt32)
    res = {}
    for seq in (False, True):
        for jp in (False, True):
            fused = fs.make_fused_step_solver(tscene, ITERS, sequential=seq,
                                              joint_prep_in_kernel=jp)
            res[seq, jp] = fused(bodies, wcol, joint_inputs(
                tscene, bodies, st.controls, dt32, jp), inv_dt)
    for seq in (False, True):
        for a, b in zip(res[seq, False][:2], res[seq, True][:2]):
            scale = max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= 1e-5 * scale
    assert float((res[True, False][0] - res[False, False][0]).abs().max()) \
        > 1e-3


# ---------------------------------------------------------------------------
# (d) the loco env in fused_seq mode


def test_loco_env_fused_seq_scene_and_routing():
    """LocoEnv(solver_mode="fused_seq") builds the same Scene as "fused"
    (uncapped tables, the fused step takes it), and its physics step is the
    port's own physics_step in "fused_seq" mode, which differs from the
    averaged step."""
    env = LocoEnv(solver_mode="fused_seq", solver_iterations=ITERS,
                  enable_pokes=False, device="cpu")
    ref = LocoEnv(solver_mode="fused", solver_iterations=ITERS,
                  enable_pokes=False, device="cpu")
    a, b = scene_arrays(env.scene), scene_arrays(ref.scene)
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert fs.fused2_eligible(env.scene)
    assert env.settings.solver_mode == "fused_seq"
    gen = torch.Generator().manual_seed(0)
    st, _obs = env.reset(2)
    act = torch.rand((2, 27), generator=gen) * 2 - 1
    nxt, _obs, _r, done = env.step(st, act, gen)
    assert not bool(done.any())
    # the env's physics step redone from its inputs: the controls the
    # action set, stepped by physics_step in each mode
    phys = st.physics.replace(controls=nxt.physics.controls)
    seq = physics_step(env.scene, phys, env.settings, LOCO_DT)[0]
    avg = physics_step(env.scene, phys, ref.settings, LOCO_DT)[0]
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        assert torch.equal(getattr(nxt.physics, k), getattr(seq, k)), k
    assert float((seq.ang_vel - avg.ang_vel).abs().max()) > 0.0


def test_loco_env_unported_modes_raise():
    """Every LocoEnv mode is ported now (the test keeps its name):
    LocoEnv(solver_mode="colored") builds the JAX package's capped tables
    (48 slots a group), and its physics step matches the JAX package's
    compiled "colored" step on one env of the moved loco state, 3
    iterations (positions within 1e-6, velocities within 1e-5 of max(1,
    their largest))."""
    env = LocoEnv(solver_mode="colored", solver_iterations=ITERS,
                  enable_pokes=False, device="cpu")
    jenv = JaxLocoEnv(solver_mode="colored", solver_iterations=ITERS,
                      enable_pokes=False)
    assert [g.max_narrow for g in env.scene.pair_groups] == [
        g.max_narrow for g in jenv.scene.pair_groups] == [48, 45, 3]
    fields = moved_state("loco", 1, 13)
    tst = state_from_numpy(fields, "cpu")
    tout = physics_step(env.scene, tst, env.settings, LOCO_DT)[0]
    jout = jax.jit(lambda s: jax_physics_step(
        jenv.scene, s, jenv.settings, LOCO_DT)[0])(
            _jax_state(jenv.scene, fields, 0))
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        want = np.asarray(getattr(jout, k))
        tol = 1e-6 if k in ("pos", "rot") else 1e-5 * max(
            1.0, float(np.abs(want).max()))
        assert np.abs(getattr(tout, k)[0].numpy() - want).max() <= tol, k
