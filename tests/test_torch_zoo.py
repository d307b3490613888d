"""Port parity for BASELINE config 2, the constraint zoo (bench.py:261-323):
chains of six capsule links, one link per joint type (distance, ball,
fixed, hinge, cone-twist, slider) with limits, hinge position motors and
slider velocity motors, each chain hanging from a kinematic anchor; pair
tables pruned by candidate_margin=3.0. Modules: scene/builder.py (the four
joint types, candidate_margin), ops/kernels/cm_joint_prep.py and
batched_solver.py (their prep and solve), physics.py (controls_pack) and
ops/kernels/fused_step.py (the plain version of the fused step with all six
joint types).

The scene is chip_smoke.py's copy of bench.py's, so the scene the card runs
is the one held against the JAX package here. The JAX side runs one
compiled program per process: jit(vmap(physics_step)) of the 2-chain zoo
in "fused" mode, 10 iterations (interpret-mode Pallas on the CPU, as
tests/test_fused_solver.py runs it); the JAX joint preps and solves are
called eagerly."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.ops.pallas import batched_solver as jbs
from dxk_tpu.ops.pallas import cm_joint_prep as jjp
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.ops.kernels import batched_solver as tbs
from dxk_tpu_torch.ops.kernels import cm_joint_prep as tjp
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.physics import PhysicsSettings, controls_pack, physics_step
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

B = 5                 # envs of the step tests: ragged, no multiple of a block
BJ = 8                # envs of the per-type prep and solve tests
ITERS = 10
DT = 1.0 / 120.0
NEW_TYPES = ("distance", "ball", "fixed", "slider")
# rows of the packed layouts that hold flags (1.0 / 0.0) or signs (+-1.0)
FLAG_ROWS = {"distance": (), "ball": (), "fixed": (), "slider": (51, 54, 55)}


def _jax_zoo(n_chains):
    """bench.py's zoo finalized by the JAX package, with bench's motors."""
    scene = chip_smoke.zoo_builder(JaxSceneBuilder, n_chains).finalize(
        candidate_margin=3.0)
    c = scene.default_controls
    return scene.replace(default_controls=c.replace(**{
        k: jnp.full_like(getattr(c, k), v)
        for k, v in chip_smoke.ZOO_MOTORS.items()}))


@functools.lru_cache(maxsize=None)
def scenes(n_chains):
    return _jax_zoo(n_chains), chip_smoke.zoo_scene(n_chains, device="cpu")


def _rel_diff(got, want):
    """max |got - want| over max(1, max |want|)."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    return float(np.abs(np.asarray(got, np.float64) - want).max(
        initial=0.0)) / scale


# ---------------------------------------------------------------------------
# (a) the scene


def test_scene_arrays_equal_full_width():
    """16 chains: body params, colliders, the one capsule-capsule pair group
    of 192 rows, all six JointsOfType and the motor controls equal the JAX
    package's; ints exactly, floats to 1e-7 (both builders compute in
    float64 numpy and round once to float32)."""
    jscene, tscene = scenes(16)
    want = {}
    _flatten_jax("", jscene, want)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, name
        else:
            assert np.array_equal(g, w), name
    assert [(g.type_a, g.type_b, g.pairs.shape[0], g.phase)
            for g in tscene.pair_groups] == [(1, 1, 192, 0)]
    assert tscene.num_bodies == 112
    for name in chip_smoke.ZOO_JOINTS:
        assert getattr(tscene, name).body_a.shape == (16,), name
    assert fs.fused2_eligible(tscene)


def test_tables_and_launch_geometry_full_width():
    """The fused step's tables for the 16-chain zoo: 96 joints in six
    descriptors; at 4096 envs three one-warp envs a block (24,736 bytes of
    shared memory each, 14,592 of them the joint rows), shared memory of
    one block within the card's 227 KB."""
    _jscene, tscene = scenes(16)
    tab = fs.fused_tables(tscene, "cpu")
    assert tab.joint_counts == {n: 16 for n in chip_smoke.ZOO_JOINTS}
    assert tab.ctl_rows == 16 * (3 + 7 + 3)
    plan = tab.launch_plan(4096)
    assert (plan.envs, plan.warps, plan.threads) == (3, 1, 96)
    assert plan.env_bytes == 24736 and 4 * tab.joint_row_floats == 14592
    assert plan.smem_bytes <= 227 * 1024
    desc = np.asarray(tab.joint_desc).reshape(6, fs.DESC_INTS)
    rows = [tbs.JOINT_SPECS[n][0] for n in tbs.JOINT_ORDER]
    assert desc[:, 0].tolist() == [16] * 6
    assert desc[:, 1].tolist() == list(np.cumsum([0] + rows[:-1]) * 16)
    assert desc[:, 4].tolist() == list(range(0, 96, 16))


# ---------------------------------------------------------------------------
# (b), (c) joint prep and solve per type, random inputs


def _quat_mul(a, b):
    av, aw = a[..., :3], a[..., 3:]
    bv, bw = b[..., :3], b[..., 3:]
    return np.concatenate([av * bw + bv * aw + np.cross(av, bv),
                           aw * bw - (av * bv).sum(-1, keepdims=True)], -1)


def _quat_mat(q):
    x, y, z, w = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _body_lanes(tscene, rng):
    """Random poses around the hanging pose, world inverse inertias and the
    scene's inverse masses (the kinematic anchors' are zero), batch BJ."""
    init = tscene.initial_state(1)
    rot0 = init.rot[0].numpy()
    n1 = rot0.shape[0]
    dq = rng.normal(size=(BJ, n1, 4)) * 0.3
    dq[..., 3] = 1.0
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    rot = _quat_mul(dq, rot0[None])
    pos = init.pos[0].numpy()[None] + rng.normal(size=(BJ, n1, 3)) * 0.3
    R = _quat_mat(rot)
    inv_i = tscene.body_params.inv_inertia.numpy()[None]
    inv_iw = R @ inv_i @ np.swapaxes(R, -1, -2)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return (f32(rot), f32(pos), f32(inv_iw),
            f32(tscene.body_params.inv_mass.numpy()))


def _controls(name, J, rng):
    """Motor controls of one type: both motor types, motors on and off,
    targets inside and outside the slider limits."""
    ctl = {}
    for f in tjp.CTL_FIELDS[name]:
        if f.endswith("motor_type"):
            v = rng.integers(0, 2, (BJ, J))
        elif f.startswith("max"):
            v = rng.choice([0.0, 80.0], (BJ, J), p=[0.3, 0.7])
        else:
            v = rng.uniform(-0.8, 0.8, (BJ, J))
        ctl[f] = np.ascontiguousarray(v, dtype=np.float32)
    return ctl


def _prep_both(name, seed):
    """Packed prep rows of every joint of one type of the 16-chain zoo:
    port (list of (BJ, J)) and JAX (list over joints of lists of (BJ,))."""
    jscene, tscene = scenes(16)
    rng = np.random.default_rng(seed)
    rot, pos, inv_iw, inv_m = _body_lanes(tscene, rng)
    jt = getattr(tscene, name)
    a, b = jt.body_a.numpy(), jt.body_b.numpy()
    J = len(a)
    ctl = _controls(name, J, rng)
    dt = np.float32(DT)
    inv_dt = np.float32(1.0) / dt

    def lanes_t(x, idx, n):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            x[:, idx].reshape(BJ, J, -1)[..., i])) for i in range(n))

    bd_t = dict(qa=lanes_t(rot, a, 4), qb=lanes_t(rot, b, 4),
                pa=lanes_t(pos, a, 3), pb=lanes_t(pos, b, 3),
                ia=lanes_t(inv_iw, a, 9), ib=lanes_t(inv_iw, b, 9),
                inv_ma=torch.from_numpy(inv_m[a]),
                inv_mb=torch.from_numpy(inv_m[b]))
    rows_t = tjp.ROW_BUILDERS[name](
        tjp.static_params(tscene, name, "cpu"),
        {f: torch.from_numpy(v) for f, v in ctl.items()}, bd_t,
        torch.full((BJ, 1), float(dt)), torch.tensor(inv_dt))
    rows_t = [r.expand(BJ, J) for r in rows_t]

    js_all = jjp.static_params(jscene, name)
    rows_j = []
    for j in range(J):
        def lanes_j(x, n, idx):
            return tuple(jnp.asarray(x[:, idx].reshape(BJ, -1)[:, i])
                         for i in range(n))
        bd_j = dict(qa=lanes_j(rot, 4, a[j]), qb=lanes_j(rot, 4, b[j]),
                    pa=lanes_j(pos, 3, a[j]), pb=lanes_j(pos, 3, b[j]),
                    ia=lanes_j(inv_iw, 9, a[j]), ib=lanes_j(inv_iw, 9, b[j]),
                    inv_ma=jnp.full((BJ,), inv_m[a[j]]),
                    inv_mb=jnp.full((BJ,), inv_m[b[j]]))
        rows_j.append(jjp.ROW_BUILDERS[name](
            js_all[j], {f: jnp.asarray(v[:, j]) for f, v in ctl.items()},
            bd_j, jnp.full((BJ,), dt), jnp.float32(inv_dt)))
    return rows_t, rows_j, (inv_iw, inv_m, a, b)


@pytest.mark.parametrize("name", NEW_TYPES)
def test_joint_rows(name):
    """distance_rows / ball_rows / fixed_rows / slider_rows on random poses
    (anchors up to ~0.5 m apart, so slider limits are violated both ways),
    random motors of both types: flags and signs equal, every other row to
    1e-6 relative to the row's scale (bias rows carry 1/dt = 120)."""
    rows_t, rows_j, (_iw, inv_m, a, _b) = _prep_both(name, 3)
    assert len(rows_t) == tbs.joint_rows(name) == jbs.joint_rows(name)
    J = rows_t[0].shape[1]
    flags_seen = set()
    for r, row in enumerate(rows_t):
        got = row.numpy()
        want = np.stack([np.broadcast_to(np.asarray(rows_j[j][r]), (BJ,))
                         for j in range(J)], 1)
        if r in FLAG_ROWS[name]:
            assert np.array_equal(got, want), r
            flags_seen.update((r, v) for v in np.unique(got))
        else:
            assert _rel_diff(got, want) <= 1e-6, r
    # both values of every flag occur: limits on and off (min and max
    # side), motors on and off
    assert len(flags_seen) == 2 * len(FLAG_ROWS[name])
    if name == "distance":              # the anchors are kinematic
        assert float(inv_m[a].max()) == 0.0


@pytest.mark.parametrize("name", NEW_TYPES)
def test_joint_solve_one(name):
    """_distance_one / _ball_one / _fixed_one / _slider_one on the prepared
    rows with random velocities and accumulated impulses: new velocities
    and impulses to 1e-6 relative to their scale."""
    rows_t, _rows_j, (inv_iw, inv_m, a, b) = _prep_both(name, 4)
    rng = np.random.default_rng(5)
    J = len(a)
    n_acc = tbs.JOINT_SPECS[name][3]
    assert n_acc == jbs.JOINT_SPECS[name][6]
    vel = np.float32(rng.normal(size=(4, 3, BJ, J)))
    accs = np.float32(np.abs(rng.normal(size=(n_acc, BJ, J))) * 0.1)
    ia = inv_iw[:, a].reshape(BJ, J, 9)
    ib = inv_iw[:, b].reshape(BJ, J, 9)

    f_t = tbs.JOINT_SPECS[name][1](rows_t)
    out_t = tbs.JOINT_SPECS[name][2](
        f_t, torch.from_numpy(inv_m[a]), torch.from_numpy(inv_m[b]),
        tuple(torch.from_numpy(np.ascontiguousarray(ia[..., i])) for i in range(9)),
        tuple(torch.from_numpy(np.ascontiguousarray(ib[..., i])) for i in range(9)),
        *[tuple(torch.from_numpy(vel[k, c]) for c in range(3)) for k in range(4)],
        *[torch.from_numpy(x) for x in accs])
    assert len(out_t) == 4 + n_acc

    # the JAX reader takes a (J*ROWS, lanes) table: lanes = the BJ envs
    table = jnp.asarray(np.stack([rows_t[r].numpy()[:, j]
                                  for j in range(J)
                                  for r in range(len(rows_t))], 0))
    reader, solve = jbs.JOINT_SPECS[name][4], jbs.JOINT_SPECS[name][5]
    for j in range(J):
        out_j = solve(
            reader(table, j), jnp.float32(inv_m[a[j]]), jnp.float32(inv_m[b[j]]),
            tuple(jnp.asarray(ia[:, j, i]) for i in range(9)),
            tuple(jnp.asarray(ib[:, j, i]) for i in range(9)),
            *[tuple(jnp.asarray(vel[k, c, :, j]) for c in range(3)) for k in range(4)],
            *[jnp.asarray(x[:, j]) for x in accs])
        for k in range(4):
            for c in range(3):
                assert _rel_diff(out_t[k][c].numpy()[:, j],
                                 out_j[k][c]) <= 1e-6, (j, k, c)
        for k in range(n_acc):
            assert _rel_diff(out_t[4 + k].numpy()[:, j],
                             out_j[4 + k]) <= 1e-6, (j, k)


# ---------------------------------------------------------------------------
# (d), (e) the fused step, the whole slice: 2 chains


@pytest.fixture(scope="module")
def zoo_states():
    """B states of the 2-chain zoo as numpy: chip_smoke's limit poses
    (every hinge, swing, twist and slider limit violated in some env by a
    rigid motion about a joint's anchor, the other joints closed) with its
    0.01 m/s velocity noise, plus seeded position and angular-velocity
    noise on the links."""
    _jscene, tscene = scenes(2)
    st = chip_smoke.zoo_limit_state(tscene, B, seed=7)
    rng = np.random.default_rng(7)
    fields = {k: getattr(st, k).numpy().copy()
              for k in ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                        "torque_acc")}
    links = [n for n in range(tscene.num_bodies) if n % 7]
    fields["pos"][:, links] += rng.normal(size=(B, len(links), 3)) * 0.002
    fields["ang_vel"][:, links] += rng.normal(size=(B, len(links), 3)) * 0.05
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["controls"] = {f.name: getattr(st.controls, f.name).numpy()
                          for f in dataclasses.fields(st.controls)}
    return fields


@pytest.fixture(scope="module")
def trajectories(zoo_states):
    """Three steps of the 2-chain zoo from the same states: JAX "fused"
    (one jit(vmap(physics_step)) program) and the port's plain version."""
    jscene, tscene = scenes(2)
    settings = JaxPhysicsSettings(num_rigid_solver_iterations=ITERS,
                                  solver_mode="fused")
    jstep = jax.jit(jax.vmap(
        lambda s: jax_physics_step(jscene, s, settings, DT)[0]))
    base = jscene.initial_state()
    jst = base.replace(
        controls=base.controls.replace(**{
            k: jnp.asarray(v) for k, v in zoo_states["controls"].items()}),
        **{k: jnp.asarray(v) for k, v in zoo_states.items()
           if k != "controls"})
    tst = state_from_numpy(zoo_states, device="cpu")
    tsettings = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                                solver_mode="fused")
    out = []
    for _ in range(3):
        jst = jstep(jst)
        tst, _info = physics_step(tscene, tst, tsettings, DT)
        out.append((jst, tst))
    return out


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def test_states_make_every_joint_path_live(zoo_states):
    """The step tests' states put every limit and motor of the zoo to work:
    the plain version's prep rows show hinge, swing, twist and slider
    limits and the hinge and slider motors on."""
    from dxk_tpu_torch.ops.integrator import integrate_forces
    _jscene, tscene = scenes(2)
    st = state_from_numpy(zoo_states, device="cpu")
    bodies = integrate_forces(tscene, st, float(np.float32(DT)))
    ctl = controls_pack(tscene, st.controls, np.float32(DT))
    tab = fs.fused_tables(tscene, "cpu")
    flags = {"hinge": (40, 41), "cone_twist": (45, 48), "slider": (51, 55)}
    for jt in tab.joint_types:
        rows = fs._joint_rows(tab, jt, bodies.rot, bodies.pos_cog,
                              bodies.inv_inertia, bodies.inv_mass, ctl,
                              torch.tensor(np.float32(1.0) / np.float32(DT)))
        for r in flags.get(jt.name, ()):
            assert bool((rows[r] > 0.5).any()), (jt.name, r)


def test_one_step_matches_jax(trajectories):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations: the same float32 operations on both sides;
    XLA:CPU contracts multiply-adds and sums the per-body deltas through a
    matrix product, PyTorch in list order."""
    jst, tst = trajectories[0]
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-5
    assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-5
    assert bool(torch.isfinite(tst.lin_vel).all())


def test_three_steps_match_jax(trajectories):
    """≤1e-4 after each of three steps on positions, rotations and linear
    velocities; angular velocities of the light links are held to 1e-4
    relative to their scale (rounding differences grow through the
    10-iteration solve, as in test_torch_loco_env.py)."""
    for jst, tst in trajectories:
        assert _diff(jst.pos, tst.pos) <= 1e-4
        assert _diff(jst.rot, tst.rot) <= 1e-4
        assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-4
        w_scale = max(1.0, float(np.abs(np.asarray(jst.ang_vel)).max()))
        assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-4 * w_scale


# ---------------------------------------------------------------------------
# (f) the controls pack


def test_controls_pack_matches_jax_packing():
    """controls_pack on random controls equals the JAX package's packing
    (physics.py:501-510: per joint type in solve order, per joint, the
    type's control fields, dt last) column for column, for a batch."""
    jscene, tscene = scenes(2)
    rng = np.random.default_rng(9)
    ctl = tscene.batched_controls(3)
    rand = {f.name: torch.from_numpy(
        rng.uniform(-2, 2, getattr(ctl, f.name).shape).astype(np.float32))
        for f in dataclasses.fields(ctl)}
    got = controls_pack(tscene, ctl.replace(**rand), np.float32(DT)).numpy()
    for e in range(3):
        want = []
        for name, ab in jbs.scene_joint_ab(jscene):
            for j in range(len(ab)):
                for field in jjp.CTL_FIELDS[name]:
                    want.append(rand[jjp.CTL_ATTRS[name][field]][e, j])
        want.append(np.float32(DT))
        assert np.array_equal(got[e], np.asarray(want, np.float32))
    assert got.shape == (3, 2 * (3 + 7 + 3) + 1)
