"""Port parity, models/vehicle.py and SceneBuilder.finalize(orbit_margin=...)
(BASELINE config 4, bench.py:354-396):

  - config 4's Scene (chip_smoke.config4_builder: the terrain, the
    vehicle, the sheet; the motor hinge driven as bench.py drives it)
    against the JAX package's, unpruned and with orbit_margin=0.5: body
    parameters, colliders, the 17 joints, the controls and the pair groups
    row for row (2,591 and 1,079 rows), ints exactly, floats to 1e-7; the
    vehicle's parts and hinge indices; its scene file written by either
    package and finalized by the other;
  - mirrors of tests/test_orbit_prune.py's three fast tests (the budget
    test asserts more than FUSED_BUDGET_ROWS rows unpruned and at most that
    pruned, where the JAX package warns and leaves its kernel: the port has
    no row cap, and both scenes' launch plans fit a block);
  - tests/test_vehicle.py's vehicle on a ground box, orbit-pruned (1,157
    rows), motor driven: STEPS "jacobi" steps against the compiled JAX
    step (the suite's XLA flags, fusion off), positions within 1e-5 and
    velocities within 1e-3 of max(1, the largest value): the gear train
    grows rounding differences by ~1e-4 of the angular velocities over the
    horizon;
  - slow: one fused step of that scene against the JAX step run op by op
    under jax.disable_jit() (83 s on the JAX side; never jitted: its
    compile did not finish in 150 s), within 1e-6 of scale; mirrors of
    tests/test_vehicle.py::test_drop_and_drive and of
    tests/test_orbit_prune.py::test_vehicle_trajectory_unchanged_by_orbit_prune
    on the port.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.models.vehicle import add_vehicle as jax_add_vehicle
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.models import add_vehicle
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import scene_arrays
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1 / 120
FUSED_BUDGET_ROWS = 1600         # the JAX package's FUSED_MAX_PAIR_ROWS
ROWS = {None: {(1, 1): 2232, (1, 2): 276, (1, 3): 73, (2, 2): 6, (2, 3): 4},
        0.5: {(1, 1): 888, (1, 2): 138, (1, 3): 48, (2, 2): 1, (2, 3): 4}}
STEPS = 60
TOL_POS = 1e-5
TOL_VEL = 1e-3
FUSED_TOL = 1e-6
BODY_FIELDS = ("pos", "rot", "lin_vel", "ang_vel")
COMPARED = ("num_bodies", "body_params", "colliders", "pair_groups",
            "distance", "ball", "fixed", "hinge", "cone_twist", "slider",
            "default_controls", "overlap", "global_ff", "ff_forces",
            "init_pos", "init_rot", "cloth")


def _jax_with_motor(scene, veh):
    c = scene.default_controls
    return scene.replace(default_controls=c.replace(**{
        name: getattr(c, name).at[veh.motor_hinge].set(value)
        for name, value in chip_smoke.CONFIG4_MOTOR.items()}))


def _kw(margin):
    return {} if margin is None else dict(orbit_margin=margin)


def _hold_scenes(tscene, jscene):
    want = {}
    _flatten_jax("", jscene, want)
    want = {k: v for k, v in want.items() if k.startswith(COMPARED)}
    got = {k: v for k, v in scene_arrays(tscene).items()
           if k.startswith(COMPARED)}
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(
                initial=0.0) <= 1e-7, name
        else:
            assert np.array_equal(g, w), name


@pytest.mark.parametrize("margin", [None, 0.5])
def test_config4_scene_matches_jax(margin):
    jb, jveh = chip_smoke.config4_builder(JaxSceneBuilder, jax_add_vehicle)
    jscene = _jax_with_motor(jb.finalize(**_kw(margin)), jveh)
    tscene, tveh = chip_smoke.config4_scene("cpu", margin)
    _hold_scenes(tscene, jscene)
    counts = {(g.type_a, g.type_b): int(g.pairs.shape[0])
              for g in tscene.pair_groups}
    assert counts == ROWS[margin]
    assert sum(counts.values()) == (2591 if margin is None else 1079)
    assert tveh.parts == jveh.parts
    assert (tveh.motor_hinge, tveh.steering_hinge) == (0, 2) == (
        jveh.motor_hinge, jveh.steering_hinge)
    assert tscene.num_bodies == 16
    assert sorted(tscene.colliders.ctype.tolist()) == [1] * 73 + [2] * 4 + [3]
    assert {n: int(getattr(tscene, n).body_a.shape[0])
            for n in tscene.joint_types} == dict(ball=4, fixed=1, hinge=11,
                                                 slider=1)


def test_colliderless_bodies_get_unit_mass():
    """The rods, the suspensions and the steering wheel have no collider:
    mass 1 and identity inertia, as the reference's constructor gives them
    (and the JAX package's builder)."""
    tscene, veh = chip_smoke.config4_scene("cpu", None)
    bp = tscene.body_params
    for name in ("front_axis", "steering_wheel", "left_suspension",
                 "right_suspension", "left_wheel_arm", "right_wheel_arm"):
        i = veh.parts[name]
        assert float(bp.inv_mass[i]) == 1.0, name
        assert torch.equal(bp.inv_inertia[i], torch.eye(3)), name
        assert not bool((tscene.colliders.body == i).any()), name


# ---------------------------------------------------------------------------
# mirrors of tests/test_orbit_prune.py


def _rotor(finalize_kw):
    b = SceneBuilder()
    rotor = b.add_body(position=(0.0, 5.0, 0.0))
    b.add_sphere_collider(rotor, (0.0, 0.0, 0.0), 0.3, density=5000.0)
    b.add_sphere_collider(rotor, (-1.0, 0.0, 0.0), 0.1, density=1.0)
    near = b.add_body(position=(1.2, 5.0, 0.0))
    b.add_sphere_collider(near, (0.0, 0.0, 0.0), 0.1)
    far = b.add_body(position=(4.0, 5.0, 0.0))
    b.add_sphere_collider(far, (0.0, 0.0, 0.0), 0.1)
    scene = b.finalize(device="cpu", **finalize_kw)
    return {tuple(p) for g in scene.pair_groups for p in g.pairs.tolist()}


def test_orbit_keeps_sweepable_pair_that_center_prune_drops():
    """A rotor's arm tip can sweep into the near sphere (kept) but never
    reaches the far one (pruned); the initial-centre prune at the same
    margin drops the tip-near pair."""
    kept = _rotor(dict(orbit_margin=0.1))
    assert (1, 2) in kept or (2, 1) in kept
    assert not ({(1, 3), (3, 1)} & kept)
    kept2 = _rotor(dict(candidate_margin=0.1))
    assert not ({(1, 2), (2, 1)} & kept2)


def test_statics_use_plain_bounding_sphere():
    b = SceneBuilder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    s = b.add_body(position=(0.0, 2.0, 0.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.5)
    scene = b.finalize(orbit_margin=0.5, device="cpu")
    assert sum(g2.pairs.shape[0] for g2 in scene.pair_groups) == 1


def test_vehicle_scene_under_fused_budget():
    """Config 4 orbit-pruned is fused-eligible within the JAX package's row
    budget; unpruned it has more rows than that budget (the JAX package
    warns and runs "jacobi" there; the port has no row cap and runs the
    kernel, ROADMAP Queue C 1): both launch plans fit a block."""
    pruned, _ = chip_smoke.config4_scene("cpu", 0.5)
    unpruned, _ = chip_smoke.config4_scene("cpu", None)
    n_pruned = sum(g.pairs.shape[0] for g in pruned.pair_groups)
    n_unpruned = sum(g.pairs.shape[0] for g in unpruned.pair_groups)
    assert n_pruned <= FUSED_BUDGET_ROWS < n_unpruned
    for scene in (pruned, unpruned):
        assert fs.fused2_eligible(scene)
        plan = fs.FusedTables(scene, "cpu").launch_plan(4096)
        assert plan.smem_bytes <= fs.BLOCK_SHARED


# ---------------------------------------------------------------------------
# the vehicle on a ground box (tests/test_vehicle.py's scene), orbit-pruned


def _ground_vehicle(builder, add):
    b = builder()
    ground = b.add_static(position=(0, -4.0, 0))
    b.add_box_collider(ground, (0, 0, 0), (50, 4, 50), friction=1.0)
    return b, add(b, initial_position=(0.0, 1.1, 0.0))


def _ground_scenes(**kw):
    jb, jveh = _ground_vehicle(JaxSceneBuilder, jax_add_vehicle)
    tb, tveh = _ground_vehicle(SceneBuilder, add_vehicle)
    return (_jax_with_motor(jb.finalize(**kw), jveh),
            chip_smoke.with_motor(tb.finalize(device="cpu", **kw), tveh),
            tveh)


def _hold(jst, tst, tol_pos, tol_vel):
    for k in BODY_FIELDS:
        want = np.asarray(getattr(jst, k))
        got = getattr(tst, k)[0].numpy()
        tol = tol_vel if "vel" in k else tol_pos
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (k, err, scale)


def test_vehicle_jacobi_matches_jax():
    jscene, tscene, _veh = _ground_scenes(orbit_margin=0.5)
    assert sum(g.pairs.shape[0] for g in tscene.pair_groups) == 1157
    kw = dict(solver_mode="jacobi", num_rigid_solver_iterations=30)
    step = jax.jit(lambda s: jax_physics_step(
        jscene, s, JaxPhysicsSettings(**kw), DT)[0])
    jst, tst = jscene.initial_state(), tscene.initial_state(1)
    for _ in range(STEPS):
        jst = step(jst)
        tst = physics_step(tscene, tst, PhysicsSettings(**kw), DT)[0]
    _hold(jst, tst, TOL_POS, TOL_VEL)
    # the wheels reached the ground and the motor gear turns
    assert float(tst.ang_vel[0, 2].abs().max()) > 0.05


@pytest.mark.slow
def test_vehicle_fused_step_matches_eager_jax():
    jscene, tscene, _veh = _ground_scenes(orbit_margin=0.5)
    kw = dict(solver_mode="fused", num_rigid_solver_iterations=30)
    with jax.disable_jit():
        jst = jax_physics_step(jscene, jscene.initial_state(),
                               JaxPhysicsSettings(**kw), DT)[0]
    tst = physics_step(tscene, tscene.initial_state(1),
                       PhysicsSettings(**kw), DT)[0]
    _hold(jst, tst, FUSED_TOL, FUSED_TOL)


@pytest.mark.slow
def test_drop_and_drive():
    """tests/test_vehicle.py::test_drop_and_drive on the port: 180 "scan"
    steps of the driven vehicle on the ground box (capped tables, 96 rows a
    group): finite, within 5 m of the motor, above y = -1, the motor gear
    turning."""
    b, veh = _ground_vehicle(SceneBuilder, add_vehicle)
    scene = chip_smoke.with_motor(
        b.finalize(max_narrow_pairs_per_group=96, device="cpu"), veh)
    settings = PhysicsSettings(num_rigid_solver_iterations=30)
    st = scene.initial_state(1)
    for _ in range(180):
        st = physics_step(scene, st, settings, DT)[0]
    ids = sorted(veh.parts.values())
    pos, vel = st.pos[0, ids], st.lin_vel[0, ids]
    assert bool(torch.isfinite(pos).all() and torch.isfinite(vel).all())
    motor = veh.parts["motor"]
    spread = torch.linalg.vector_norm(pos - st.pos[0, motor], dim=-1)
    assert bool((spread < 5.0).all()), float(spread.max())
    assert bool((pos[:, 1] > -1.0).all())
    assert abs(float(st.ang_vel[0, veh.parts["motor_gear"], 1])) > 0.05


@pytest.mark.slow
def test_vehicle_trajectory_unchanged_by_orbit_prune():
    """240 "scan" steps of config 4's driven vehicle on the terrain, with
    its sheet, with and without orbit_margin: bit-identical positions and
    rotations."""
    settings = PhysicsSettings(num_rigid_solver_iterations=30,
                               solver_mode="scan")
    outs = []
    for margin in (None, 0.5):
        scene, _veh = chip_smoke.config4_scene("cpu", margin)
        st = scene.initial_state(1)
        for _ in range(240):
            st = physics_step(scene, st, settings, DT)[0]
        outs.append((st.pos, st.rot))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_vehicle_scene_files(tmp_path):
    """Config 4's builder round-trips through scene JSON: builder_to_dict
    equals the JAX package's, and a file written by either package
    finalizes (orbit-pruned) in the other to the same Scene."""
    import json

    from dxk_tpu.scene import serialization as jser
    from dxk_tpu_torch.scene import serialization as tser
    tb, _ = chip_smoke.config4_builder(SceneBuilder, add_vehicle)
    jb, _ = chip_smoke.config4_builder(JaxSceneBuilder, jax_add_vehicle)
    as_json = lambda d: json.loads(json.dumps(d))
    assert as_json(tser.builder_to_dict(tb)) == as_json(
        jser.builder_to_dict(jb))
    path = str(tmp_path / "scene.json")
    tser.save_scene(path, tb)
    _hold_scenes(tb.finalize(device="cpu", orbit_margin=0.5),
                 jser.load_scene(path).finalize(orbit_margin=0.5))
    jser.save_scene(path, jb)
    _hold_scenes(tser.load_scene(path).finalize(device="cpu",
                                                orbit_margin=0.5),
                 jb.finalize(orbit_margin=0.5))
