"""Port parity, cloth in physics.py's step: the port's mirrors of the seven
tests of tests/test_cloth.py (the JAX package's cloth tests, at their sizes
and horizons, on the port's default PhysicsSettings: "scan" cloth), and
whole steps against the JAX package's physics_step:

  - the reference branch (solver_mode "jacobi") in both cloth modes with
    velocity, position and drift iterations and two-way coupling, over 60
    steps of a sphere dropped under a thick sheet in the wind, against the
    compiled JAX step; XLA:CPU contracts multiply-adds there, so values are
    held relative to max(1, the largest value), TOL_POS for positions and
    TOL_VEL for velocities (a velocity is (pos - prev) / dt: 120 times a
    position's rounding, over 60 steps);
  - the fused branch at one env against the JAX step run op by op under
    jax.disable_jit(), bit for bit, over 3 steps of a sphere on a ground
    box under a thick sheet with two-way coupling, "colored" cloth (and,
    marked slow, "scan" cloth);
  - chip_smoke's cloth scene on the fused branch: tests/test_torch_cloth.py.

Inputs come from the scenes' builders and a numpy seed."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import state_from_numpy

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1 / 120
TOL_POS = 2e-4
TOL_VEL = 2e-3
CLOTH_FIELDS = ("positions", "prev_positions", "velocities")
BODY_FIELDS = ("pos", "rot", "lin_vel", "ang_vel")


def _run(scene, steps, settings=None, batch=1):
    settings = settings or PhysicsSettings()
    state = scene.initial_state(batch)
    for _ in range(steps):
        state = physics_step(scene, state, settings, DT)[0]
    return state


# ---------------------------------------------------------------------------
# mirrors of tests/test_cloth.py


def build(gx=8, gy=8, **kw):
    b = SceneBuilder()
    b.add_cloth(width=2.0, height=2.0, grid_x=gx, grid_y=gy, total_mass=1.0,
                transform_pos=(0, 3, 0), **kw)
    return b.finalize(device="cpu")


class TestCloth:
    def test_hangs_from_pinned_row(self):
        scene = build()
        top_before = scene.initial_state(1).cloth.positions[0, :8].numpy()
        p = _run(scene, 240).cloth.positions[0].numpy()
        assert np.all(np.isfinite(p))
        # top row pinned exactly
        assert np.allclose(p[:8], top_before, atol=1e-6)
        # bottom row fell below the top row
        assert p[-8:, 1].max() < p[:8, 1].min() - 1.0

    def test_constraint_lengths_preserved(self):
        scene = build()
        p = _run(scene, 300).cloth.positions[0].numpy()
        cons = scene.cloth.constraints.numpy()
        rest = scene.cloth.rest_lengths.numpy()
        cur = np.linalg.norm(p[cons[:, 0]] - p[cons[:, 1]], axis=-1)
        assert np.median(np.abs(cur - rest) / np.maximum(rest, 1e-6)) < 0.15

    def test_wind_pushes_sheet(self):
        b = SceneBuilder()
        b.add_cloth(width=2.0, height=2.0, grid_x=8, grid_y=8, total_mass=1.0,
                    transform_pos=(0, 3, 0))
        b.add_force_field((0.0, 0.0, 30.0))   # global wind +z
        p = _run(b.finalize(device="cpu"), 240).cloth.positions[0].numpy()
        # unpinned rows blown toward +z
        assert p[8:, 2].mean() > 0.05


class TestMultiCloth:
    def _single(self, pos, damping):
        b = SceneBuilder()
        b.add_cloth(width=2.0, height=2.0, grid_x=6, grid_y=6,
                    total_mass=1.0, damping=damping, transform_pos=pos)
        return b.finalize(device="cpu")

    def test_two_cloths_match_two_scenes(self):
        b = SceneBuilder()
        i0 = b.add_cloth(width=2.0, height=2.0, grid_x=6, grid_y=6,
                         total_mass=1.0, damping=0.5,
                         transform_pos=(0, 3, 0))
        i1 = b.add_cloth(width=2.0, height=2.0, grid_x=6, grid_y=6,
                         total_mass=1.0, damping=0.9,
                         transform_pos=(5, 4, 0))
        scene = b.finalize(device="cpu")
        assert (i0, i1) == (0, 1)
        assert scene.cloth.grids == ((6, 6, 0), (6, 6, 36))
        s = _run(scene, 60)
        for k, (pos, damping) in enumerate((((0, 3, 0), 0.5),
                                            ((5, 4, 0), 0.9))):
            rs = _run(self._single(pos, damping), 60)
            off = scene.cloth.grids[k][2]
            got = s.cloth.positions[0, off:off + 36].numpy()
            want = rs.cloth.positions[0].numpy()
            assert np.abs(got - want).max() < 1e-5


class TestClothRigidCollision:
    def _scene(self, thickness):
        b = SceneBuilder()
        g = b.add_static(position=(0.0, 1.5, 0.0))
        b.add_sphere_collider(g, (0, 0, 0), 0.8)
        b.add_cloth(width=2.0, height=2.0, grid_x=8, grid_y=8,
                    total_mass=1.0, transform_pos=(0, 3, 0),
                    thickness=thickness)
        return b.finalize(device="cpu")

    def _drape_dmin(self, scene, steps=600):
        """Min distance of any free particle to the sphere centre over the
        whole trajectory."""
        state = scene.initial_state(1)
        c = np.array([0.0, 1.5, 0.0])
        dmin = np.inf
        for i in range(steps):
            state = physics_step(scene, state, PhysicsSettings(), DT)[0]
            if i % 10 == 0:
                p = state.cloth.positions[0].numpy()
                assert np.all(np.isfinite(p))
                d = np.linalg.norm(p[8:] - c, axis=-1)   # top row pinned
                dmin = min(dmin, float(d.min()))
        return dmin

    def test_drapes_on_sphere(self):
        dmin = self._drape_dmin(self._scene(thickness=0.05))
        # nothing ever inside the sphere (+thickness shell, solver tol)
        assert dmin > 0.8 + 0.05 - 0.02

    def test_zero_thickness_passes_through(self):
        dmin = self._drape_dmin(self._scene(thickness=0.0))
        assert dmin < 0.75                # swings straight through


class TestTwoWayCoupling:
    def _scene(self):
        b = SceneBuilder()
        sp = b.add_body(position=(0.0, 1.5, 0.0), gravity_factor=0.0)
        b.add_sphere_collider(sp, (0, 0, 0), 0.8)
        b.add_cloth(width=2.0, height=2.0, grid_x=8, grid_y=8,
                    total_mass=2.0, transform_pos=(0, 3, 0),
                    thickness=0.05)
        return b.finalize(device="cpu")

    def _run(self, two_way, steps=300):
        state = _run(self._scene(), steps,
                     PhysicsSettings(cloth_two_way=two_way))
        assert torch.isfinite(state.pos).all()
        assert torch.isfinite(state.cloth.positions).all()
        return float(state.lin_vel[0, 0].abs().max()), state

    def test_body_feels_cloth(self):
        v_on, _st_on = self._run(True)
        v_off, _ = self._run(False)
        assert v_off == 0.0                  # one-way: untouched
        assert v_on > 1e-4                   # two-way: momentum transferred


# ---------------------------------------------------------------------------
# whole steps against the JAX package's


def drop_builder(builder, ground=True, cloth_size=8):
    """A 0.5 m sphere on a body, resting on a ground box (with `ground`;
    else without gravity), its top touching the shell of a sheet with a
    0.05 m thickness pinned beside it, in a wind that blows the sheet onto
    the sphere."""
    b = builder()
    if ground:
        g = b.add_static()
        b.add_box_collider(g, (0, -0.3, 0), (20, 1, 20))
    sp = b.add_body(position=(0.0, 1.2, 0.0),
                    gravity_factor=1.0 if ground else 0.0)
    b.add_sphere_collider(sp, (0, 0, 0), 0.5)
    b.add_cloth(width=2.0, height=2.0, grid_x=cloth_size,
                grid_y=cloth_size, total_mass=1.0,
                transform_pos=(0.0, 1.75, 1.0), thickness=0.05)
    b.add_force_field((0.0, 0.0, -3.0))
    return b


REF_STEPS = 60
CLOTH_ITERS = dict(num_cloth_velocity_iterations=1,
                   num_cloth_position_iterations=2,
                   num_cloth_drift_iterations=1)


def _hold_states(jst, tst, tol_pos, tol_vel):
    for k in BODY_FIELDS + CLOTH_FIELDS:
        cloth = k in CLOTH_FIELDS
        want = np.asarray(getattr(jst.cloth if cloth else jst, k))
        got = getattr(tst.cloth if cloth else tst, k)[0].numpy()
        tol = tol_vel if "vel" in k else tol_pos
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("mode", ["scan", "colored"])
def test_reference_step_matches_jax(mode):
    """REF_STEPS steps of drop_builder's scene without the ground (the
    sphere moved by nothing but the sheet's two-way push) on the reference
    branch."""
    kw = dict(solver_mode="jacobi", num_rigid_solver_iterations=10,
              cloth_solver_mode=mode, **CLOTH_ITERS)
    jscene = drop_builder(JaxSceneBuilder, ground=False).finalize()
    tscene = drop_builder(SceneBuilder, ground=False).finalize(device="cpu")
    step = jax.jit(lambda s: jax_physics_step(
        jscene, s, JaxPhysicsSettings(**kw), DT)[0])
    jst = jscene.initial_state()
    # the port's state made from the JAX package's arrays
    tst = state_from_numpy(
        {**{k: np.asarray(getattr(jst, k)) for k in BODY_FIELDS + (
            "force_acc", "torque_acc")},
         "cloth": {f.name: np.asarray(getattr(jst.cloth, f.name))
                   for f in dataclasses.fields(jst.cloth)}},
        device="cpu", batch=1)
    for _ in range(REF_STEPS):
        jst = step(jst)
        tst = physics_step(tscene, tst, PhysicsSettings(**kw), DT)[0]
    _hold_states(jst, tst, TOL_POS, TOL_VEL)
    # the sheet reached the sphere and pushed it
    assert float(tst.lin_vel[0, 0].abs().max()) > 1e-3


FUSED_STEPS = 3


def test_fused_step_matches_eager_jax():
    """FUSED_STEPS fused steps of drop_builder's scene with a ground box
    and a 6 x 6 sheet in "colored" cloth, bit for bit ("scan" cloth:
    test_fused_step_matches_eager_jax_scan_cloth, slow; the JAX package's
    eager "scan" runs its lax.scan constraint by constraint)."""
    _fused_steps_vs_eager_jax("colored")


@pytest.mark.slow
def test_fused_step_matches_eager_jax_scan_cloth():
    """The same FUSED_STEPS fused steps in "scan" cloth (the reference's
    sequential sweep, run by the port as dependency levels), bit for bit
    against the JAX package's eager step."""
    _fused_steps_vs_eager_jax("scan")


def _fused_steps_vs_eager_jax(cloth_mode):
    kw = dict(solver_mode="fused", num_rigid_solver_iterations=10,
              cloth_solver_mode=cloth_mode, **CLOTH_ITERS)
    jscene = drop_builder(JaxSceneBuilder, cloth_size=6).finalize()
    tscene = drop_builder(SceneBuilder, cloth_size=6).finalize(device="cpu")
    jst = jscene.initial_state()
    tst = tscene.initial_state(1)
    for _ in range(FUSED_STEPS):
        with jax.disable_jit():
            jst = jax_physics_step(jscene, jst, JaxPhysicsSettings(**kw),
                                   DT)[0]
        tst = physics_step(tscene, tst, PhysicsSettings(**kw), DT)[0]
        _hold_states(jst, tst, 0.0, 0.0)

