"""Port parity, module physics.py (the reference, non-fused step) with
scene/builder.py, ops/broadphase.py, the three broadphase kernels' plain
versions, ops/narrowphase.py and ops/solver.py: a small box stack (2 towers
of 4 boxes on a ground box, batch 2, 10 solver iterations, "jacobi") built
with each of broadphase="table" / "kselect" / "sap", stepped by the port's
plain path and by the JAX package (interpret-mode Pallas on the CPU).

One step: positions and rotations within 1e-6, velocities within 1e-5,
StepInfo counts, masks and pairs equal. Five steps: states within 1e-4.
Tolerances: the two packages run the same float32 operations, but sum
per-body deltas in another order (index_add_ vs one-hot matmuls) and
gather with one-hot matmuls on the JAX side.

One JAX compile per broadphase mode: the jitted, vmapped step is kept in
`jax_stepper` for both tests of that mode."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.physics import PhysicsSettings as JaxSettings
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

B = 2
ITERS = 10
DT = 1.0 / 120.0
MODES = ("table", "kselect", "sap")
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


def box_towers(builder, towers=2, per_tower=4):
    """bench.py's box stack at a small size: towers of unit boxes 1.001
    apart on a 200 x 2 x 200 ground box."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (200, 1, 200))
    side = int(np.ceil(np.sqrt(towers)))
    for t in range(towers):
        x, z = (t % side) * 3.0, (t // side) * 3.0
        for i in range(per_tower):
            body = b.add_body(position=(x, 0.5 + 1.001 * i, z))
            b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


def finalize_kw(mode):
    """bench.py's box-stack options, with the cap cut to the small scene so
    the table groups are compacted."""
    return dict(max_narrow_pairs_per_group=4, contact_phases=4,
                broadphase=mode, broadphase_k=8)


@functools.lru_cache(maxsize=None)
def jax_stepper(mode):
    scene = box_towers(JaxSceneBuilder).finalize(**finalize_kw(mode))
    settings = JaxSettings(num_rigid_solver_iterations=ITERS,
                           solver_mode="jacobi")
    step = jax.jit(jax.vmap(
        lambda s: jax_physics_step(scene, s, settings, DT)))
    return scene, step


def initial_fields(scene):
    """B perturbed stacks as numpy: boxes pressed into each other and the
    ground by a few mm, slightly tilted, moving."""
    rng = np.random.default_rng(0)
    pos = np.asarray(scene.init_pos)
    out = {k: np.zeros((B,) + pos.shape) for k in FIELDS}
    out["pos"][:] = pos
    out["rot"] = np.broadcast_to(np.asarray(scene.init_rot),
                                 (B,) + pos.shape[:1] + (4,)).copy()
    nb = out["pos"].shape[1] - 1           # dummy last; body 0 the ground
    level = (np.arange(nb) - 1) % 4
    out["pos"][:, 1:nb, 1] -= 0.003 * (level[1:] + 1)
    out["pos"][:, 1:nb, 0] += rng.normal(0, 0.02, (B, nb - 1))
    out["pos"][:, 1:nb, 2] += rng.normal(0, 0.02, (B, nb - 1))
    tilt = rng.normal(0, 0.002, (B, nb - 1, 3))
    q = np.concatenate([tilt, np.ones((B, nb - 1, 1))], -1)
    out["rot"][:, 1:nb] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    out["lin_vel"][:, 1:nb] = rng.normal(0, 0.2, (B, nb - 1, 3))
    out["ang_vel"][:, 1:nb] = rng.normal(0, 0.2, (B, nb - 1, 3))
    return {k: v.astype(np.float32) for k, v in out.items()}


def run_both(mode, steps):
    jscene, jstep = jax_stepper(mode)
    tscene = box_towers(SceneBuilder).finalize(device="cpu",
                                               **finalize_kw(mode))
    fields = initial_fields(jscene)
    jst = jscene.initial_state().replace(
        controls=None, **{k: jnp.asarray(v) for k, v in fields.items()})
    tst = state_from_numpy(fields, "cpu")
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                               solver_mode="jacobi")
    for _ in range(steps):
        jst, jinfo = jstep(jst)
        tst, tinfo = physics_step(tscene, tst, settings, DT)
    return jst, jinfo, tst, tinfo


def max_err(jst, tst, name):
    return float(np.abs(np.asarray(getattr(jst, name))
                        - getattr(tst, name).numpy()).max())


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(mode):
    jst, jinfo, tst, tinfo = run_both(mode, 1)
    assert max_err(jst, tst, "pos") <= 1e-6
    assert max_err(jst, tst, "rot") <= 1e-6
    assert max_err(jst, tst, "lin_vel") <= 1e-5
    assert max_err(jst, tst, "ang_vel") <= 1e-5
    for name in ("num_broadphase_overlaps", "num_contacts",
                 "broadphase_overflow", "contact_mask", "contact_pairs"):
        assert np.array_equal(getattr(tinfo, name).numpy(),
                              np.asarray(getattr(jinfo, name))), name
    imp = np.asarray(jinfo.contact_impulse)
    assert np.abs(tinfo.contact_impulse.numpy() - imp).max() \
        <= 1e-5 * max(1.0, np.abs(imp).max())
    # the stacks are in contact: every env has live box-box and ground rows
    assert (np.asarray(jinfo.num_contacts) >= 16).all()


@pytest.mark.parametrize("mode", MODES)
def test_five_steps_match_jax(mode):
    jst, _jinfo, tst, _tinfo = run_both(mode, 5)
    for name in ("pos", "rot", "lin_vel", "ang_vel"):
        assert max_err(jst, tst, name) <= 1e-4, name
    assert torch.isfinite(tst.pos).all()


def test_fused_mode_falls_back_to_jacobi():
    """"fused" on a scene the fused kernel does not take (a dynamic
    broadphase) runs the reference step in "jacobi" mode, as in the JAX
    package."""
    scene = box_towers(SceneBuilder).finalize(device="cpu",
                                              **finalize_kw("kselect"))
    st = state_from_numpy(initial_fields(scene), "cpu")
    out = [physics_step(scene, st, PhysicsSettings(
        num_rigid_solver_iterations=ITERS, solver_mode=m), DT)[0]
        for m in ("fused", "jacobi")]
    for name in FIELDS:
        assert torch.equal(getattr(out[0], name), getattr(out[1], name))


@pytest.mark.parametrize("solver_mode", ["scan", "fused_seq"])
def test_unported_reference_modes_raise(solver_mode):
    """Both modes are ported now (the test keeps its name). On the box
    towers with the sort-and-sweep broadphase, which the fused step does
    not take, "fused_seq" runs "scan" (equal states), and one "scan" step
    matches the JAX package's: positions and rotations within 1e-6,
    velocities within 1e-5, the live contact rows equal."""
    scene = box_towers(SceneBuilder).finalize(device="cpu",
                                              **finalize_kw("sap"))
    fields = initial_fields(scene)
    st = state_from_numpy(fields, "cpu")

    def step(mode):
        return physics_step(scene, st, PhysicsSettings(
            num_rigid_solver_iterations=ITERS, solver_mode=mode), DT)
    tst, tinfo = step(solver_mode)
    if solver_mode == "fused_seq":
        ref = step("scan")[0]
        for name in FIELDS:
            assert torch.equal(getattr(tst, name), getattr(ref, name))
        return
    jscene = box_towers(JaxSceneBuilder).finalize(**finalize_kw("sap"))
    settings = JaxSettings(num_rigid_solver_iterations=ITERS,
                           solver_mode="scan")
    jst = jscene.initial_state().replace(
        controls=None, **{k: jnp.asarray(v) for k, v in fields.items()})
    jst, jinfo = jax.jit(jax.vmap(
        lambda s: jax_physics_step(jscene, s, settings, DT)))(jst)
    assert max_err(jst, tst, "pos") <= 1e-6
    assert max_err(jst, tst, "rot") <= 1e-6
    assert max_err(jst, tst, "lin_vel") <= 1e-5
    assert max_err(jst, tst, "ang_vel") <= 1e-5
    assert np.array_equal(tinfo.contact_mask.numpy(),
                          np.asarray(jinfo.contact_mask))
    assert (np.asarray(jinfo.num_contacts) >= 16).all()
