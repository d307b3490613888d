"""Port parity, module physics.py (the reference step in "scan", "jacobi"
and "colored" with the ported narrowphase, joint solves and sequential
passes): one step of golden scenes against the JAX package's compiled
step, and the fast goldens on "scan".

One step: sphere_bounce (the sphere lowered onto the ground), box_stack
(its start: the bottom box on the ground) and double_pendulum, each from
the seeded start of chip_smoke.shapes_initial_state, 30 solver
iterations, against the JAX step compiled unbatched. Positions and
rotations within 1e-6, velocities within 1e-5 of max(1, their largest)
(a ragdoll's light limbs spin at tens of rad/s, and the joint preps'
fastmath angles agree with the JAX package's to an ulp), the per-row
contact impulses within 1e-5 of their largest, the contact masks equal.
The other golden scenes are in tests/test_torch_scan_scenes.py,
test_torch_scan_ragdoll.py and test_torch_scan_mixed.py, the terrain in
test_torch_scan_terrain.py (a file each keeps the JAX compiles of a file
near a minute).

Goldens on "scan" (tests/golden/*.npy, recorded by the JAX package's
compiled "scan"): sphere_bounce over 1000 steps and box_stack over its
first 25 (BOX_STACK_REASON), every 25th step within 1e-3, and box_stack
over 50 steps against the JAX package's "scan" within 1e-3;
double_pendulum is in tests/test_torch_scan_goldens.py."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.physics import PhysicsSettings, physics_step

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
FIELDS = ("pos", "rot", "lin_vel", "ang_vel")
MODES = ("scan", "jacobi", "colored")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_EVERY = 25
GOLDEN_TOL = 1e-3
BOX_STACK_STEPS = 25
BOX_STACK_REASON = (
    "the stack is chaotic between compiles of one program (ROADMAP.md "
    "standing note 2): on this CPU the JAX package's own \"scan\", "
    "compiled as the golden recorder compiles it, is 2.1e-4 from the golden "
    "at step 25, and compiled with the scene as an argument 1.06e-3 at step "
    "50, past the golden's 1e-3; the two compiles differ by 9.1e-4 within "
    "50 steps. The port's \"scan\" divides by 1 + dt * damping, as the "
    "JAX source does, and is 7.1e-4 from the golden at 25 and 1.05e-3 at "
    "50; with the product by the reciprocal (the form XLA folds the "
    "division into) it follows the golden bit for bit to step 50 and "
    "leaves it at step 75 (tools/golden_divergence_cpu.py box_stack). The "
    "golden holds the first 25 steps; test_box_stack_follows_jax_scan "
    "holds all 50 against the JAX package's \"scan\"")
JAX_SCAN_STEPS = 50


@functools.lru_cache(maxsize=None)
def golden_scenes(name):
    """(JAX scene, port scene) of a golden scene, both finalized as the
    golden test finalizes them (no arguments)."""
    return (chip_smoke.golden_builder(JaxSceneBuilder, name,
                                      jax_add_ragdoll).finalize(),
            chip_smoke.shapes_scene(name, "cpu"))


def lowered_state(scene, lower, seed=3):
    """One env of the seeded golden start with the dynamic bodies lowered
    by `lower` m (a float for all, or {body: metres})."""
    st = chip_smoke.shapes_initial_state(scene, 1, seed)
    pos = st.pos.clone()
    if isinstance(lower, dict):
        for body, dy in lower.items():
            pos[0, body, 1] -= dy
    else:
        dyn = scene.body_params.inv_mass > 0.0
        pos[0, dyn, 1] -= lower
    return st.replace(pos=pos)


def jax_state(jscene, tstate):
    """Env 0 of a port State as an unbatched JAX State."""
    st = jscene.initial_state()
    fields = {k: jnp.asarray(getattr(tstate, k)[0].numpy())
              for k in FIELDS + ("force_acc", "torque_acc")}
    if tstate.controls is not None:
        ctl = st.controls.replace(**{
            k: jnp.asarray(v[0].numpy())
            for k, v in vars(tstate.controls).items()})
        fields["controls"] = ctl
    return st.replace(**fields)


def jax_step(jscene, jstate, mode, iters, compiled=True):
    """One JAX physics step and its StepInfo: compiled, or op by op under
    jax.disable_jit()."""
    settings = JaxPhysicsSettings(num_rigid_solver_iterations=iters,
                                  solver_mode=mode)
    if compiled:
        return jax.jit(lambda s: jax_physics_step(jscene, s, settings,
                                                  DT))(jstate)
    with jax.disable_jit():
        return jax_physics_step(jscene, jstate, settings, DT)


def assert_step_matches(jout, tout):
    """Positions and rotations within 1e-6, velocities within 1e-5 of
    max(1, their largest), the contact masks and pairs equal and the
    per-row impulses within 1e-5 of their largest (env 0 of the port's
    outputs)."""
    (jst, jinfo), (tst, tinfo) = jout, tout
    for k in FIELDS:
        want = np.asarray(getattr(jst, k))
        tol = 1e-6 if k in ("pos", "rot") else 1e-5 * max(
            1.0, float(np.abs(want).max()))
        diff = np.abs(want - getattr(tst, k)[0].numpy()).max()
        assert diff <= tol, (k, diff)
    assert torch.isfinite(tst.ang_vel).all()
    if jinfo.contact_mask is None:
        assert tinfo.contact_mask is None
        return
    assert np.array_equal(np.asarray(jinfo.contact_mask),
                          tinfo.contact_mask[0].numpy())
    jimp = np.asarray(jinfo.contact_impulse)
    scale = max(1.0, float(np.abs(jimp).max(initial=0.0)))
    assert np.abs(jimp - tinfo.contact_impulse[0].numpy()).max(
        initial=0.0) <= 1e-5 * scale
    assert np.array_equal(np.asarray(jinfo.contact_pairs),
                          tinfo.contact_pairs[0].numpy())


def run_step_case(name, mode, start, iters=30, compiled=True):
    """Step one env of a golden scene in both packages from `start` (a port
    State). Returns (JAX outputs, port outputs)."""
    jscene, tscene = golden_scenes(name)
    jout = jax_step(jscene, jax_state(jscene, start), mode, iters, compiled)
    tout = physics_step(tscene, start, PhysicsSettings(
        num_rigid_solver_iterations=iters, solver_mode=mode), DT)
    return jout, tout


STARTS = {
    # the sphere lowered 1.51 m: resting on the ground with its seeded
    # velocity noise
    "sphere_bounce": lambda s: lowered_state(s, 1.51),
    "box_stack": lambda s: lowered_state(s, 0.0),
    "double_pendulum": lambda s: lowered_state(s, 0.0),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(STARTS))
def test_one_step_matches_jax(name, mode):
    start = STARTS[name](golden_scenes(name)[1])
    jout, tout = run_step_case(name, mode, start)
    assert_step_matches(jout, tout)
    if name != "double_pendulum":          # the contact solve ran
        assert bool(tout[1].contact_mask.any())
        assert float(tout[1].contact_impulse.max()) > 0.0


def golden_deviation(name, steps, mode="scan"):
    """Largest deviation from tests/golden/<name>.npy of the port's
    `mode` rollout of one env from the golden start (every 25th step's
    positions and rotations, dummy body included)."""
    _jscene, tscene = golden_scenes(name)
    gold = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    settings = PhysicsSettings(solver_mode=mode)
    st = tscene.initial_state(1)
    dev = 0.0
    for i in range(steps):
        st, _info = physics_step(tscene, st, settings, DT)
        if i % GOLDEN_EVERY == GOLDEN_EVERY - 1:
            row = np.concatenate([st.pos[0].numpy().ravel(),
                                  st.rot[0].numpy().ravel()])
            dev = max(dev, float(np.abs(row - gold[i // GOLDEN_EVERY]).max()))
    assert torch.isfinite(st.pos).all()
    return dev


@pytest.mark.parametrize("name,steps", [("sphere_bounce", 1000),
                                        ("box_stack", BOX_STACK_STEPS)])
def test_golden_on_scan(name, steps):
    assert golden_deviation(name, steps) <= GOLDEN_TOL


def test_box_stack_follows_jax_scan():
    """box_stack from the golden start over the 50 steps that the golden
    does not hold (BOX_STACK_REASON): every step's positions and
    rotations within 1e-3 of the JAX package's "scan" compiled with the
    scene as an argument, so that no value of the scene is folded into a
    constant and its damping divides as the port's does (5.3e-4 on this
    CPU; the two compiles of the JAX step differ by 9.1e-4)."""
    jscene, tscene = golden_scenes("box_stack")
    jstep = jax.jit(lambda sc, s: jax_physics_step(
        sc, s, JaxPhysicsSettings(solver_mode="scan"), DT)[0])
    settings = PhysicsSettings(solver_mode="scan")
    jst, tst = jscene.initial_state(), tscene.initial_state(1)
    dev = 0.0
    for _ in range(JAX_SCAN_STEPS):
        jst = jstep(jscene, jst)
        tst, _info = physics_step(tscene, tst, settings, DT)
        for k in ("pos", "rot"):
            dev = max(dev, float(np.abs(np.asarray(getattr(jst, k))
                                        - getattr(tst, k)[0].numpy()).max()))
    assert dev <= GOLDEN_TOL, dev
