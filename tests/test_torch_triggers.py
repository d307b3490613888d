"""Port parity, trigger volumes and localized force fields (the builder's
mark_trigger and add_force_field(owner=...), physics._overlap_interactions
on both step branches, StepInfo.trigger_overlap, and their files):

  - mirrors of tests/test_events.py::test_trigger_enter_leave ("scan",
    240 steps) and ::test_trigger_events_vmapped ("jacobi", 4 envs with
    staggered drop heights, 300 steps) on the port;
  - _overlap_interactions on seeded poses of chip_smoke.overlap_builder's
    scene (a trigger box and a turned force-field cube) against the JAX
    function compiled under vmap: the trigger mask exactly, the force on each body
    within 1e-4 N of forces of 1,500 N;
  - 90 steps of that scene on the reference branch ("jacobi" and "scan")
    against the compiled JAX step: the trigger mask exactly at every step,
    positions within 1e-5 and velocities within 1e-4 of max(1, the largest
    value) (XLA:CPU contracts multiply-adds: the two part by rounding);
  - one fused step with bodies inside the trigger and the field against
    the JAX step run op by op under jax.disable_jit(): the mask exactly,
    the state within 1e-6 of scale (the plain fused step sums a body's
    deltas in another order than the JAX kernel);
  - the scene's file: builder_to_dict equal to the JAX package's, and a
    file written by either package loaded by the other to the same scene.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu import physics as jphys
from dxk_tpu.ops.shapes import collider_aabbs as jax_collider_aabbs
from dxk_tpu.ops.shapes import world_colliders as jax_world_colliders
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene import serialization as jser
from dxk_tpu_torch import physics as tphys
from dxk_tpu_torch.events import trigger_events
from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene import serialization as tser
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_serialization import _assert_scenes_equal

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1 / 120
FORCE_TOL = 1e-4
STEPS = 90
TOL_POS = 1e-5
TOL_VEL = 1e-4
FUSED_TOL = 1e-6
BODY_FIELDS = ("pos", "rot", "lin_vel", "ang_vel")
STATE_FIELDS = BODY_FIELDS + ("force_acc", "torque_acc")


def _trigger_scene():
    """tests/test_events.py's trigger scene: a sphere dropped through a
    static trigger box onto a ground box."""
    b = SceneBuilder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    trig = b.add_static(position=(0, 3.0, 0))
    b.add_box_collider(trig, (0, 0, 0), (1.0, 0.5, 1.0))
    b.mark_trigger(trig)
    body = b.add_body(position=(0, 6.0, 0))
    b.add_sphere_collider(body, (0, 0, 0), 0.4)
    return b.finalize(device="cpu"), body


def test_trigger_enter_leave():
    """The sphere falls through the trigger box: exactly one enter and one
    leave, and it ends resting below, outside the trigger."""
    scene, body = _trigger_scene()
    settings = tphys.PhysicsSettings(num_rigid_solver_iterations=10,
                                     solver_mode="scan")
    st = scene.initial_state(1)
    prev = torch.zeros((1, scene.overlap_pairs.shape[0]), dtype=torch.bool)
    n_enter = n_leave = 0
    for _ in range(240):
        st, info = tphys.physics_step(scene, st, settings, DT)
        enter, leave = trigger_events(prev, info.trigger_overlap)
        n_enter += int(enter.sum())
        n_leave += int(leave.sum())
        prev = info.trigger_overlap
    assert n_enter == 1
    assert n_leave == 1
    assert float(st.pos[0, body, 1]) < 1.0
    assert not bool(prev.any())


def test_trigger_events_vmapped():
    """Four envs with staggered drop heights: one enter and one leave in
    each, the enters on strictly increasing steps."""
    scene, body = _trigger_scene()
    settings = tphys.PhysicsSettings(num_rigid_solver_iterations=10,
                                     solver_mode="jacobi")
    n = 4
    st = scene.initial_state(n)
    pos = st.pos.clone()
    pos[:, body, 1] += torch.arange(n, dtype=torch.float32) * 0.7
    st = st.replace(pos=pos)
    prev = torch.zeros((n, scene.overlap_pairs.shape[0]), dtype=torch.bool)
    n_enter = np.zeros(n, np.int64)
    n_leave = np.zeros(n, np.int64)
    enter_step = np.full(n, -1)
    for i in range(300):
        st, info = tphys.physics_step(scene, st, settings, DT)
        enter, leave = trigger_events(prev, info.trigger_overlap)
        e = enter.sum(-1).numpy()
        n_enter += e
        n_leave += leave.sum(-1).numpy()
        enter_step[(e > 0) & (enter_step < 0)] = i
        prev = info.trigger_overlap
    assert np.all(n_enter == 1) and np.all(n_leave == 1)
    assert np.all(np.diff(enter_step) > 0)


def _scenes():
    return (chip_smoke.overlap_builder(JaxSceneBuilder)[0].finalize(),
            chip_smoke.overlap_builder(SceneBuilder)[0].finalize(device="cpu"))


def test_overlap_tables_match_jax():
    """The baked overlap pairs, groups and turned field forces equal the JAX
    package's; each group's flat_index points at its rows."""
    jscene, tscene = _scenes()
    got = scene_arrays(tscene)
    keys = [k for k in got if k.startswith(("overlap", "ff_forces",
                                            "global_ff", "colliders.owner"))]
    assert any(k.startswith("overlap_groups") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], np.asarray(_jax_field(jscene, k)),
                                      err_msg=k)
    for g in tscene.overlap_groups:
        assert torch.equal(tscene.overlap_pairs[g.flat_index], g.pairs)
    assert float(tscene.ff_forces[0, 0]) < 0.0        # turned with its owner


def _seeded_states(jscene, rng, n):
    """n poses of the overlap scene: each dynamic body within 1.2 m of the
    trigger's or the field's centre, turned at random."""
    base = jscene.initial_state()
    nb = jscene.num_bodies
    pos = np.repeat(np.asarray(base.pos)[None], n, 0)
    rot = np.repeat(np.asarray(base.rot)[None], n, 0)
    dyn = [i for i in range(nb) if float(jscene.body_params.inv_mass[i]) > 0]
    centres = np.array([[0.0, 2.0, 0.0], [-3.0, 1.0, 0.0]])
    for i in dyn:
        pos[:, i] = centres[rng.integers(0, 2, n)] + rng.uniform(
            -1.2, 1.2, (n, 3))
        q = rng.normal(size=(n, 4))
        rot[:, i] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    z = np.zeros_like(pos)
    f = dict(pos=pos, rot=rot, lin_vel=z, ang_vel=z, force_acc=z,
             torque_acc=z)
    return {k: v.astype(np.float32) for k, v in f.items()}


def test_overlap_interactions_match_jax():
    jscene, tscene = _scenes()
    f = _seeded_states(jscene, np.random.default_rng(11), 256)

    def jax_one(pos, rot):
        w = jax_world_colliders(jscene, pos, rot)
        mn, mx = jax_collider_aabbs(jscene, w)
        return jphys._overlap_interactions(jscene, w, mn, mx)

    jtrig, jforce = jax.jit(jax.vmap(jax_one))(jnp.asarray(f["pos"]),
                                               jnp.asarray(f["rot"]))
    pos, rot = torch.from_numpy(f["pos"]), torch.from_numpy(f["rot"])
    w = world_colliders(tscene, pos, rot)
    mn, mx = collider_aabbs(tscene, w)
    ttrig, tforce = tphys._overlap_interactions(tscene, w, mn, mx)
    jtrig = np.asarray(jtrig)
    assert np.array_equal(jtrig, ttrig.numpy())
    assert jtrig.any() and not jtrig.all()
    jforce = np.asarray(jforce)
    assert (np.abs(jforce).sum(-1) > 0).any()
    assert np.abs(jforce - tforce.numpy()).max() <= FORCE_TOL


def _hold(jst, tst, tol_pos, tol_vel, env=0):
    for k in BODY_FIELDS:
        want = np.asarray(getattr(jst, k))
        got = getattr(tst, k)[env].numpy()
        tol = tol_vel if "vel" in k else tol_pos
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol * scale, k


@pytest.mark.parametrize("mode", ["jacobi", "scan"])
def test_reference_steps_match_jax(mode):
    """STEPS steps of the overlap scene from its initial state: the two
    spheres pass through the trigger, the box and the capsule fall into
    the field and are lifted (their upward speed is held)."""
    jscene, tscene = _scenes()
    kw = dict(solver_mode=mode, num_rigid_solver_iterations=10)
    step = jax.jit(lambda s: jphys.physics_step(
        jscene, s, jphys.PhysicsSettings(**kw), DT))
    jst, tst = jscene.initial_state(), tscene.initial_state(1)
    seen = np.zeros(tscene.overlap_pairs.shape[0], bool)
    lifted = False
    for _ in range(STEPS):
        jst, jinfo = step(jst)
        tst, tinfo = tphys.physics_step(tscene, tst,
                                        tphys.PhysicsSettings(**kw), DT)
        mask = np.asarray(jinfo.trigger_overlap)
        assert np.array_equal(mask, tinfo.trigger_overlap[0].numpy())
        seen |= mask
        lifted |= bool((tst.lin_vel[0, 5:7, 1] > 0.0).any())
    _hold(jst, tst, TOL_POS, TOL_VEL)
    assert seen.any() and lifted


def test_fused_step_matches_eager_jax():
    """One fused step with a sphere inside the trigger and the box and the
    capsule inside the field, against the JAX step run op by op (about
    40 s): the trigger mask exactly, the state within FUSED_TOL of
    scale."""
    jscene, tscene = _scenes()
    kw = dict(solver_mode="fused", num_rigid_solver_iterations=10)
    jst = jscene.initial_state()
    pos = np.asarray(jst.pos).copy()
    pos[3], pos[5], pos[6] = [0, 2.2, 0], [-3.0, 1.2, 0], [-2.8, 0.6, 0.2]
    jst = jst.replace(pos=jnp.asarray(pos))
    tst = state_from_numpy({k: np.asarray(getattr(jst, k))
                            for k in STATE_FIELDS}, device="cpu", batch=1)
    with jax.disable_jit():
        jst, jinfo = jphys.physics_step(jscene, jst,
                                        jphys.PhysicsSettings(**kw), DT)
    tst, tinfo = tphys.physics_step(tscene, tst,
                                    tphys.PhysicsSettings(**kw), DT)
    mask = np.asarray(jinfo.trigger_overlap)
    assert mask.any()
    assert np.array_equal(mask, tinfo.trigger_overlap[0].numpy())
    _hold(jst, tst, FUSED_TOL, FUSED_TOL)
    assert float(tst.lin_vel[0, 5, 1]) > 0.0          # lifted by the field


def _json(d):
    return json.loads(json.dumps(d))


def test_trigger_scene_files(tmp_path):
    """builder_to_dict of the overlap scene equals the JAX package's; a file
    written by either package finalizes in the other to the same scene
    (every static array exact, the overlap tables included)."""
    tb = chip_smoke.overlap_builder(SceneBuilder)[0]
    jb = chip_smoke.overlap_builder(JaxSceneBuilder)[0]
    assert _json(tser.builder_to_dict(tb)) == _json(jser.builder_to_dict(jb))
    path = str(tmp_path / "scene.json")
    tser.save_scene(path, tb)
    tscene = tb.finalize(device="cpu")
    assert any(k.startswith("overlap_groups") for k in scene_arrays(tscene))
    _assert_scenes_equal(tscene, jser.load_scene(path).finalize())
    jser.save_scene(path, jb)
    _assert_scenes_equal(tser.load_scene(path).finalize(device="cpu"),
                         jb.finalize())


def _jax_field(jscene, name):
    """The JAX Scene's array under scene_arrays' dotted `name`."""
    obj = jscene
    for part in name.split("."):
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj
