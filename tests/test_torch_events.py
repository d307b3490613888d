"""Port parity, modules events.py and utils/validate.py (with the stage
checks in both branches of physics_step).

  - A box resting on the ground, 120 "scan" steps in both packages: the
    same collision begins (colliders and bodies exact, impulses within 1e-4
    relative: the two steps agree to float32 rounding) and no end; lifted
    away, the same end event.
  - The port's collision_events_batched against the JAX collision_events
    on the same StepInfos, env by env, on the reference step (pairs
    compacted per env) and on the fused step (pairs shared): equal events.
  - trigger_events against the JAX function on seeded masks: equal.
  - validate_stage: the JAX package's own (field, stage) cases, with the
    JAX step's stage beside the port's ("scan"; the port's fused branch
    held to the same stage ids), per env, -1 where finite, None when off.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu import events as jev
from dxk_tpu.physics import PhysicsSettings as JaxSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene.scene import StepInfo as JaxStepInfo
from dxk_tpu.utils.validate import STAGE_ID as JAX_STAGE_ID
from dxk_tpu_torch import events as tev
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.validate import STAGE_ID

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
IMPULSE_RTOL = 1e-4


def drop_scene(builder, device=None):
    """tests/test_events.py's box in resting contact with the ground."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    body = b.add_body(position=(0, 0.499, 0))
    b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    return (b.finalize() if device is None else b.finalize(device=device),
            body)


def pile_scene(builder, device=None):
    """Three boxes dropped onto the ground and onto each other."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    for i in range(3):
        body = b.add_body(position=(0.3 * i, 0.6 + 1.05 * i, 0.1 * i))
        b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    kw = dict(contact_phases=2)
    return b.finalize(**kw) if device is None else b.finalize(device=device,
                                                               **kw)


def test_stage_ids_match_jax():
    assert STAGE_ID == JAX_STAGE_ID


@functools.lru_cache(maxsize=None)
def resting_runs():
    """120 "scan" steps of the resting box in both packages, then one step
    with the box lifted to y = 50: each side's StepInfos."""
    jscene, body = drop_scene(JaxSceneBuilder)
    tscene, _ = drop_scene(SceneBuilder, "cpu")
    js = JaxSettings(num_rigid_solver_iterations=10, solver_mode="scan")
    ts = PhysicsSettings(num_rigid_solver_iterations=10, solver_mode="scan")
    jstep = jax.jit(lambda s: jax_physics_step(jscene, s, js, DT))
    jst, tst = jscene.initial_state(), tscene.initial_state(1)
    jinfos, tinfos = [], []
    for _ in range(120):
        jst, ji = jstep(jst)
        tst, ti = physics_step(tscene, tst, ts, DT)
        jinfos.append(ji)
        tinfos.append(ti)
    jinfos.append(jstep(jst.replace(pos=jst.pos.at[body, 1].set(50.0)))[1])
    pos = tst.pos.clone()
    pos[0, body, 1] = 50.0
    tinfos.append(physics_step(tscene, tst.replace(pos=pos), ts, DT)[1])
    return (jscene, jinfos), (tscene, tinfos), body


def _same_events(jevents, tevents):
    assert len(jevents) == len(tevents)
    for je, te in zip(jevents, tevents):
        assert (te.collider_a, te.collider_b, te.body_a, te.body_b) == (
            je.collider_a, je.collider_b, je.body_a, je.body_b)
        assert abs(te.impulse - je.impulse) <= IMPULSE_RTOL * max(
            1.0, abs(je.impulse))


def test_collision_begin_persist_end_matches_jax():
    (jscene, jinfos), (tscene, tinfos), body = resting_runs()
    jb, je, tb, te = [], [], [], []
    jprev = tprev = None
    for ji, ti in zip(jinfos[:-1], tinfos[:-1]):
        b_, e_ = jev.collision_events(jscene, jprev, ji)
        jb += b_
        je += e_
        b_, e_ = tev.collision_events(tscene, tprev, ti)
        tb += b_
        te += e_
        jprev, tprev = ji, ti
    _same_events(jb, tb)
    _same_events(je, te)
    # resting box: one begin (box vs ground, first step), no end
    assert len(tb) == 1 and not te
    assert {tb[0].body_a, tb[0].body_b} == {body, tscene.dummy_body}
    assert tb[0].impulse > 0.0
    # lifted away: one end, no begin
    jbl, jel = jev.collision_events(jscene, jprev, jinfos[-1])
    tbl, tel = tev.collision_events(tscene, tprev, tinfos[-1])
    assert not tbl and len(tel) == 1
    _same_events(jbl, tbl)
    _same_events(jel, tel)


def _tuples(events):
    """(begins, ends) as plain tuples: the two packages' CollisionEvent
    classes never compare equal to each other."""
    return [[dataclasses.astuple(ev) for ev in evs] for evs in events]


def _jax_info(tinfo, env):
    """Env `env` of a port StepInfo as an unbatched JAX StepInfo."""
    pairs = tinfo.contact_pairs.numpy()
    if pairs.ndim == 3:
        pairs = pairs[env]
    return JaxStepInfo(
        num_broadphase_overlaps=jnp.int32(0), num_contacts=jnp.int32(0),
        broadphase_overflow=jnp.int32(0), contact_pairs=jnp.asarray(pairs),
        contact_mask=jnp.asarray(tinfo.contact_mask[env].numpy()),
        contact_impulse=jnp.asarray(tinfo.contact_impulse[env].numpy()))


@pytest.mark.parametrize("mode", ["jacobi", "fused"])
def test_batched_events_match_jax_on_same_info(mode):
    """The port's per-env diffs against the JAX diffs of the same infos."""
    tscene = pile_scene(SceneBuilder, "cpu")
    jscene = pile_scene(JaxSceneBuilder)
    B = 3
    st = tscene.initial_state(B)
    pos = st.pos.clone()
    pos[1, 1:-1, 1] += 0.4          # env 1 lands later
    pos[2, 1:-1, 0] += torch.tensor([0.0, 1.5, -1.5])   # env 2 topples
    st = st.replace(pos=pos)
    s = PhysicsSettings(num_rigid_solver_iterations=4, solver_mode=mode)
    prev = None
    seen = np.zeros(B, int)
    for _ in range(50):
        st, info = physics_step(tscene, st, s, DT)
        got = tev.collision_events_batched(tscene, prev, info)
        for e in range(B):
            want = jev.collision_events(
                jscene, _jax_info(prev, e) if prev is not None else None,
                _jax_info(info, e))
            assert _tuples(got[e]) == _tuples(want)
            assert tev.collision_events(tscene, prev, info, env=e) == got[e]
            seen[e] += len(got[e][0]) + len(got[e][1])
        prev = info
    assert seen.min() > 0


def test_collision_events_batched():
    """tests/test_events.py's batched case: a sphere lands in env 0, env 1
    starts too high to land within 60 steps (default settings, "scan")."""
    b = SceneBuilder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    s = b.add_body(position=(0, 1.2, 0))
    b.add_sphere_collider(s, (0, 0, 0), 0.5)
    scene = b.finalize(device="cpu")
    st = scene.initial_state(2)
    pos = st.pos.clone()
    pos[1, s, 1] = 8.0
    st = st.replace(pos=pos)
    info = None
    seen = [[], []]
    for _ in range(60):
        prev = info
        st, info = physics_step(scene, st, PhysicsSettings(), DT)
        for i, (begins, _ends) in enumerate(
                tev.collision_events_batched(scene, prev, info)):
            seen[i].extend(begins)
    assert len(seen[0]) >= 1
    assert len(seen[1]) == 0


def test_trigger_events_match_jax():
    rng = np.random.default_rng(0)
    prev = rng.random((4, 9)) < 0.5
    cur = rng.random((4, 9)) < 0.5
    te, tl = tev.trigger_events(torch.from_numpy(prev), torch.from_numpy(cur))
    je, jl = jev.trigger_events(jnp.asarray(prev), jnp.asarray(cur))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@functools.lru_cache(maxsize=None)
def jax_validate_step():
    jscene, body = drop_scene(JaxSceneBuilder)
    s = JaxSettings(num_rigid_solver_iterations=4, solver_mode="scan",
                    validate=True)
    return jscene, body, jax.jit(lambda x: jax_physics_step(jscene, x, s,
                                                            DT)[1])


@pytest.mark.parametrize("mode", ["scan", "fused"])
@pytest.mark.parametrize("field,stage", [
    ("pos", "world_colliders"),
    ("lin_vel", "body_velocities"),
])
def test_validate_reports_first_bad_stage(mode, field, stage):
    """A NaN in env 1's `field`: env 1 reports `stage`, as the JAX step
    does, env 0 reports -1; a (B,) int32 tensor."""
    jscene, body, jstep = jax_validate_step()
    jst = jscene.initial_state()
    assert int(jstep(jst).validate_stage) == -1
    jbad = jst.replace(**{field: getattr(jst, field).at[body, 1].set(
        jnp.nan)})
    assert int(jstep(jbad).validate_stage) == STAGE_ID[stage]

    tscene, _ = drop_scene(SceneBuilder, "cpu")
    s = PhysicsSettings(num_rigid_solver_iterations=4, solver_mode=mode,
                        validate=True)
    st = tscene.initial_state(2)
    x = getattr(st, field).clone()
    x[1, body, 1] = float("nan")
    info = physics_step(tscene, st.replace(**{field: x}), s, DT)[1]
    assert info.validate_stage.dtype == torch.int32
    assert info.validate_stage.tolist() == [-1, STAGE_ID[stage]]


@pytest.mark.parametrize("mode", ["scan", "fused"])
def test_validate_off_and_later_stages(mode):
    """validate off: None. A NaN force in env 0 shows first in the
    integrated velocities: body_velocities there, -1 in the other envs."""
    tscene, body = drop_scene(SceneBuilder, "cpu")
    st = tscene.initial_state(3)
    assert physics_step(tscene, st, PhysicsSettings(solver_mode=mode),
                        DT)[1].validate_stage is None
    f = st.force_acc.clone()
    f[0, body, 0] = float("nan")
    s = PhysicsSettings(num_rigid_solver_iterations=4, solver_mode=mode,
                        validate=True)
    stage = physics_step(tscene, st.replace(force_acc=f), s,
                         DT)[1].validate_stage
    assert stage.tolist() == [STAGE_ID["body_velocities"], -1, -1]
