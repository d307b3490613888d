"""Port parity, module scene/islands.py (islandize, IslandMap.gather and
scatter) and BASELINE config 1's default path: the box towers decomposed
into identical island envs and stepped by the fused step's plain version.

  (a) structure against the JAX package's islandize, exactly: body map,
      control maps, sub-scene colliders, pair groups, body params, joints
      and their colours, initial transforms;
  (b) the same refusals, and kselect and sap scenes refused too;
  (c) motor controls carried into island space;
  (d) island steps scattered back equal full-scene steps ("colored", 3
      steps: 1e-5 on positions, 1e-4 on velocities, the JAX test's bound);
  (e) the port's island "colored" step against the JAX island "colored"
      step on the same seeded inputs (1e-6 / 1e-5 after one step, 1e-5 /
      1e-4 after three: the same float32 operations, summed in another
      order);
  (f) the port's "fused" island step (the kernel's plain version) against
      the JAX island "colored" step over 2 steps within 1e-5 / 1e-4, the
      JAX test's own bound between its fused and colored steps;
  and a 30-step standing check of 4 towers of 16 at the bench tuning
  (the full 600 steps at 2,048 envs run on the card, chip_smoke.py).

The JAX "fused" step of a box-box scene is never compiled here (about 20
minutes on the CPU); the JAX side runs "colored", jitted once a scene."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.physics import PhysicsSettings as JaxSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene.islands import NotIslandizable as JaxNotIslandizable
from dxk_tpu.scene.islands import islandize as jax_islandize
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.islands import NotIslandizable, islandize
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
ITERS = 10
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


def towers(builder, n_towers=4, height=4, base=0.4995, spacing=0.9995):
    """tests/test_islands.py's towers of unit boxes on a ground box."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (60, 1, 60))
    for t in range(n_towers):
        x = t * 3.0
        for i in range(height):
            bd = b.add_body(position=(x, base + spacing * i, 0.0))
            b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


def arms(builder):
    """Three kinematic anchors, each with a capsule arm on a hinge."""
    b = builder()
    for t in range(3):
        x = t * 4.0
        anchor = b.add_body(position=(x, 3, 0), kinematic=True)
        arm = b.add_body(position=(x + 0.5, 3, 0))
        b.add_capsule_collider(arm, (-0.3, 0, 0), (0.3, 0, 0), 0.1)
        b.add_hinge_constraint(anchor, arm, (x, 3, 0), (0, 0, 1))
    return b


def mixed(builder):
    """tests/test_islands.py's non-uniform scene: a 3-box tower and a
    sphere."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (60, 1, 60))
    for i in range(3):
        bd = b.add_body(position=(0.0, 0.5 + i, 0.0))
        b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
    bd = b.add_body(position=(5.0, 0.4, 0.0))
    b.add_sphere_collider(bd, (0, 0, 0), 0.4)
    return b


SCENES = {
    "towers": (towers, dict(contact_phases=4, candidate_margin=1.0)),
    "bench_towers": (functools.partial(towers, height=16, base=0.5,
                                       spacing=1.001),
                     dict(contact_phases=2, candidate_margin=0.25)),
    "arms": (arms, dict(candidate_margin=0.5)),
}


@functools.lru_cache(maxsize=None)
def both(name):
    make, kw = SCENES[name]
    jscene = make(JaxSceneBuilder).finalize(**kw)
    tscene = make(SceneBuilder).finalize(device="cpu", **kw)
    return (jscene, jax_islandize(jscene)), (tscene, islandize(tscene))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_structure_matches_jax(name):
    (_js, jim), (_ts, tim) = both(name)
    assert tim.num_islands == jim.num_islands
    np.testing.assert_array_equal(tim.body_map.numpy(),
                                  np.asarray(jim.body_map))
    for f in ("hinge_ctrl_map", "ct_ctrl_map", "slider_ctrl_map"):
        jm, tm = getattr(jim, f), getattr(tim, f)
        assert (jm is None) == (tm is None), f
        if jm is not None:
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    js, ts = jim.sub_scene, tim.sub_scene
    assert ts.num_bodies == js.num_bodies
    assert ts.num_contact_phases == js.num_contact_phases
    assert ts.broadphase_k == js.broadphase_k == 0
    for part in ("colliders", "body_params", "default_controls"):
        ja, ta = scene_arrays(getattr(js, part)), scene_arrays(
            getattr(ts, part))
        for k, v in ta.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(
                getattr(js, part), k)), err_msg=f"{part}.{k}")
    assert len(ts.pair_groups) == len(js.pair_groups)
    for jg, tg in zip(js.pair_groups, ts.pair_groups):
        assert (tg.type_a, tg.type_b, tg.phase, tg.max_narrow) == (
            jg.type_a, jg.type_b, jg.phase, jg.max_narrow)
        np.testing.assert_array_equal(tg.pairs.numpy(), np.asarray(jg.pairs))
    for jt in ("distance", "ball", "fixed", "hinge", "cone_twist", "slider"):
        jj, tj = getattr(js, jt), getattr(ts, jt)
        assert (jj is None) == (tj is None), jt
        if tj is None:
            continue
        assert tj.num_colors == jj.num_colors
        for k, v in scene_arrays(tj).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(jj, k)),
                                          err_msg=f"{jt}.{k}")
    np.testing.assert_array_equal(ts.init_pos.numpy(),
                                  np.asarray(js.init_pos))
    np.testing.assert_array_equal(ts.init_rot.numpy(),
                                  np.asarray(js.init_rot))


def test_sub_scene_is_fresh_and_planned():
    """The sub-scene is a new Scene: none of the full scene's caches. Config
    1's island (16 boxes, 31 box-box rows in 2 phases) at its 2,048 kernel
    envs (32 worlds of 64 islands) packs eight one-warp envs a block; 64
    envs (one world) spread each over eight warps."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    _j, (tscene, tim) = both("bench_towers")
    fs.fused_tables(tscene, "cpu")
    assert "_fused_tables" in tscene.__dict__
    assert "_fused_tables" not in tim.sub_scene.__dict__
    assert fs.fused2_eligible(tim.sub_scene)
    assert tim.sub_scene.num_bodies == 16
    assert tim.num_islands == 4
    tab = fs.fused_tables(tim.sub_scene, "cpu")
    assert (tab.num_rows, tab.num_phases) == (31, 2)
    plan = tab.launch_plan(2048)
    assert (plan.envs, plan.warps, plan.threads, plan.blocks) == (8, 1, 256,
                                                                  256)
    assert (tab.launch_plan(64).envs, tab.launch_plan(64).warps) == (1, 8)


@pytest.mark.parametrize("name,kw", [
    ("mixed", dict(candidate_margin=1.0)),
    ("single", dict(candidate_margin=1.0)),
    ("kselect", dict(broadphase="kselect", broadphase_k=8)),
    ("sap", dict(broadphase="sap", broadphase_k=8)),
])
def test_refusals(name, kw):
    make = {"mixed": mixed, "single": functools.partial(towers, n_towers=1),
            "kselect": towers, "sap": towers}[name]
    with pytest.raises(NotIslandizable) as te:
        islandize(make(SceneBuilder).finalize(device="cpu", **kw))
    with pytest.raises(JaxNotIslandizable) as je:
        jax_islandize(make(JaxSceneBuilder).finalize(**kw))
    if name == "sap":
        # the JAX message says "kselect" for both dynamic broadphases
        assert str(te.value) == "sap scenes have no static tables"
    else:
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("field", ["cloth", "overlap_pairs"])
def test_cloth_and_trigger_scenes_refused(field):
    """A cloth scene as each package's add_cloth builds it, and a trigger
    scene as each package's mark_trigger builds it, with the same message
    in both."""
    make, kw = SCENES["towers"]

    def with_extra(builder):
        b = make(builder)
        if field == "cloth":
            b.add_cloth(1.0, 1.0, 4, 4, 1.0, transform_pos=(0, 6, 0))
        else:
            trig = b.add_static(position=(0.0, 6.0, 0.0))
            b.add_box_collider(trig, (0, 0, 0), (1.0, 0.5, 1.0))
            b.mark_trigger(trig)
        return b
    jscene = with_extra(JaxSceneBuilder).finalize(**kw)
    tscene = with_extra(SceneBuilder).finalize(device="cpu", **kw)
    if field == "overlap_pairs":
        assert tscene.overlap_pairs.shape[0] > 0
    with pytest.raises(NotIslandizable) as te:
        islandize(tscene)
    with pytest.raises(JaxNotIslandizable) as je:
        jax_islandize(jscene)
    assert str(te.value) == str(je.value)


def test_heightfield_refused():
    b = towers(SceneBuilder)
    b.set_heightfield(np.zeros((5, 5)), 1.0, (-2.0, -2.0, -2.0))
    with pytest.raises(NotIslandizable, match="cloth/heightfield"):
        islandize(b.finalize(device="cpu", candidate_margin=1.0))


def test_controls_carried():
    """gather slices the caller's motor controls into island space: each
    hinge velocity-driven at its own target, island steps equal the full
    scene's ("jacobi", 5 steps, 1e-5 on angular velocities)."""
    _j, (tscene, tim) = both("arms")
    assert tuple(tim.hinge_ctrl_map.shape) == (3, 1)
    B = 2
    full = tscene.initial_state(B)
    c = full.controls
    c = c.replace(hinge_motor_type=torch.zeros_like(c.hinge_motor_type),
                  hinge_target=torch.tensor([[1.0, -2.0, 3.0],
                                             [0.5, 1.5, -1.0]]),
                  hinge_max_torque=torch.full_like(c.hinge_max_torque, 500.0))
    full = full.replace(controls=c)
    isl = tim.gather(full)
    assert tuple(isl.controls.hinge_target.shape) == (6, 1)
    np.testing.assert_array_equal(isl.controls.hinge_target[:, 0].numpy(),
                                  [1.0, -2.0, 3.0, 0.5, 1.5, -1.0])
    s = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                        solver_mode="jacobi")
    for _ in range(5):
        full = physics_step(tscene, full, s, DT)[0]
        isl = physics_step(tim.sub_scene, isl, s, DT)[0]
    back = tim.scatter(isl, tscene.initial_state(B))
    err = float((back.ang_vel[:, :-1] - full.ang_vel[:, :-1]).abs().max())
    assert err < 1e-5, err
    w = isl.ang_vel[:, 0, 2].numpy()      # island body 0 = the arm
    assert len(set(np.round(w, 4))) == 6


def seeded_state(scene, batch, seed=0):
    """`batch` worlds of `scene`, each box moved by a seeded jitter (mm)
    and given small seeded velocities, as numpy fields."""
    rng = np.random.default_rng(seed)
    n1 = scene.num_bodies + 1
    pos = np.broadcast_to(scene.init_pos.numpy(), (batch, n1, 3)).copy()
    rot = np.broadcast_to(scene.init_rot.numpy(), (batch, n1, 4)).copy()
    nb = scene.num_bodies
    pos[:, 1:nb, [0, 2]] += rng.normal(0, 2e-3, (batch, nb - 1, 2))
    pos[:, 1:nb, 1] -= 1e-3
    out = dict(pos=pos, rot=rot, lin_vel=np.zeros((batch, n1, 3)),
               ang_vel=np.zeros((batch, n1, 3)),
               force_acc=np.zeros((batch, n1, 3)),
               torque_acc=np.zeros((batch, n1, 3)))
    out["lin_vel"][:, 1:nb] = rng.normal(0, 0.05, (batch, nb - 1, 3))
    out["ang_vel"][:, 1:nb] = rng.normal(0, 0.05, (batch, nb - 1, 3))
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_island_step_matches_full_scene():
    """(d): "colored", 3 steps, 1e-5 / 1e-4."""
    _j, (tscene, tim) = both("towers")
    fields = seeded_state(tscene, 2)
    full = state_from_numpy(fields, "cpu")
    isl = tim.gather(full)
    s = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                        solver_mode="colored")
    for _ in range(3):
        full = physics_step(tscene, full, s, DT)[0]
        isl = physics_step(tim.sub_scene, isl, s, DT)[0]
    back = tim.scatter(isl, state_from_numpy(fields, "cpu"))
    err_p = float((back.pos[:, :-1] - full.pos[:, :-1]).abs().max())
    err_v = float((back.lin_vel[:, :-1] - full.lin_vel[:, :-1]).abs().max())
    assert err_p < 1e-5, err_p
    assert err_v < 1e-4, err_v


def test_gather_scatter_layout():
    """gather's env b * I + i is island i of world b, matching the JAX
    gather of each world; scatter inverts it into the template."""
    (jscene, jim), (tscene, tim) = both("towers")
    fields = seeded_state(tscene, 3)
    isl = tim.gather(state_from_numpy(fields, "cpu"))
    I = tim.num_islands
    for b in range(3):
        jst = jscene.initial_state().replace(
            **{k: jnp.asarray(v[b]) for k, v in fields.items()})
        jisl = jim.gather(jst)
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(isl, k)[b * I:(b + 1) * I].numpy(),
                np.asarray(getattr(jisl, k)))
    back = tim.scatter(isl, tscene.initial_state(3))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back, k).numpy(), fields[k])


@functools.lru_cache(maxsize=None)
def jax_island_colored(steps):
    """The JAX island "colored" step on seeded_state's 2 worlds, after
    each of `steps` steps."""
    (jscene, jim), (tscene, _t) = both("towers")
    fields = seeded_state(tscene, 2)
    s = JaxSettings(num_rigid_solver_iterations=ITERS, solver_mode="colored")
    step = jax.jit(jax.vmap(
        lambda x: jax_physics_step(jim.sub_scene, x, s, DT)[0]))
    isl = [jim.gather(jscene.initial_state().replace(
        **{k: jnp.asarray(v[b]) for k, v in fields.items()}))
        for b in range(2)]
    st = jax.tree_util.tree_map(lambda *x: jnp.concatenate(x), *isl)
    out = []
    for _ in range(steps):
        st = step(st)
        out.append({k: np.asarray(getattr(st, k)) for k in FIELDS})
    return fields, out


def _err(jout, tst, keys):
    return max(float(np.abs(jout[k] - getattr(tst, k).numpy()).max())
               for k in keys)


@pytest.mark.parametrize("mode,tols", [
    ("colored", {1: (1e-6, 1e-5), 3: (1e-5, 1e-4)}),
    ("fused", {1: (1e-5, 1e-4), 2: (1e-5, 1e-4)}),
])
def test_island_step_matches_jax_colored(mode, tols):
    """(e) and (f): the port's island step in `mode` against the JAX island
    "colored" step on the same inputs."""
    fields, jouts = jax_island_colored(3)
    _j, (_ts, tim) = both("towers")
    st = tim.gather(state_from_numpy(fields, "cpu"))
    s = PhysicsSettings(num_rigid_solver_iterations=ITERS, solver_mode=mode)
    for n in range(1, max(tols) + 1):
        st = physics_step(tim.sub_scene, st, s, DT)[0]
        if n in tols:
            tp, tv = tols[n]
            assert _err(jouts[n - 1], st, ("pos", "rot")) < tp, n
            assert _err(jouts[n - 1], st, ("lin_vel", "ang_vel")) < tv, n


def test_bench_towers_stand_short():
    """The bench tuning (contact_phases=2, candidate_margin=0.25, the
    1.001 spawn) keeps 4 towers of 16 standing over 30 fused steps of the
    plain version, by tests/test_islands.py's bounds: the top box falls by
    less than 0.15, no box moves more than 0.25 in x or z."""
    _j, (tscene, tim) = both("bench_towers")
    s = PhysicsSettings(num_rigid_solver_iterations=30, solver_mode="fused")
    st0 = tim.gather(tscene.initial_state(1))
    st = st0
    for _ in range(30):
        st = physics_step(tim.sub_scene, st, s, DT)[0]
    assert bool(torch.isfinite(st.pos).all())
    top0, top = float(st0.pos[..., 1].max()), float(st.pos[..., 1].max())
    assert top > top0 - 0.15, (top0, top)
    d = (st.pos[:, :-1] - st0.pos[:, :-1]).abs()
    assert float(d[..., [0, 2]].max()) < 0.25
