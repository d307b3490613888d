"""Port parity for heightfield terrain: ops/heightmap.py (the plan path),
SceneBuilder.set_heightfield, the prep-passed pseudo-group of the fused
step and physics.py's terrain rows, against the JAX package.

Inputs are made from a numpy seed. Scenes: chip_smoke.py's terrain scene
(BASELINE config 4's 33 x 33 terrain under config 3's ragdoll and four
pieces of shape debris), the slope of tests/test_heightmap.py with a
sphere, a box, a capsule and a cylinder, and the 9 x 9 sphere-and-capsule
scene of tests/test_fused_solver.py::test_heightfield_scene_fused_matches_
jacobi.

The JAX contacts run under jax.jit(jax.vmap(...)). XLA:CPU contracts
multiply-adds there, so two triangles whose depths differ by rounding only
can come out of the 4-deepest selection in either order; the comparison
lets such a tie swap (depths are still held slot by slot). The JAX fused
step runs unbatched, op by op under jax.disable_jit() (a compiled JAX fused
step takes minutes to build on the CPU). Each JAX reference is computed
once per module and shared by the tests that read it."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.ops import heightmap as jhm
from dxk_tpu.ops.shapes import collider_aabbs as jax_collider_aabbs
from dxk_tpu.ops.shapes import world_colliders as jax_world_colliders
from dxk_tpu.ops.solver import prep_contacts as jax_prep_contacts
from dxk_tpu.physics import PhysicsSettings as JaxPhysicsSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.models.ragdoll import add_ragdoll
from dxk_tpu_torch.ops import heightmap as thm
from dxk_tpu_torch.ops.integrator import integrate_forces
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu_torch.ops.solver import prep_contacts
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
TOL = 1e-6               # relative to max(1, |value|)
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")
POSE_BATCH = 16          # envs of the seeded poses of the contact tests


def _slope_builder(builder):
    """tests/test_heightmap.py's slope (h = 0.2 x on 32 x 32 nodes, cell
    1.0, friction 0.2) with a sphere, a box, a capsule and a cylinder."""
    b = builder()
    H = np.fromfunction(lambda z, x: 0.2 * x, (32, 32), dtype=np.float32)
    b.set_heightfield(H, cell_size=1.0, min_corner=(0, 0, 0), friction=0.2)
    s = b.add_body(position=(20.0, 4.6, 16.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.5, friction=0.2)
    x = b.add_body(position=(10.0, 2.5, 10.0))
    b.add_box_collider(x, (0, 0, 0), (0.4, 0.4, 0.4), friction=0.8)
    c = b.add_body(position=(14.0, 3.0, 6.0))
    b.add_capsule_collider(c, (-0.3, 0, 0), (0.3, 0, 0), 0.2)
    y = b.add_body(position=(6.0, 1.6, 20.0))
    b.add_cylinder_collider(y, (0, -0.2, 0), (0, 0.2, 0), 0.25)
    return b


def _small_builder(builder):
    """tests/test_fused_solver.py:263-290: a sphere and a capsule on a
    9 x 9 heightfield."""
    b = builder()
    xs, zs = np.meshgrid(np.arange(9), np.arange(9), indexing="ij")
    H = (0.3 * np.sin(xs * 0.5) * np.cos(zs * 0.5)).astype(np.float32)
    b.set_heightfield(H, cell_size=1.0, min_corner=(-4.0, 0.0, -4.0),
                      friction=1.0)
    s = b.add_body(position=(0.0, 1.5, 0.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.4)
    c = b.add_body(position=(1.0, 2.0, 0.5))
    b.add_capsule_collider(c, (0, -0.25, 0), (0, 0.25, 0), 0.2)
    return b


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, port scene): chip_smoke's terrain scene ("terrain"), the
    same without the ragdoll ("debris"), the slope, the 9 x 9 scene."""
    if name in ("terrain", "debris"):
        rag = name == "terrain"
        return (chip_smoke.terrain_builder(
                    JaxSceneBuilder, jax_add_ragdoll if rag else None
                ).finalize(),
                chip_smoke.terrain_builder(
                    SceneBuilder, add_ragdoll if rag else None
                ).finalize(device="cpu"))
    make = {"slope": _slope_builder, "small": _small_builder}[name]
    return make(JaxSceneBuilder).finalize(), make(SceneBuilder).finalize(
        device="cpu")


def _close(got, want, tol=TOL):
    """|got - want| <= tol * max(1, |want|), elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))


def _jax_state(jscene, fields, e):
    """Env `e` of numpy state fields as an unbatched JAX State."""
    return jscene.initial_state().replace(
        **{k: jnp.asarray(fields[k][e]) for k in FIELDS})


def _fields(st):
    return {k: getattr(st, k).numpy() for k in FIELDS}


# ---------------------------------------------------------------------------
# (a) the scene and the plan


@pytest.mark.parametrize("name", ["terrain", "slope", "small"])
def test_scene_and_plan_match_jax(name):
    """The Scene (heightfield fields included) array for array, ints
    exactly and floats to 1e-7; heightfield_plan's buckets, windows, index
    arrays and permutation exactly; the fused step takes the scene."""
    jscene, tscene = scenes(name)
    want = {}
    _flatten_jax("", jscene, want)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    assert "heightfield.heights" in got and "heightfield.window" in got
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, k
        else:
            assert np.array_equal(g, w), k
    jp, tp = jhm.heightfield_plan(jscene), thm.heightfield_plan(tscene)
    assert [(t, k) for t, k, _i in tp["groups"]] == [
        (t, k) for t, k, _i in jp["groups"]]
    for (_t, _k, gi), (_t2, _k2, wi) in zip(tp["groups"], jp["groups"]):
        assert np.array_equal(gi, wi)
    assert np.array_equal(tp["inactive"], jp["inactive"])
    assert np.array_equal(tp["inv"], jp["inv"])
    assert fs.fused2_eligible(tscene)


def test_terrain_plan_covers_every_tag_and_window():
    """The terrain scene's plan holds every shape tag and windows 2, 4 and
    8; its hulls-free colliders are all active."""
    _jscene, tscene = scenes("terrain")
    plan = thm.heightfield_plan(tscene)
    assert {t for t, _k, _i in plan["groups"]} == set(chip_smoke.TERRAIN_TAGS)
    assert {k for _t, k, _i in plan["groups"]} == set(
        chip_smoke.TERRAIN_WINDOWS)
    assert len(plan["inactive"]) == 0


# ---------------------------------------------------------------------------
# (b) height_at


@pytest.mark.parametrize("name", ["terrain", "slope"])
def test_height_at_matches_jax(name):
    """Seeded points over the grid and up to two cells past its edges:
    within 1e-6."""
    jscene, tscene = scenes(name)
    H, W = tscene.heightfield.size
    c0 = tscene.heightfield.min_corner.numpy()
    rng = np.random.default_rng(7)
    x = (c0[0] + rng.uniform(-2, W + 1, 4096)).astype(np.float32)
    z = (c0[2] + rng.uniform(-2, H + 1, 4096)).astype(np.float32)
    got = thm.height_at(tscene.heightfield, torch.from_numpy(x),
                        torch.from_numpy(z)).numpy()
    want = np.asarray(jax.jit(lambda a, b: jhm.height_at(
        jscene.heightfield, a, b))(x, z))
    assert _close(got, want).all()


# ---------------------------------------------------------------------------
# (c), (d) heightfield contacts and their prep on seeded poses


@functools.lru_cache(maxsize=None)
def contacts(name):
    """Port and JAX heightfield contacts of chip_smoke.terrain_poses'
    POSE_BATCH seeded envs (every piece set 0-3 cm into the terrain or up to
    1 cm above it), with the port's state fields."""
    jscene, tscene = scenes(name)
    st = chip_smoke.terrain_poses(tscene, POSE_BATCH, 11)
    w = world_colliders(tscene, st.pos, st.rot)
    mn, mx = collider_aabbs(tscene, w)
    got = thm.heightfield_contacts(tscene.heightfield, w, w.body, mn, mx,
                                   tscene.num_bodies,
                                   plan=thm.heightfield_plan(tscene))
    plan = jhm.heightfield_plan(jscene)

    def one(pos, rot):
        jw = jax_world_colliders(jscene, pos, rot)
        jmn, jmx = jax_collider_aabbs(jscene, jw)
        return jhm.heightfield_contacts(jscene.heightfield, jw, jw.body, jmn,
                                        jmx, jscene.num_bodies, plan=plan)
    want = jax.jit(jax.vmap(one))(st.pos.numpy(), st.rot.numpy())
    return st, [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("name", ["terrain", "slope"])
def test_contacts_match_jax(name):
    """heightfield_contacts against the JAX package's, compiled: masks,
    body_a and body_b exactly; depths slot by slot, points and normals
    within 1e-6 of max(1, |x|), where two slots whose JAX depths tie
    within that tolerance may come in either order; friction and
    restitution within 1e-6."""
    _st, got, want = contacts(name)
    pts, nrm, dep, ba, bb, fric, rest, hit = got
    wpts, wnrm, wdep, wba, wbb, wfric, wrest, whit = want
    assert np.array_equal(hit, whit)
    assert np.array_equal(ba, wba) and np.array_equal(bb, wbb)
    assert _close(dep, wdep).all()
    assert _close(np.broadcast_to(fric, wfric.shape), wfric).all()
    assert _close(np.broadcast_to(rest, wrest.shape), wrest).all()
    same = _close(pts, wpts).all(-1) & _close(nrm, wnrm).all(-1)
    tie = _close(dep[..., :, None], wdep[..., None, :])         # [.., k, j]
    cross = (_close(pts[..., :, None, :], wpts[..., None, :, :]).all(-1)
             & _close(nrm[..., :, None, :], wnrm[..., None, :, :]).all(-1))
    assert (same | (tie & cross).any(-1)).all()
    # the row of a collider is live where any point hits
    assert np.array_equal(hit.any(-1), ba < scenes(name)[1].num_bodies)


def test_contacts_cover_every_branch():
    """The seeded terrain poses make every shape tag, every window and the
    safety contact live."""
    st, got, _want = contacts("terrain")
    _jscene, tscene = scenes("terrain")
    hit = torch.from_numpy(got[7])
    for tag, K, idx in thm.heightfield_plan(tscene)["groups"]:
        assert bool(hit[:, idx].any()), (tag, K)
    w = world_colliders(tscene, st.pos, st.rot)
    low = chip_smoke.terrain_lowest(tscene, w)
    below = low[..., 1] < thm.height_at(tscene.heightfield, low[..., 0],
                                        low[..., 2])
    safety = below & hit[..., 3]
    assert int(safety.sum()) > 0
    # a safety contact points straight down, with its depth below ground
    nrm = torch.from_numpy(got[1])[..., 3, :][safety]
    assert torch.equal(nrm, torch.tensor([0.0, -1.0, 0.0]).expand_as(nrm))
    assert bool((torch.from_numpy(got[2])[..., 3][safety] > 0).all())


@pytest.mark.parametrize("name", ["terrain", "slope"])
def test_prep_matches_jax(name):
    """prep_contacts of the port's terrain contacts on the port's integrated
    bodies, against the JAX package's prep of the same contacts and bodies
    run op by op: every field within 1e-6 of max(1, the field's largest
    |x|). (The tangent is the normalised tangential velocity, whose
    direction is ill conditioned where that velocity is small: compiled,
    XLA's contracted multiply-adds move it by up to 4e-6.)"""
    from dxk_tpu.ops.integrator import SolverBodies as JaxSolverBodies
    _jscene, tscene = scenes(name)
    st, got, _want = contacts(name)
    pts, nrm, dep, ba, bb, fric, rest, hit = got
    dt32 = np.float32(DT)
    bodies = integrate_forces(tscene, st, float(dt32))
    tprep = prep_contacts(bodies, torch.from_numpy(ba), torch.from_numpy(bb),
                          *(torch.from_numpy(x) for x in (pts, nrm, dep)),
                          torch.from_numpy(fric), torch.from_numpy(rest),
                          torch.from_numpy(hit.astype(np.float32)), dt32)
    jb = JaxSolverBodies(**{
        f.name: jnp.asarray(np.broadcast_to(
            getattr(bodies, f.name).numpy(), bodies.v.shape[:1]
            + tuple(getattr(bodies, f.name).shape[-(2 if f.name == "inv_mass"
                                                    else 3):])
            if f.name in ("local_cog", "inv_mass") else
            getattr(bodies, f.name).shape))
        for f in dataclasses.fields(JaxSolverBodies)})

    def one(b, a, bb_, p, n, d, m):
        return jax_prep_contacts(b, a, bb_, p, n, d, jnp.asarray(fric),
                                 jnp.asarray(rest), m, DT)
    with jax.disable_jit():
        jprep = jax.vmap(one)(jb, ba.astype(np.int32), bb.astype(np.int32),
                              pts, nrm, dep, hit.astype(np.float32))
    for fld in dataclasses.fields(tprep):
        if fld.name in ("phase_sizes", "body_a", "body_b"):
            continue
        g = getattr(tprep, fld.name).numpy()
        wv = np.asarray(getattr(jprep, fld.name))
        assert g.shape == wv.shape, fld.name
        scale = max(1.0, float(np.abs(wv).max()))
        assert float(np.abs(g - wv).max()) <= TOL * scale, fld.name
    assert bool((tprep.eff_mass_n > 0).any())


# ---------------------------------------------------------------------------
# (e), (f) the fused step with terrain rows against the JAX package's


def _one_step(name, fields, mode, iters, batch):
    """One step of `batch` envs of `fields`: the JAX package's eager
    unbatched step per env and the port's plain version, batched."""
    jscene, tscene = scenes(name)
    js = JaxPhysicsSettings(num_rigid_solver_iterations=iters,
                            solver_mode=mode)
    out = []
    for e in range(batch):
        with jax.disable_jit():
            out.append(jax_physics_step(jscene, _jax_state(jscene, fields, e),
                                        js, DT))
    tst = state_from_numpy({k: v[:batch] for k, v in fields.items()},
                           device="cpu")
    tst = tst.replace(controls=tscene.batched_controls(batch))
    ts = PhysicsSettings(num_rigid_solver_iterations=iters, solver_mode=mode)
    return out, physics_step(tscene, tst, ts, DT)


SMALL_WARM = 110         # port steps of the 9 x 9 scene: both bodies in touch


@functools.lru_cache(maxsize=None)
def small_state(state):
    """One env of the 9 x 9 scene, initial or after SMALL_WARM steps of the
    port's plain "fused" step at 10 iterations."""
    _jscene, tscene = scenes("small")
    st = tscene.initial_state(1)
    if state == "warm":
        s = PhysicsSettings(num_rigid_solver_iterations=10,
                            solver_mode="fused")
        for _ in range(SMALL_WARM):
            st, _info = physics_step(tscene, st, s, DT)
    return _fields(st)


def _hold_step(want, got, batch, vel_tol, pos_tol):
    """The port's step against the JAX steps of each env: velocities,
    positions and rotations, and StepInfo's contact rows (pairs with the
    terrain's (-1, -1) rows, live mask, summed normal impulse)."""
    tst, tinfo = got
    for e in range(batch):
        jst, jinfo = want[e]
        for k, tol in (("lin_vel", vel_tol), ("ang_vel", vel_tol),
                       ("pos", pos_tol), ("rot", pos_tol)):
            d = np.abs(np.asarray(getattr(jst, k))
                       - getattr(tst, k)[e].numpy()).max()
            assert d <= tol, (k, d)
        assert np.array_equal(np.asarray(jinfo.contact_pairs),
                              tinfo.contact_pairs.numpy())
        assert np.array_equal(np.asarray(jinfo.contact_mask),
                              tinfo.contact_mask[e].numpy())
        assert _close(tinfo.contact_impulse[e].numpy(),
                      np.asarray(jinfo.contact_impulse), 1e-5).all()


SMALL_CASES = [(m, s) for m in ("fused", "fused_seq")
               for s in ("initial", "warm")]


@pytest.mark.parametrize("mode,state", SMALL_CASES,
                         ids=[f"{m}-{s}" for m, s in SMALL_CASES])
def test_small_scene_step_matches_jax(mode, state):
    """One step of the 9 x 9 scene at 10 iterations, from the initial state
    and from one where both bodies touch the terrain: velocities within
    1e-6, positions and rotations within 1e-5, StepInfo's terrain rows
    index-aligned as the JAX package's."""
    _jscene, tscene = scenes("small")
    fields = small_state(state)
    want, got = _one_step("small", fields, mode, 10, 1)
    _hold_step(want, got, 1, 1e-6, 1e-5)
    C = tscene.colliders.ctype.shape[0]
    info = got[1]
    assert info.contact_pairs.shape[0] == len(tscene.pair_groups[0].pairs) + C
    assert bool((info.contact_pairs[-C:] == -1).all())
    if state == "warm":
        assert bool(info.contact_mask[0, -C:].all())
        assert float(info.contact_impulse[0, -C:].min()) > 1.0


def test_terrain_debris_step_matches_jax():
    """The slice as a whole: one "fused" step (3 iterations) of the
    terrain scene's debris (the full scene's JAX reference costs more than
    a minute on the CPU) at 2 envs, from seeded terrain poses with every
    piece in touch: velocities within 1e-6 of max(1, the largest),
    positions within 1e-5, StepInfo as the JAX package's."""
    _jscene, tscene = scenes("debris")
    st = chip_smoke.terrain_poses(tscene, 2, 5)
    want, got = _one_step("debris", _fields(st), "fused", 3, 2)
    vmax = max(1.0, max(float(np.abs(np.asarray(j.lin_vel)).max())
                        for j, _i in want),
               max(float(np.abs(np.asarray(j.ang_vel)).max())
                   for j, _i in want))
    _hold_step(want, got, 2, 1e-6 * vmax, 1e-5)
    C = tscene.colliders.ctype.shape[0]
    assert int(got[1].contact_mask[:, -C:].sum()) >= C


def test_passed_rows_layout():
    """passed_rows puts point k of terrain row p, field f at [f, k, p] in
    the kernel's point-field order, and the plain version reads it back as
    the prep's lanes; a wrong shape raises."""
    _jscene, tscene = scenes("slope")
    st, got, _want = contacts("slope")
    pts, nrm, dep, ba, bb, fric, rest, hit = got
    bodies = integrate_forces(tscene, st, DT)
    prep = prep_contacts(bodies, torch.from_numpy(ba), torch.from_numpy(bb),
                         *(torch.from_numpy(x) for x in (pts, nrm, dep)),
                         torch.from_numpy(fric), torch.from_numpy(rest),
                         torch.from_numpy(hit.astype(np.float32)), DT)
    tab = fs.fused_tables(tscene, "cpu")
    rows = fs.passed_rows(tab, prep)
    C = tab.num_colliders
    assert rows.shape == (POSE_BATCH, fs.POINT_FIELDS - 2, 4, C)
    assert tab.passed_points == 4 * C
    f = 0
    for name in fs.POINT_VEC_FIELDS:
        for c in range(3):
            assert torch.equal(rows[:, f], getattr(prep, name)[..., c]
                               .transpose(1, 2)), name
            f += 1
    for name in fs.POINT_SCALAR_FIELDS:
        assert torch.equal(rows[:, f], getattr(prep, name).transpose(1, 2))
        f += 1
    with pytest.raises(ValueError):
        fs.passed_rows(tab, prep.slice(0, C - 1))
