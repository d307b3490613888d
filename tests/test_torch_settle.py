"""Port parity for BASELINE config 3, the ragdoll drop-and-settle with its
convex-hull debris (bench.py:326-351), and for chip_smoke.py's hull pile
(three hulls stacked on a ground box): the scene builder with hull
geometry from a mesh and a hull collider, the fused step's tables with the
hull blocks the kernel reads, and the plain version of the fused step with
the capsule-hull, box-hull and hull-hull recipes against the JAX package's
"fused" step.

The scenes are chip_smoke.py's copies, so the scenes the card runs are the
ones held against the JAX package here. The JAX fused step runs unbatched
and eagerly, op by op under jax.disable_jit(): its unbatched branch is the
same `_fused_core` the Pallas kernel runs, with one env lane. A compiled JAX program of these scenes is
out of reach on the CPU (jit(vmap(physics_step)) of config 3 in interpret
mode, and even the unbatched jit, ran out of memory past 24 GB), and the
eager step costs about half a minute, so the step tests run one env."""
import functools

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
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.utils.convert import scene_arrays, state_from_numpy
from test_torch_scene import _flatten_jax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

ITERS = 10
DT = 1.0 / 120.0
FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, port scene) of "settle" or "pile"."""
    if name == "settle":
        return (chip_smoke.settle_builder(JaxSceneBuilder,
                                          jax_add_ragdoll).finalize(),
                chip_smoke.settle_scene("cpu"))
    return (chip_smoke.pile_builder(JaxSceneBuilder).finalize(),
            chip_smoke.pile_scene("cpu"))


# ---------------------------------------------------------------------------
# the scenes and the kernel's tables


@pytest.mark.parametrize("name", ["settle", "pile"])
def test_scene_arrays_equal(name):
    """Body params, colliders, pair groups, joints and the hull geometry
    (vertices, face planes, merged faces, loops, edges) equal the JAX
    package's; ints exactly, floats to 1e-7 (both builders compute in
    float64 numpy and round once to float32)."""
    jscene, tscene = scenes(name)
    want = {}
    _flatten_jax("", jscene, want)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("hulls.loop_pts") for k in got)
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, k
        else:
            assert np.array_equal(g, w), k
    assert fs.fused2_eligible(tscene)


def test_settle_tables_and_launch_geometry():
    """Config 3's fused-step tables: 16 bodies + the dummy, 19 colliders,
    165 pair rows in five recipes, 13 joints; at 4096 envs eight one-warp
    envs a block of 256 threads and 45,136 bytes of shared memory (5,632
    an env, 80 the block's inverse masses); the hull block the kernel reads equals the
    scene's hull arrays, and every hull collider points at it."""
    _jscene, tscene = scenes("settle")
    tab = fs.fused_tables(tscene, "cpu")
    assert (tab.num_bodies, tab.num_colliders, tab.num_rows) == (17, 19, 165)
    rows = {fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]]]: m["pg"]
            for m in tab.metas}
    assert rows == {"capsule_capsule": 99, "capsule_box": 45,
                    "capsule_hull": 15, "box_box": 3, "box_hull": 3}
    assert tab.joint_counts["hinge"] == 6 and tab.joint_counts[
        "cone_twist"] == 7
    plan = tab.launch_plan(4096)
    assert (plan.envs, plan.warps, plan.threads) == (8, 1, 256)
    assert (plan.smem_bytes, plan.env_bytes, plan.block_bytes) == (
        45136, 5632, 80)
    V, F, FU, LM, EU = tab.hull_dims
    assert (V, F, FU, LM, EU) == (8, 12, 6, 4, 3)
    h = tscene.hulls
    block = tab.ftab[tab.hull_offs[2]:].numpy()
    want = np.concatenate([x[0].reshape(-1).float().numpy() for x in (
        h.vertices, torch.cat([h.face_normals, h.face_offsets[..., None],
                               h.face_mask[..., None].float()], -1),
        h.poly_normals, h.poly_mask, h.loop_pts, h.edge_dirs, h.edge_mask)])
    assert np.array_equal(block, want)
    hull_col = tab.itab[tab.hull_offs[0]:tab.hull_offs[0] + 19].numpy()
    assert np.array_equal(hull_col, tscene.colliders.hull_id.numpy())
    assert tab.itab[tab.hull_offs[1]:tab.hull_offs[1] + FU].tolist() == [4] * 6


# ---------------------------------------------------------------------------
# the fused step against the JAX package's, one env


def _touching_settle_state():
    """Config 3 lowered so that the feet press 3 mm into the ground, a
    seeded velocity noise on the ragdoll, and the debris cube on the ground
    (4 mm deep) against the right shin capsule (1 cm deep)."""
    _jscene, tscene = scenes("settle")
    st = tscene.initial_state(1)
    mn, _mx = collider_aabbs(tscene, world_colliders(tscene, st.pos, st.rot))
    deb = tscene.num_bodies - 1
    rag = slice(1, deb)
    pos = st.pos.clone()
    pos[:, rag, 1] -= float(mn[0, 1:-1, 1].min()) + 0.003
    w = world_colliders(tscene, pos, st.rot)
    shin = int((tscene.colliders.body == 12).nonzero()[0, 0])
    low = torch.where(w.a[0, shin, 1] < w.b[0, shin, 1], w.a[0, shin],
                      w.b[0, shin])
    r = float(tscene.colliders.r[shin])
    h = chip_smoke.DEBRIS_HALF
    pos[0, deb] = torch.tensor([float(low[0]) + r + h - 0.01, h - 0.004,
                                float(low[2])])
    rng = np.random.default_rng(11)
    lin = st.lin_vel.clone()
    lin[:, rag] += torch.from_numpy(
        rng.normal(size=(1, deb - 1, 3)).astype(np.float32) * 0.05)
    return st.replace(pos=pos, lin_vel=lin)


def _pile_state():
    """One env of chip_smoke.pile_poses: the three hulls turned at random."""
    _jscene, tscene = scenes("pile")
    st = chip_smoke.pile_poses(tscene, 2, seed=5)
    return st.replace(**{k: getattr(st, k)[1:] for k in FIELDS})


def _trajectory(name, state, steps):
    """`steps` steps of one env: the JAX package's eager unbatched "fused"
    step and the port's plain version, with the port's contact mask."""
    jscene, tscene = scenes(name)
    jsettings = JaxPhysicsSettings(num_rigid_solver_iterations=ITERS,
                                   solver_mode="fused")
    base = jscene.initial_state()
    jst = base.replace(**{k: jnp.asarray(getattr(state, k)[0].numpy())
                          for k in FIELDS})
    tst = state_from_numpy({k: getattr(state, k).numpy() for k in FIELDS}
                           | {"controls": None}, device="cpu")
    tsettings = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                                solver_mode="fused")
    out = []
    for _ in range(steps):
        # op by op, as tests/test_torch_shapes.py runs its JAX steps: a
        # third quicker than each jnp call compiling on its own here
        with jax.disable_jit():
            jst = jax_physics_step(jscene, jst, jsettings, DT)[0]
        tst, info = physics_step(tscene, tst, tsettings, DT)
        out.append((jst, tst, info))
    return out


@pytest.fixture(scope="module")
def settle_run():
    return _trajectory("settle", _touching_settle_state(), 3)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b[0].numpy()).max())


def _live_by_recipe(name, info):
    tab = fs.fused_tables(scenes(name)[1], "cpu")
    live = info.contact_mask[0].any(dim=-1) if info.contact_mask.dim() == 3 \
        else info.contact_mask[0]
    out, r0 = {}, 0
    for m in sorted(tab.metas, key=lambda m: m["phase"]):
        name_ = fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]]]
        out[name_] = out.get(name_, 0) + int(live[r0:r0 + m["pg"]].sum())
        r0 += m["pg"]
    return out


def test_settle_one_step_matches_jax(settle_run):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations, with the debris touching the ground (box-hull)
    and a shin (capsule-hull) and the feet on the ground."""
    jst, tst, info = settle_run[0]
    live = _live_by_recipe("settle", info)
    assert live["capsule_hull"] > 0 and live["box_hull"] > 0, live
    assert live["box_box"] > 0, live
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-5
    assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-5


def test_settle_three_steps_match_jax(settle_run):
    """≤1e-4 after each of three steps on every state field."""
    for jst, tst, _info in settle_run:
        for k in ("pos", "rot", "lin_vel", "ang_vel"):
            assert _diff(getattr(jst, k), getattr(tst, k)) <= 1e-4, k
        assert bool(torch.isfinite(tst.ang_vel).all())


def test_pile_one_step_matches_jax():
    """The hull pile, one env at seeded random turns, one step: box-hull and
    hull-hull rows live; ≤1e-6 on positions and rotations, ≤1e-5 on
    velocities."""
    (jst, tst, info), = _trajectory("pile", _pile_state(), 1)
    live = _live_by_recipe("pile", info)
    assert live["box_hull"] > 0 and live["hull_hull"] > 0, live
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-5
    assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-5
