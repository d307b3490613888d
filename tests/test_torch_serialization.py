"""Port parity, module scene/serialization.py: scene JSON and state npz
written by one package and read by the other.

  - builder_to_dict of the same scene built by each package's builder: the
    same dict, exactly (same keys, same values), after a JSON round trip;
  - a scene file written by the port, loaded and finalized by the JAX
    package, equals the JAX package's own scene, and the other way round
    (every static array exact);
  - a state npz written by each package restores in the other, values
    exact (the port broadcasts a JAX state, which has no env axis, to its
    template's batch);
  - tests/test_utils.py's round trips on the port, and a reloaded hull
    scene stepping bit for bit as the original;
  - files with cloths (several, or one under the older "cloth" key) and
    ownerless force fields loaded by both packages to the same scene, and a
    cloth scene written by either loaded by the other; a State carrying a
    ClothState round-tripped within the port and across the packages;
  - a file with triggers or a force field that has an owner loaded by
    both packages to the same scene (tests/test_torch_triggers.py
    round-trips whole trigger scenes)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene import serialization as jser
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene import serialization as tser
from dxk_tpu_torch.utils.convert import scene_arrays

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

HULL = np.array([[0.4, 0, 0], [-0.3, 0.25, 0.1], [0, -0.2, 0.35],
                 [-0.1, -0.15, -0.3], [0.1, 0.3, -0.2]])


def build(builder):
    """A ground box, a ball on a hinge to the ground's owner, a capsule on
    a cone-twist joint, and an irregular hull body."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    ball = b.add_body(position=(0, 3, 0))
    b.add_sphere_collider(ball, (0, 0, 0), 0.5)
    b.add_hinge_constraint(0, ball, (0, 3, 0), (0, 1, 0))
    cap = b.add_body(position=(1.0, 3.0, 0.0))
    b.add_capsule_collider(cap, (-0.3, 0, 0), (0.3, 0, 0), 0.1)
    b.add_cone_twist_constraint(ball, cap, (0.5, 3.0, 0.0), (1, 0, 0), 0.5,
                                0.3)
    hid = b.add_hull_geometry_from_mesh(HULL)
    body = b.add_body(position=(3, 1.0, 0), rotation=(0.2, 0.1, 0, 0.97))
    b.add_hull_collider(body, hid)
    return b


def _json(d):
    return json.loads(json.dumps(d))


def test_builder_dicts_equal():
    assert _json(tser.builder_to_dict(build(SceneBuilder))) == _json(
        jser.builder_to_dict(build(JaxSceneBuilder)))


def _assert_scenes_equal(tscene, jscene):
    arrays = scene_arrays(tscene)
    assert arrays
    for k, v in arrays.items():
        obj = jscene
        for part in k.split("."):
            obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
        np.testing.assert_array_equal(v, np.asarray(obj), err_msg=k)


def test_port_file_loads_in_jax(tmp_path):
    path = str(tmp_path / "scene.json")
    tser.save_scene(path, build(SceneBuilder))
    _assert_scenes_equal(build(SceneBuilder).finalize(device="cpu"),
                         jser.load_scene(path).finalize())


def test_jax_file_loads_in_port(tmp_path):
    path = str(tmp_path / "scene.json")
    jser.save_scene(path, build(JaxSceneBuilder))
    _assert_scenes_equal(tser.load_scene(path).finalize(device="cpu"),
                         build(JaxSceneBuilder).finalize())


def _seeded_fields(scene, rng):
    st = scene.initial_state()
    return st.replace(
        pos=st.pos + jnp.asarray(rng.normal(size=st.pos.shape), jnp.float32),
        lin_vel=jnp.asarray(rng.normal(size=st.lin_vel.shape), jnp.float32),
        controls=st.controls.replace(hinge_target=jnp.asarray(
            rng.normal(size=st.controls.hinge_target.shape), jnp.float32)))


def test_jax_state_loads_in_port(tmp_path):
    jscene = build(JaxSceneBuilder).finalize()
    tscene = build(SceneBuilder).finalize(device="cpu")
    jst = _seeded_fields(jscene, np.random.default_rng(0))
    path = str(tmp_path / "state.npz")
    jser.save_state(path, jst)
    tst = tser.load_state(path, tscene.initial_state(2))
    for k in ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc"):
        for e in range(2):
            np.testing.assert_array_equal(getattr(tst, k)[e].numpy(),
                                          np.asarray(getattr(jst, k)))
    for k, v in vars(tst.controls).items():
        assert v.dtype == getattr(tscene.default_controls, k).dtype
        np.testing.assert_array_equal(v[1].numpy(),
                                      np.asarray(getattr(jst.controls, k)))


def test_port_state_loads_in_jax(tmp_path):
    jscene = build(JaxSceneBuilder).finalize()
    tscene = build(SceneBuilder).finalize(device="cpu")
    st = tscene.initial_state(1)
    st, _ = physics_step(tscene, st, PhysicsSettings(
        num_rigid_solver_iterations=4, solver_mode="jacobi"), 1 / 120)
    path = str(tmp_path / "state.npz")
    tser.save_state(path, st)
    restored = jser.load_state(path, jscene.initial_state())
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == 6 + 13
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        np.testing.assert_array_equal(np.asarray(getattr(restored, k))[0],
                                      getattr(st, k)[0].numpy())
    np.testing.assert_array_equal(
        np.asarray(restored.controls.ct_twist_max_torque)[0],
        st.controls.ct_twist_max_torque[0].numpy())


def test_scene_and_state_roundtrip(tmp_path):
    """tests/test_utils.py's round trips: the reloaded scene equals the
    original, the reloaded state equals the saved one."""
    b = build(SceneBuilder)
    path = str(tmp_path / "scene.json")
    tser.save_scene(path, b)
    s1 = b.finalize(device="cpu")
    s2 = tser.load_scene(path).finalize(device="cpu")
    a1, a2 = scene_arrays(s1), scene_arrays(s2)
    assert a1.keys() == a2.keys()
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)
    settings = PhysicsSettings(num_rigid_solver_iterations=4,
                               solver_mode="jacobi")
    st1 = st2 = s1.initial_state(2)
    for _ in range(5):
        st1 = physics_step(s1, st1, settings, 1 / 120)[0]
        st2 = physics_step(s2, st2, settings, 1 / 120)[0]
    assert torch.equal(st1.pos, st2.pos) and torch.equal(st1.rot, st2.rot)
    spath = str(tmp_path / "state.npz")
    tser.save_state(spath, st1)
    restored = tser.load_state(spath, s1.initial_state(2))
    assert torch.equal(restored.pos, st1.pos)
    assert torch.equal(restored.controls.hinge_max_torque,
                       st1.controls.hinge_max_torque)


@pytest.mark.parametrize("key,value", [
    ("num_triggers", 1), ("force_fields", [{"force": [0, 1, 0],
                                            "owner": 0}])])
def test_unported_content_refused(key, value):
    """Triggers and force fields with an owner, which the port refused
    until they were ported (the test keeps its name): such a file loads in
    the port and in the JAX package to the same builder, and finalizes to
    the same scene (every static array exact). Whole trigger and
    owned-field scenes: tests/test_torch_triggers.py."""
    d = _json(tser.builder_to_dict(build(SceneBuilder)))
    d[key] = value
    tb, jb = tser.builder_from_dict(_json(d)), jser.builder_from_dict(
        _json(d))
    assert _json(tser.builder_to_dict(tb)) == _json(jser.builder_to_dict(jb))
    assert _json(tser.builder_to_dict(tb))[key] == value
    _assert_scenes_equal(tb.finalize(device="cpu"), jb.finalize())


CLOTH = dict(width=2.0, height=1.5, grid_x=6, grid_y=5, total_mass=1.0,
             stiffness=0.8, damping=0.4, gravity_factor=1.0,
             thickness=0.05, pos=[0.5, 3.0, 0.2], rot=[0.0, 0.0, 0.0, 1.0])


@pytest.mark.parametrize("key,value", [
    ("force_fields", [{"force": [0, 1, 0], "owner": None},
                      {"force": [0.5, 0, -2], "owner": None}]),
    ("cloths", [CLOTH, dict(CLOTH, pos=[4.0, 2.0, 0.0], thickness=0.0)]),
    ("cloth", CLOTH)])
def test_cloth_content_loads(key, value):
    """A file with ownerless force fields, cloths, or one cloth under the
    older singular "cloth" key: the port and the JAX package load the same
    builder from it, and finalize the same scene (every array exact)."""
    d = _json(tser.builder_to_dict(build(SceneBuilder)))
    d[key] = value
    tb, jb = tser.builder_from_dict(_json(d)), jser.builder_from_dict(
        _json(d))
    assert _json(tser.builder_to_dict(tb)) == _json(jser.builder_to_dict(jb))
    tscene = tb.finalize(device="cpu")
    _assert_scenes_equal(tscene, jb.finalize())
    if key == "force_fields":
        np.testing.assert_array_equal(tscene.global_ff_force.numpy(),
                                      np.float32([0.5, 1.0, -2.0]))
    else:
        assert tscene.cloth is not None


def _cloth_builder(builder):
    b = build(builder)
    b.add_cloth(**{k: v for k, v in CLOTH.items() if k not in ("pos",
                                                               "rot")},
                transform_pos=CLOTH["pos"], transform_rot=CLOTH["rot"])
    b.add_force_field((0.0, 0.0, 3.0))
    return b


def test_cloth_scene_files_load_in_both(tmp_path):
    """A cloth scene written by either package loads in the other."""
    path = str(tmp_path / "scene.json")
    tser.save_scene(path, _cloth_builder(SceneBuilder))
    _assert_scenes_equal(_cloth_builder(SceneBuilder).finalize(device="cpu"),
                         jser.load_scene(path).finalize())
    jser.save_scene(path, _cloth_builder(JaxSceneBuilder))
    _assert_scenes_equal(tser.load_scene(path).finalize(device="cpu"),
                         _cloth_builder(JaxSceneBuilder).finalize())


def test_cloth_state_roundtrip(tmp_path):
    """A State that carries a ClothState: the port's npz reloads into the
    port bit for bit, and into the JAX package (leaves in the JAX order,
    the cloth's last); the JAX package's loads into the port."""
    tscene = _cloth_builder(SceneBuilder).finalize(device="cpu")
    jscene = _cloth_builder(JaxSceneBuilder).finalize()
    settings = PhysicsSettings(num_rigid_solver_iterations=4,
                               solver_mode="jacobi",
                               cloth_solver_mode="colored")
    st = tscene.initial_state(2)
    for _ in range(3):
        st = physics_step(tscene, st, settings, 1 / 120)[0]
    path = str(tmp_path / "state.npz")
    tser.save_state(path, st)
    back = tser.load_state(path, tscene.initial_state(2))
    for f in ("positions", "prev_positions", "velocities", "forces"):
        assert torch.equal(getattr(back.cloth, f), getattr(st.cloth, f))
    assert torch.equal(back.pos, st.pos)
    restored = jser.load_state(path, jscene.initial_state())
    assert len(jax.tree_util.tree_leaves(restored)) == 6 + 13 + 4
    np.testing.assert_array_equal(
        np.asarray(restored.cloth.positions)[1],
        st.cloth.positions[1].numpy())
    jst = jscene.initial_state()
    jst = jst.replace(cloth=jst.cloth.replace(
        velocities=jst.cloth.velocities + 0.25))
    jser.save_state(path, jst)
    tst = tser.load_state(path, tscene.initial_state(3))
    for e in range(3):
        np.testing.assert_array_equal(tst.cloth.velocities[e].numpy(),
                                      np.asarray(jst.cloth.velocities))
        np.testing.assert_array_equal(tst.cloth.positions[e].numpy(),
                                      np.asarray(jst.cloth.positions))
