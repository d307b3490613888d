"""Port parity, modules scene/scene.py, scene/native.py, scene/builder.py and
models/ragdoll.py: the locomotion Scene built by the port equals the JAX
package's Scene array for array."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dxk_tpu.envs.loco_env import LocoEnv as JaxLocoEnv
from dxk_tpu.models import ragdoll as jrag
from dxk_tpu_torch.envs.loco_env import LocoEnv as TorchLocoEnv
from dxk_tpu_torch.models import ragdoll as trag
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils.convert import scene_arrays

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


def _flatten_jax(prefix, obj, out):
    """The JAX Scene as the same flat {dotted.name: ndarray} dict that
    utils.convert.scene_arrays makes of the port's."""
    if obj is None:
        return
    if isinstance(obj, (jax.Array, np.ndarray)):
        out[prefix] = np.asarray(obj)
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            _flatten_jax(f"{prefix}.{i}", x, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten_jax(f"{prefix}.{f.name}" if prefix else f.name,
                         getattr(obj, f.name), out)
    elif isinstance(obj, (int, float, str, bool)):
        out[prefix] = np.asarray(obj)


TARGETS = {"standing": (0.0, 0.0, 0.0), "walking": (1.0, 0.0, 0.0)}


@pytest.fixture(scope="module", params=sorted(TARGETS))
def envs(request):
    tgt = TARGETS[request.param]
    return (JaxLocoEnv(solver_mode="fused", torso_velocity_target=tgt),
            TorchLocoEnv(solver_mode="fused", torso_velocity_target=tgt,
                         device="cpu"))


def test_scene_arrays_equal(envs):
    """Ints, bools and strings exactly; floats to 1e-7 (both builders
    compute in float64 numpy and round once to float32)."""
    jenv, tenv = envs
    want = {}
    _flatten_jax("", jenv.scene, want)
    got = scene_arrays(tenv.scene)
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, name
        else:
            assert np.array_equal(g, w), name


def test_loco_scene_shape(envs):
    """The counts the fused-step kernel is sized for."""
    scene = envs[1].scene
    assert scene.num_bodies == 15
    assert sorted(scene.colliders.ctype.tolist()) == [1] * 15 + [3] * 3
    rows = sorted((int(g.type_a), int(g.type_b), int(g.pairs.shape[0]),
                   int(g.phase)) for g in scene.pair_groups)
    assert rows == [(1, 1, 99, 0), (1, 3, 45, 0), (3, 3, 3, 0)]
    assert scene.hinge.body_a.shape[0] == 6
    assert scene.cone_twist.body_a.shape[0] == 7


def test_env_constants_equal(envs):
    jenv, tenv = envs
    assert tenv.obs_size == jenv.obs_size
    for name in ("local_points", "target_positions", "target_velocities",
                 "target_local_rotations", "action_min", "action_max"):
        got = getattr(tenv, name).numpy()
        want = np.asarray(getattr(jenv, name))
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-6, name
    assert abs(tenv.head_target_height - jenv.head_target_height) <= 1e-7


def test_ragdoll_tables():
    assert trag.BODY_PART_NAMES == jrag.BODY_PART_NAMES
    assert trag.BODY_PART_PARENTS == jrag.BODY_PART_PARENTS
    assert trag.SCALE == jrag.SCALE


def _trigger_volume(b):
    """A trigger volume (Queue A 5c): a box over the sphere."""
    owner = b.add_static(position=(0.0, 2.0, 0.0))
    b.add_box_collider(owner, (0, 0, 0), (0.5, 0.5, 0.5))
    b.mark_trigger(owner)


def _owned_force_field(b):
    """A force field with an owner (Queue A 5c), turned with its owner."""
    owner = b.add_static(position=(1.0, 0.5, 0.0),
                         rotation=(0.0, 0.0, 0.3826834, 0.9238795))
    b.add_box_collider(owner, (0, 0, 0), (0.5, 0.5, 0.5))
    b.add_force_field((0.0, 5.0, 0.0), owner=owner)


def _orbit_margin(b):
    """finalize(orbit_margin=...) (Queue A 5b)."""
    return dict(orbit_margin=0.25)


@pytest.mark.parametrize("call", [
    _owned_force_field,
    _trigger_volume,
    _orbit_margin,
])
def test_unported_builder_features_raise(call):
    """The builder features that raised NotImplementedError until they were
    ported (the test keeps its name): each builds, on a ground box and a
    sphere, the same Scene as the JAX package's builder (ints exactly, floats to 1e-7)."""
    def make(builder):
        b = builder()
        g = b.add_static()
        b.add_box_collider(g, (0, -1, 0), (5, 1, 5))
        bd = b.add_body(position=(0, 1, 0))
        b.add_sphere_collider(bd, (0, 0, 0), 0.5)
        return b, call(b) or {}
    from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
    tb, kw = make(SceneBuilder)
    jb, _ = make(JaxSceneBuilder)
    want = {}
    _flatten_jax("", jb.finalize(**kw), want)
    want.pop("heightfield", None)
    got = scene_arrays(tb.finalize(device="cpu", **kw))
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, name
        else:
            assert np.array_equal(g, w), name
    if call is not _orbit_margin:
        assert got["overlap_pairs"].shape == (1, 2)


def _box_towers(builder):
    """bench.py's box stack at a small size: 2 towers of 4 unit boxes on a
    200 x 2 x 200 ground box."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (200, 1, 200))
    for t in range(2):
        for i in range(4):
            body = b.add_body(position=(t * 3.0, 0.5 + 1.001 * i, 0.0))
            b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


@pytest.mark.parametrize("broadphase", ["table", "kselect", "sap"])
def test_box_stack_scene_arrays_equal(broadphase):
    """The box stack finalized with bench.py's box-stack options (capped
    pair groups in 4 contact phases) under each broadphase: pair groups,
    phases, caps, broadphase settings and the broad statics equal the JAX
    package's, array for array."""
    from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
    kw = dict(max_narrow_pairs_per_group=4, contact_phases=4,
              broadphase=broadphase, broadphase_k=8)
    want = {}
    _flatten_jax("", _box_towers(JaxSceneBuilder).finalize(**kw), want)
    tscene = _box_towers(SceneBuilder).finalize(device="cpu", **kw)
    got = scene_arrays(tscene)
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= 1e-7, name
        else:
            assert np.array_equal(g, w), name
    assert tscene.num_contact_phases == 4
    assert sorted({g.phase for g in tscene.pair_groups}) == [0, 1, 2, 3]
    assert all(g.max_narrow == 4 for g in tscene.pair_groups)
    assert tscene.sap_broad == ((0,) if broadphase == "sap" else ())
    assert tscene.broadphase_k == (0 if broadphase == "table" else 8)


def test_initial_state_batch():
    env = TorchLocoEnv(solver_mode="fused", device="cpu")
    st = env.scene.initial_state(3)
    assert st.pos.shape == (3, 16, 3) and st.rot.shape == (3, 16, 4)
    assert st.pos.dtype == torch.float32
    assert torch.equal(st.pos[0], st.pos[2])
