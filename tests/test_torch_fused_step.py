"""Port parity, modules ops/kernels/fused_step.py, physics.py, ops/shapes.py
and ops/integrator.py: one fused physics step of the locomotion scene from a
batch of perturbed states, port plain version vs the JAX package's "fused"
mode (interpret-mode Pallas on the CPU, as tests/test_fused_solver.py runs
it).

The JAX side is one compiled program, `jax_reference()`: the batch-128,
10-iteration, poke-free env step, which also hands out the StepInfo of the
physics step inside it. tests/test_torch_loco_env.py imports it from here, so
one process compiles the fused locomotion program once for both files."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.envs import loco_env as jle
from dxk_tpu.ops import integrator as jint
from dxk_tpu.ops import shapes as jshapes
from dxk_tpu_torch.envs.loco_env import LocoEnv as TorchLocoEnv
from dxk_tpu_torch.ops import integrator as tint
from dxk_tpu_torch.ops import shapes as tshapes
from dxk_tpu_torch.ops.kernels import fused_step as fs
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.utils.convert import state_from_numpy

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

B = 5            # the port's batch: ragged, no multiple of any block size
JAX_B = 128      # the batch the JAX program is compiled for
ITERS = 10
DT = 1.0 / 60.0
ENV_KW = dict(solver_iterations=ITERS, solver_mode="fused",
              enable_pokes=False)


@functools.lru_cache(maxsize=None)
def jax_reference():
    """(JAX LocoEnv, jit(vmap(step))) where step(env_state, action) returns
    (env.step's outputs, the StepInfo of its physics step). The info is
    picked up while env.step is traced, by wrapping the physics_step name it
    calls; the JAX package itself is untouched."""
    jenv = jle.LocoEnv(**ENV_KW)

    def step(env_state, action):
        infos = []
        physics_step_orig = jle.physics_step

        def physics_step_keep_info(*args, **kwargs):
            out = physics_step_orig(*args, **kwargs)
            infos.append(out[1])
            return out

        jle.physics_step = physics_step_keep_info
        try:
            out = jenv.step(env_state, action)
        finally:
            jle.physics_step = physics_step_orig
        return out, infos[0]

    return jenv, jax.jit(jax.vmap(step))


@pytest.fixture(scope="module")
def envs():
    return jax_reference()[0], TorchLocoEnv(device="cpu", **ENV_KW)


@pytest.fixture(scope="module")
def states(envs):
    """Perturbed standing poses as numpy: joints slightly apart, feet
    pressed into the ground, bodies moving, motors driven."""
    _jenv, tenv = envs
    rng = np.random.default_rng(11)
    init = tenv.scene.initial_state(B)
    n1 = init.pos.shape[1]
    pos = init.pos.numpy() + rng.normal(size=(B, n1, 3)) * 0.003
    pos[..., 1] -= 0.135        # the ragdoll starts 0.12 m above the ground
    rot = init.rot.numpy() + rng.normal(size=(B, n1, 4)) * 0.01
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    fields = dict(
        pos=pos, rot=rot,
        lin_vel=rng.normal(size=(B, n1, 3)) * 0.2,
        ang_vel=rng.normal(size=(B, n1, 3)) * 0.3,
        force_acc=rng.normal(size=(B, n1, 3)) * 5.0,
        torque_acc=rng.normal(size=(B, n1, 3)) * 0.2)
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    for k in fields:                     # the dummy body stays pinned
        fields[k][:, -1] = init.__dict__[k].numpy()[:, -1]
    action = rng.uniform(-0.2, 0.2, (B, 27)).astype(np.float32)
    fields["action"] = action
    ctl = tenv._controls_from_action(torch.from_numpy(action))
    fields["controls"] = {f.name: getattr(ctl, f.name).numpy()
                          for f in dataclasses.fields(ctl)}
    return fields


def _jax_state(jenv, fields):
    base = jenv.scene.initial_state()
    ctl = base.controls.replace(**{
        k: jnp.asarray(v) for k, v in fields["controls"].items()})
    return base.replace(controls=ctl, **{
        k: jnp.asarray(v) for k, v in fields.items()
        if k not in ("controls", "action")})


@pytest.fixture(scope="module")
def stepped(envs, states):
    """(JAX state', JAX info, port state', port info) after one step.

    The JAX env step runs on the B states repeated up to its compiled batch;
    with the smoothed action equal to the action, its EMA leaves the action as
    it is, so its physics step sees the controls the port is given. No env
    falls, so no auto-reset replaces a stepped state."""
    jenv, tenv = envs
    rep = np.arange(JAX_B) % B
    physics = jax.tree_util.tree_map(lambda a: a[rep],
                                     _jax_state(jenv, states))
    action = jnp.asarray(states["action"][rep])
    env_state = jle.EnvState(
        physics=physics, smoothed_action=action,
        rng=jax.random.split(jax.random.PRNGKey(0), JAX_B),
        steps=jnp.zeros((JAX_B,), jnp.int32))
    (jenv_state, _obs, _rew, jdone), jinfo = jax_reference()[1](env_state,
                                                                action)
    assert not bool(jdone.any())
    jst = jax.tree_util.tree_map(lambda a: a[:B], jenv_state.physics)
    jinfo = jax.tree_util.tree_map(lambda a: a[:B], jinfo)
    tst, tinfo = physics_step(
        tenv.scene, state_from_numpy(states, device="cpu"),
        PhysicsSettings(num_rigid_solver_iterations=ITERS,
                        solver_mode="fused"), DT)
    return jst, jinfo, tst, tinfo


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def test_world_colliders_and_aabbs(envs, states):
    """ops/shapes.py: ≤1e-6 (one rotation and one add per value)."""
    jenv, tenv = envs
    jw = jax.vmap(lambda p, r: jshapes.world_colliders(jenv.scene, p, r))(
        jnp.asarray(states["pos"]), jnp.asarray(states["rot"]))
    tw = tshapes.world_colliders(tenv.scene, torch.from_numpy(states["pos"]),
                                 torch.from_numpy(states["rot"]))
    for name in ("a", "b", "rot"):
        assert _diff(getattr(jw, name), getattr(tw, name)) <= 1e-6, name
    jmn, jmx = jax.vmap(lambda w: jshapes.collider_aabbs(jenv.scene, w))(jw)
    tmn, tmx = tshapes.collider_aabbs(tenv.scene, tw)
    assert _diff(jmn, tmn) <= 2e-6 and _diff(jmx, tmx) <= 2e-6


def test_integrate_forces(envs, states):
    """ops/integrator.py, first half: ≤1e-6 on velocities of O(1), ≤1e-5
    on the world inverse inertia (entries up to ~1e2, two 3x3 products)."""
    jenv, tenv = envs
    jb = jax.vmap(lambda s: jint.integrate_forces(jenv.scene, s, DT))(
        _jax_state(jenv, states))
    tb = tint.integrate_forces(tenv.scene,
                               state_from_numpy(states, device="cpu"),
                               float(np.float32(DT)))
    assert _diff(jb.v, tb.v) <= 1e-6 and _diff(jb.w, tb.w) <= 1e-6
    assert _diff(jb.pos_cog, tb.pos_cog) <= 1e-6
    scale = float(np.abs(np.asarray(jb.inv_inertia)).max())
    assert _diff(jb.inv_inertia, tb.inv_inertia) <= 1e-6 * max(scale, 1.0)


def test_one_step_matches_jax(stepped):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations: both sides run the same float32 operations;
    XLA:CPU contracts multiply-adds and sums the per-body deltas through a
    matrix product, PyTorch in list order."""
    jst, _jinfo, tst, _tinfo = stepped
    assert _diff(jst.pos, tst.pos) <= 1e-6
    assert _diff(jst.rot, tst.rot) <= 1e-6
    assert _diff(jst.lin_vel, tst.lin_vel) <= 1e-5
    assert _diff(jst.ang_vel, tst.ang_vel) <= 1e-5
    assert float(tst.force_acc.abs().max()) == 0.0
    assert float(tst.torque_acc.abs().max()) == 0.0


def test_contact_info_matches_jax(envs, stepped):
    """Liveness of every pair row equal; summed normal impulses ≤1e-5. The
    perturbed states put live rows into the ground groups."""
    jenv, tenv = envs
    _jst, jinfo, _tst, tinfo = stepped
    assert np.array_equal(np.asarray(jinfo.contact_pairs)[0],
                          tinfo.contact_pairs.numpy())
    jm, tm = np.asarray(jinfo.contact_mask), tinfo.contact_mask.numpy()
    assert np.array_equal(jm, tm)
    assert _diff(jinfo.contact_impulse, tinfo.contact_impulse) <= 1e-5
    assert np.array_equal(np.asarray(jinfo.num_contacts),
                          tinfo.num_contacts.numpy())
    ctype = tenv.scene.colliders.ctype.numpy()
    pairs = tinfo.contact_pairs.numpy()
    kinds = {tuple(sorted(int(t) for t in ctype[p]))
             for p in pairs[tm.any(0)]}
    assert {(1, 3), (3, 3)} <= kinds


def test_ragged_batch_and_single_env(envs, states):
    """The plain version has no batch padding: env i of a batch equals the
    same env stepped alone, bit for bit."""
    _jenv, tenv = envs
    settings = PhysicsSettings(num_rigid_solver_iterations=3,
                               solver_mode="fused")
    full, _ = physics_step(tenv.scene, state_from_numpy(states, "cpu"),
                           settings, DT)
    one = {k: (v[2:3] if k != "controls"
               else {f: x[2:3] for f, x in v.items()})
           for k, v in states.items()}
    single, _ = physics_step(tenv.scene, state_from_numpy(one, "cpu"),
                             settings, DT)
    assert torch.equal(full.pos[2:3], single.pos)
    assert torch.equal(full.ang_vel[2:3], single.ang_vel)


def test_tables_and_launch_geometry(envs):
    """The static tables the CUDA kernel indexes: 147 rows, 300 point
    slots; the launch plan at 4096 envs packs eight one-warp envs into a
    block of 256 threads, whose shared memory (the envs' and the block's
    words, no point slot) is within the card's limits."""
    _jenv, tenv = envs
    assert fs.fused2_eligible(tenv.scene)
    tab = fs.fused_tables(tenv.scene, "cpu")
    assert (tab.num_rows, tab.num_points) == (147, 300)
    assert tab.joint_counts == dict(distance=0, ball=0, fixed=0, hinge=6,
                                    cone_twist=7, slider=0)
    assert tab.ctl_rows == 67
    plan = tab.launch_plan(4096)
    assert (plan.envs, plan.warps, plan.threads, plan.blocks) == (8, 1, 256,
                                                                  512)
    block_w, env_w = tab.shared_layout()
    assert plan.smem_bytes == 4 * (block_w + 8 * env_w) <= 227 * 1024
    assert 4 * env_w < fs.POINT_FIELDS * 4 * tab.num_points
    rows = tab.itab[tab.ioffs[0]:tab.ioffs[1]].view(-1, fs.ROW_INTS)
    assert rows.shape[0] == 147
    assert sorted(set(rows[:, 0].tolist())) == [0, 1, 2]
    slots = set()
    for t, k, _ca, _cb, _ba, _bb, base, stride in rows.tolist():
        slots |= {base + i * stride for i in range(k)}
    assert slots == set(range(300))


def test_cuda_tensor_never_takes_plain_version(envs):
    """No card here: asking for the CUDA path must raise, not fall back."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError):
        TorchLocoEnv(device="cuda")


@pytest.mark.parametrize("kwargs", [
    dict(sequential=True), dict(joint_prep_in_kernel=False)])
def test_unported_solver_options_raise(envs, kwargs):
    """Both options are ported; the fused kernel does not take a scene
    with a dynamic broadphase (physics_step runs such a scene on the
    reference step), and make_fused_step_solver raises for it under
    each."""
    scene = envs[1].scene.replace(broadphase_k=8)
    with pytest.raises(NotImplementedError):
        fs.make_fused_step_solver(scene, 10, **kwargs)


def test_unported_solver_mode_raises(envs, states):
    """Every solver mode is ported now (the test keeps its name): "jacobi"
    on the loco scene, which the fused step takes only in the fused modes,
    runs the reference step and matches the JAX package's compiled step on
    one env (positions within 1e-6, velocities within 1e-5 of max(1,
    their largest)); LocoEnv(solver_mode="scan") builds the JAX package's
    capped tables."""
    jenv, tenv = envs
    tst = state_from_numpy(states, "cpu")
    tout = physics_step(tenv.scene, tst, PhysicsSettings(
        num_rigid_solver_iterations=ITERS, solver_mode="jacobi"), DT)[0]
    jsettings = dataclasses.replace(jenv.settings, solver_mode="jacobi")
    jst = jenv.scene.initial_state()
    jst = jst.replace(
        controls=jst.controls.replace(**{
            k: jnp.asarray(v[0]) for k, v in states["controls"].items()}),
        **{k: jnp.asarray(states[k][0]) for k in (
            "pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")})
    from dxk_tpu.physics import physics_step as jax_physics_step
    jout = jax.jit(lambda s: jax_physics_step(jenv.scene, s, jsettings,
                                              DT)[0])(jst)
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        want = np.asarray(getattr(jout, k))
        tol = 1e-6 if k in ("pos", "rot") else 1e-5 * max(
            1.0, float(np.abs(want).max()))
        assert np.abs(getattr(tout, k)[0].numpy() - want).max() <= tol, k
    env = TorchLocoEnv(solver_mode="scan", device="cpu")
    assert env.settings.solver_mode == "scan"
    assert [g.max_narrow for g in env.scene.pair_groups] == [
        g.max_narrow for g in jle.LocoEnv().scene.pair_groups]
