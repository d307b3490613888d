"""Port parity, modules ops/raycast.py, envs/loco_env.py and models/policy.py,
and the served slice as a whole: reset, observation, reward, termination,
gait reference, pokes and three env steps against the JAX package, plus the
policy forward pass with converted weights.

The JAX side's compiled env step (batch 128, 10 iterations, poke-free) is
the program tests/test_torch_fused_step.py builds, imported from there so
that one process compiles it once; everything else on the JAX side runs
eagerly."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.envs import loco_env as jle
from dxk_tpu.models.policy import ActorCritic as JaxActorCritic
from dxk_tpu.ops import raycast as jrc
from dxk_tpu.physics import apply_ray_impulse as jax_apply_ray_impulse
from dxk_tpu_torch.envs import loco_env as tle
from dxk_tpu_torch.models.policy import ActorCritic, make_policy, policy_apply
from dxk_tpu_torch.ops import raycast as trc
from dxk_tpu_torch.physics import apply_ray_impulse
from dxk_tpu_torch.utils.convert import (env_state_from_numpy,
                                         policy_state_dict_from_flax,
                                         policy_state_dict_from_npz,
                                         state_from_numpy)
from test_torch_fused_step import ENV_KW, JAX_B, jax_reference

B = JAX_B
STATE_KEYS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


def _np_state(jstate):
    out = {k: np.asarray(getattr(jstate, k)) for k in STATE_KEYS}
    out["controls"] = {k: np.asarray(v)
                       for k, v in vars(jstate.controls).items()}
    return out


def _diff(a, b):
    """Max abs difference; NaNs must sit at the same places."""
    a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.abs(np.nan_to_num(a) - np.nan_to_num(b)).max(initial=0.0))


@pytest.fixture(scope="module")
def envs():
    return jax_reference()[0], tle.LocoEnv(device="cpu", **ENV_KW)


@pytest.fixture(scope="module")
def walk_envs():
    kw = dict(solver_iterations=10, solver_mode="fused", enable_pokes=False,
              torso_velocity_target=(1.0, 0.0, 0.0))
    return jle.LocoEnv(**kw), tle.LocoEnv(device="cpu", **kw)


@pytest.fixture(scope="module")
def rollout(envs):
    """Three steps of both envs on the same numpy actions. Returns the
    per-step (JAX outputs, port outputs) and the JAX env states."""
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    jstep_info = jax_reference()[1]

    def jstep(env_state, action):
        return jstep_info(env_state, action)[0]
    tst, tobs = tenv.reset(B)
    acts = np.random.default_rng(0).uniform(-1, 1, (3, B, 27)).astype(
        np.float32)
    trace = [((jst, jobs, None, None), (tst, tobs, None, None))]
    for a in acts:
        jout = jstep(jst, jnp.asarray(a))
        tout = tenv.step(tst, torch.from_numpy(a))
        jst, tst = jout[0], tout[0]
        trace.append((jout, tout))
    return jstep, trace


def test_constants():
    for name in ("ACTION_SIZE", "OBS_SIZE", "MOTOR_TORQUE", "ACTION_EMA_BETA",
                 "POKE_PROBABILITY", "POKE_STRENGTH", "DT", "FALL_HEAD_HEIGHT",
                 "GAIT_FREQUENCY", "TRACK_FAIL_DIST", "NUM_BODY_PARTS"):
        assert getattr(tle, name) == getattr(jle, name), name


def test_reset(rollout):
    (jst, jobs, _, _), (tst, tobs, _, _) = rollout[1][0]
    assert tobs.shape == (B, 66)
    assert _diff(jobs, tobs) <= 1e-6
    assert _diff(jst.physics.pos, tst.physics.pos) == 0.0
    assert int(tst.steps.abs().max()) == 0


def test_three_steps_match_jax(rollout):
    """≤1e-4 on observation, reward, positions and linear velocities after
    each of three steps (10 solver iterations each; rounding differences
    of 1e-6 per step grow through the contact solve). Angular velocities
    of the light limbs reach tens of rad/s under random motor targets and
    are held to 1e-4 relative to that scale."""
    for jout, tout in rollout[1][1:]:
        (jst, jobs, jrew, jdone), (tst, tobs, trew, tdone) = jout, tout
        assert np.array_equal(np.asarray(jdone), tdone.numpy())
        assert _diff(jobs, tobs) <= 1e-4
        assert _diff(jrew, trew) <= 1e-4
        assert _diff(jst.physics.pos, tst.physics.pos) <= 1e-4
        assert _diff(jst.physics.rot, tst.physics.rot) <= 1e-4
        assert _diff(jst.physics.lin_vel, tst.physics.lin_vel) <= 1e-4
        w_scale = max(1.0, float(np.abs(np.asarray(jst.physics.ang_vel)).max()))
        assert _diff(jst.physics.ang_vel, tst.physics.ang_vel) <= 1e-4 * w_scale
        assert _diff(jst.smoothed_action, tst.smoothed_action) <= 1e-6
        assert np.array_equal(np.asarray(jst.steps), tst.steps.numpy())


def test_step_with_pokes_matches_jax(envs, rollout):
    """Pokes: the JAX draws (part, direction; do_poke forced on for every
    other env so that many pokes land) go to the port's inner step, which
    the public step(…, generator) also uses. The JAX side applies the same
    pokes eagerly and then takes its compiled poke-free step."""
    jenv, _tenv = envs
    jstep, trace = rollout
    jst = trace[1][0][0]                       # after one step: limbs moved
    tpoke = tle.LocoEnv(solver_iterations=10, solver_mode="fused",
                        enable_pokes=True, device="cpu")
    tst = env_state_from_numpy(
        dict(physics=_np_state(jst.physics),
             smoothed_action=np.asarray(jst.smoothed_action),
             steps=np.asarray(jst.steps)), device="cpu")
    act = np.random.default_rng(1).uniform(-1, 1, (B, 27)).astype(np.float32)

    def draws(rng):
        _rng, k_poke, k_part, k_dir = jax.random.split(rng, 4)
        return (jax.random.uniform(k_poke) < jle.POKE_PROBABILITY,
                jax.random.randint(k_part, (), 0, jle.NUM_BODY_PARTS),
                jax.random.uniform(k_dir, (2,), minval=-1.0, maxval=1.0))
    do_poke, part, d2 = jax.vmap(draws)(jst.rng)
    do_poke = np.asarray(do_poke) | (np.arange(B) % 2 == 0)

    def poke(state, part, d2, do):
        direction = jnp.array([d2[0], 0.0, d2[1]])
        direction = direction / jnp.maximum(jnp.linalg.norm(direction), 1e-6)
        origin = (state.pos[jenv.body_ids[part]]
                  + jnp.array([0.0, 0.2, 0.0]) - direction * 5.0)
        poked = jax_apply_ray_impulse(jenv.scene, state, origin, direction,
                                      jle.POKE_STRENGTH)
        return jax.tree_util.tree_map(lambda a, b: jnp.where(do, a, b),
                                      poked, state)
    jphys = jax.vmap(poke)(jst.physics, part, d2, jnp.asarray(do_poke))
    hit = np.abs(np.asarray(jphys.force_acc)).max(axis=(1, 2)) > 0
    assert hit.sum() >= B // 4, "too few pokes landed to test anything"
    jout = jstep(jst.replace(physics=jphys), jnp.asarray(act))

    tout = tpoke._step_with_draws(
        tst, torch.from_numpy(act), torch.from_numpy(do_poke),
        torch.from_numpy(np.asarray(part, np.int64)),
        torch.from_numpy(np.asarray(d2, np.float32)))
    assert np.array_equal(np.asarray(jout[3]), tout[3].numpy())
    assert _diff(jout[1], tout[1]) <= 1e-4
    assert _diff(jout[2], tout[2]) <= 1e-4
    assert _diff(jout[0].physics.lin_vel, tout[0].physics.lin_vel) <= 1e-4


def test_public_step_draws_pokes_from_generator():
    env = tle.LocoEnv(solver_iterations=2, solver_mode="fused",
                      enable_pokes=True, device="cpu")
    act = torch.zeros((64, 27))
    outs = []
    for seed in (3, 3, 4):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        st, _ = env.reset(64)
        for _ in range(4):
            st, obs, _r, _d = env.step(st, act, gen)
        outs.append(obs)
    assert torch.equal(outs[0], outs[1])          # same seed, same pokes
    assert not torch.equal(outs[0], outs[2])      # pokes do land


def _moved_states(jenv, rng, n):
    """n plausible states as numpy: the standing pose displaced, tilted
    and moving; a few pushed below the fall height."""
    base = jenv.scene.initial_state()
    n1 = base.pos.shape[0]
    pos = np.asarray(base.pos)[None] + rng.normal(size=(n, 1, 3)) * 0.3 \
        + rng.normal(size=(n, n1, 3)) * 0.03
    pos[: n // 4, :, 1] -= 1.0
    rot = np.asarray(base.rot)[None] + rng.normal(size=(n, n1, 4)) * 0.1
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    f = dict(pos=pos, rot=rot, lin_vel=rng.normal(size=(n, n1, 3)),
             ang_vel=rng.normal(size=(n, n1, 3)),
             force_acc=np.zeros((n, n1, 3)), torque_acc=np.zeros((n, n1, 3)))
    return {k: v.astype(np.float32) for k, v in f.items()}


def _jax_states(jenv, f):
    return jenv.scene.initial_state().replace(
        controls=None, **{k: jnp.asarray(v) for k, v in f.items()})


@pytest.mark.parametrize("which", ["standing", "walking"])
def test_observation_reward_done(envs, walk_envs, which):
    """obs / reward / fall and tracking termination for given states and
    episode times, ≤1e-5 (reward sums 14x6 norms inside an exp)."""
    jenv, tenv = envs if which == "standing" else walk_envs
    rng = np.random.default_rng(2)
    n = 16
    f = _moved_states(jenv, rng, n)
    t = rng.uniform(0.0, 6.0, n).astype(np.float32)
    sm = rng.uniform(-1, 1, (n, 27)).astype(np.float32)
    js = _jax_states(jenv, f)
    ts = state_from_numpy(dict(f, controls=None), device="cpu")
    tt = torch.from_numpy(t)
    assert tenv.obs_size == jenv.obs_size == (66 if which == "standing" else 71)
    jobs = jax.vmap(jenv._observe)(js, jnp.asarray(sm), jnp.asarray(t))
    assert _diff(jobs, tenv._observe(ts, torch.from_numpy(sm), tt)) <= 1e-5
    jrew = jax.vmap(jenv.reward)(js, jnp.asarray(t))
    assert _diff(jrew, tenv.reward(ts, tt)) <= 1e-5
    jfall = np.asarray(jax.vmap(jenv.has_fallen)(js))
    assert np.array_equal(jfall, tenv.has_fallen(ts).numpy())
    assert jfall.any() and not jfall.all()
    if which == "walking":
        jtf = np.asarray(jax.vmap(jenv.tracking_failed)(js, jnp.asarray(t)))
        assert np.array_equal(jtf, tenv.tracking_failed(ts, tt).numpy())
        assert jtf.any() and not jtf.all()


def test_gait_targets(walk_envs):
    jenv, tenv = walk_envs
    t = np.linspace(0.0, 3.0, 12).astype(np.float32)
    jp, jr = jax.vmap(jenv._gait_targets)(jnp.asarray(t))
    tp, tr = tenv._gait_targets(torch.from_numpy(t))
    assert _diff(jp, tp) <= 1e-5 and _diff(jr, tr) <= 1e-5
    assert abs(tenv.gait_hip_amp - jenv.gait_hip_amp) <= 1e-7


def test_controls_from_action(envs):
    jenv, tenv = envs
    a = np.random.default_rng(3).uniform(-1.5, 1.5, (8, 27)).astype(np.float32)
    jc = jax.vmap(jenv._controls_from_action)(jnp.asarray(a))
    tc = tenv._controls_from_action(torch.from_numpy(a))
    for name, want in vars(jc).items():
        assert _diff(want, getattr(tc, name)) <= 1e-6, name


def test_apply_ray_impulse(envs):
    """Rays from around the ragdoll at its parts: same closest body, force
    and torque accumulators ≤1e-3 of a 1000 N poke (relative 1e-6). A ray
    that misses leaves NaN in the pinned dummy body's accumulators in both
    packages (0 * inf); the step never reads them."""
    jenv, tenv = envs
    rng = np.random.default_rng(4)
    n = 32
    f = _moved_states(jenv, rng, n)
    f["pos"][: n // 4, :, 1] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = f["pos"][np.arange(n), rng.integers(1, 15, n)]
    origin = (target - 5.0 * d).astype(np.float32)
    origin[-8:] += 50.0                                  # these miss
    js = _jax_states(jenv, f)
    ts = state_from_numpy(dict(f, controls=None), device="cpu")
    jp = jax.vmap(lambda s, o, dd: jax_apply_ray_impulse(
        jenv.scene, s, o, dd, 1000.0))(js, jnp.asarray(origin), jnp.asarray(d))
    tp = apply_ray_impulse(tenv.scene, ts, torch.from_numpy(origin),
                           torch.from_numpy(d), 1000.0)
    jf = np.nan_to_num(np.asarray(jp.force_acc))
    assert np.array_equal(np.abs(jf).sum(-1) > 0,
                          tp.force_acc.nan_to_num().abs().sum(-1).numpy() > 0)
    assert (np.abs(jf).sum((1, 2)) > 0).sum() >= n // 2
    assert _diff(jp.force_acc, tp.force_acc) <= 1e-3
    assert _diff(jp.torque_acc, tp.torque_acc) <= 1e-3


@pytest.mark.parametrize("shape", ["sphere", "box", "aabb", "capsule",
                                   "cylinder"])
def test_raycast_primitives(shape):
    rng = np.random.default_rng(5)
    n = 512
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    b = (a + rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    h = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.8, n).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    args = {"sphere": (o, d, a, r), "box": (o, d, a, h, q),
            "aabb": (o, d, a - h, a + h), "capsule": (o, d, a, b, r),
            "cylinder": (o, d, a, b, r)}[shape]
    jt, jhit = jax.vmap(getattr(jrc, f"ray_{shape}"))(
        *[jnp.asarray(x) for x in args])
    tt, thit = getattr(trc, f"ray_{shape}")(*[torch.from_numpy(x) for x in args])
    jt, hit = np.asarray(jt), np.asarray(jhit)
    assert np.array_equal(hit, thit.numpy())
    assert hit.any() and not hit.all()
    assert np.array_equal(jt[~hit], tt.numpy()[~hit])       # the miss value
    assert np.abs(jt[hit] - tt.numpy()[hit]).max() <= 1e-5


def _flax_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("obs_dim", [66, 71])
def test_policy_forward_with_converted_weights(obs_dim):
    """flax Dense.kernel (in, out) -> nn.Linear.weight (out, in); outputs
    ≤1e-6 (three 128-wide float32 products)."""
    jnet = JaxActorCritic(action_dim=27)
    params = jnet.init(jax.random.PRNGKey(obs_dim), jnp.zeros((obs_dim,)))
    tree = _flax_tree(params)
    rng = np.random.default_rng(6)
    # give log_std and the biases non-trivial values
    tree["params"]["log_std"] = rng.normal(size=27).astype(np.float32)
    for head in ("pi", "vf"):
        for i in range(3):
            bias = tree["params"][head][f"Dense_{i}"]["bias"]
            tree["params"][head][f"Dense_{i}"]["bias"] = rng.normal(
                size=bias.shape).astype(np.float32)
    net = ActorCritic(action_dim=27, obs_dim=obs_dim)
    net.load_state_dict(policy_state_dict_from_flax(tree))
    obs = rng.normal(size=(B, obs_dim)).astype(np.float32)
    jmean, jls, jval = jnet.apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(obs))
    with torch.no_grad():
        tmean, tls, tval = net(torch.from_numpy(obs))
    assert _diff(jmean, tmean) <= 1e-6
    assert _diff(jval, tval) <= 2e-6
    assert _diff(jls, tls.detach()) == 0.0
    assert torch.equal(policy_apply(net, torch.from_numpy(obs)), tmean)


def test_committed_walk_policy_loads():
    path = os.path.join(os.path.dirname(tle.__file__), "..", "assets",
                        "walk_r5_policy.npz")
    sd = policy_state_dict_from_npz(path)
    net = ActorCritic(action_dim=27, obs_dim=71)
    net.load_state_dict(sd)
    assert sd["pi.dense0.weight"].shape == (128, 71)
    out = policy_apply(net, torch.zeros((2, 71)))
    assert out.shape == (2, 27) and bool(torch.isfinite(out).all())


def test_make_policy_is_seeded():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    a = make_policy(27, 66, g1, device="cpu")
    b = make_policy(27, 66, g2, device="cpu")
    assert torch.equal(a.pi.dense0.weight, b.pi.dense0.weight)
    assert float(a.pi.dense2.weight.detach().abs().max()) <= 1e-4 + 1e-9


def test_ppo_rollout_matches_jax_loop(envs, rollout):
    """train/ppo.py's rollout on the real env: two steps from reset of the
    port's LocoEnv under a freshly initialised flax ActorCritic's weights,
    with injected action noise, against a Python loop of the JAX package's
    policy step (ppo.py:88-93) and its compiled env step; observation,
    action, log-prob, value, reward and done to 1e-4."""
    from dxk_tpu.train import ppo as jppo
    from dxk_tpu_torch.train import ppo as tppo
    jenv, tenv = envs
    jstep = rollout[0]
    jnet = JaxActorCritic(action_dim=27)
    params = jnet.init(jax.random.PRNGKey(5), jnp.zeros((66,)))
    net = ActorCritic(action_dim=27, obs_dim=66)
    net.load_state_dict(policy_state_dict_from_flax(_flax_tree(params)))
    T = 2
    noise = np.random.default_rng(12).normal(size=(T, B, 27)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    want = []
    for t in range(T):
        mean, log_std, value = jnet.apply(params, jobs)
        action = mean + jnp.asarray(noise[t]) * jnp.exp(log_std)
        lp = jppo._gaussian_log_prob(mean, log_std, action)
        obs_t = jobs
        jst, jobs, reward, done = jstep(jst, action)
        want.append(dict(obs=obs_t, action=action, log_prob=lp, value=value,
                         reward=reward, done=done))
    tst, tobs = tenv.reset(B)
    _st, last_obs, traj = tppo.rollout(net, tenv, tst, tobs, None, T,
                                       torch.from_numpy(noise))
    for t in range(T):
        for k in ("obs", "action", "log_prob", "value", "reward"):
            assert _diff(want[t][k], getattr(traj, k)[t]) <= 1e-4, (t, k)
        assert np.array_equal(np.asarray(want[t]["done"]),
                              traj.done[t].numpy())
    assert _diff(jobs, last_obs) <= 1e-4
