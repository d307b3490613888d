"""Port parity of train/ppo.py: the port's whole train_step against the JAX
package's make_train on a toy env written twice (JAX and torch), two
iterations with the JAX draws fed to the port, and its parts against
optax and numpy (GAE across done boundaries, the global-norm clip, Adam,
the advantages' population standard deviation).

The toy env: a 66-float state, tanh-linear dynamics driven by the 27-float
action, a reward from the state and the action, `done` every PERIOD steps
from a per-env phase drawn at reset (then a deterministic reset to a fixed
state). JAX's reset(key) draws the first state and phase; the test copies
them into the port's env state.

Tolerance: TOL = 1e-5 absolute on parameters, Adam's moments and the
metrics. The two run the same float32 operations in another order
(XLA:CPU's and torch's matrix products, autodiff's sums), so they agree to
float rounding; parameters agree to ~3e-7 after 16 Adam steps. The moments
are tiny where the gradient is (the actor's hidden layers sit behind the
action head's 1e-4 weights: mu ~1e-5, nu ~1e-10), so each moment is also
held relative to its tensor's largest entry, at MOMENT_REL = 5e-5: those
gradients are sums over the minibatch of terms weighted by advantages
normalised to mean zero, whose cancellation leaves them ~1e-5 relative
float rounding (measured up to 1.9e-5 on nu, the squared gradient)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dxk_tpu.train import ppo as jppo
from dxk_tpu_torch.train import ppo as tppo
from dxk_tpu_torch.utils.convert import ppo_state_from_optax

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). Every port test file spends that first call at import.
torch.sqrt(torch.ones(4096))

TOL = 1e-5
MOMENT_REL = 5e-5
OBS = 66
ACT = 27
PERIOD = 4
CONFIG = dict(num_envs=8, unroll_length=6, num_epochs=2, num_minibatches=4,
              learning_rate=3e-4)


def _toy_tables():
    rng = np.random.default_rng(21)
    return dict(A=(rng.normal(size=(OBS, OBS)) * 0.2).astype(np.float32),
                Bm=(rng.normal(size=(ACT, OBS)) * 0.3).astype(np.float32),
                x0=(rng.normal(size=OBS) * 0.1).astype(np.float32),
                w=rng.normal(size=OBS).astype(np.float32))


class JaxToyEnv:
    """reset(key) -> (state, obs); step(state, action) -> (state, obs,
    reward, done), one env (make_train vmaps it)."""
    obs_size = OBS

    def __init__(self):
        self.t = {k: jnp.asarray(v) for k, v in _toy_tables().items()}

    def reset(self, key):
        k1, k2 = jax.random.split(key)
        x = self.t["x0"] + 0.1 * jax.random.normal(k1, (OBS,))
        phase = jax.random.randint(k2, (), 0, PERIOD)
        return {"x": x, "phase": phase}, x

    def step(self, state, action):
        x = jnp.tanh(state["x"] @ self.t["A"] + action @ self.t["Bm"])
        reward = jnp.tanh(x @ self.t["w"]) - 0.01 * jnp.sum(action * action)
        phase = state["phase"] + 1
        done = phase >= PERIOD
        x = jnp.where(done, self.t["x0"], x)
        phase = jnp.where(done, 0, phase)
        return {"x": x, "phase": phase}, x, reward, done


class TorchToyEnv:
    """The same env batched, with the port's reset(N) / step(state, action,
    generator) API."""
    obs_size = OBS
    device = torch.device("cpu")

    def __init__(self):
        self.t = {k: torch.from_numpy(v) for k, v in _toy_tables().items()}

    def reset(self, n):
        x = self.t["x0"].expand(n, OBS).clone()
        return {"x": x, "phase": torch.zeros(n, dtype=torch.int32)}, x

    def step(self, state, action, generator=None):
        x = torch.tanh(state["x"] @ self.t["A"] + action @ self.t["Bm"])
        reward = (torch.tanh(x @ self.t["w"])
                  - 0.01 * torch.sum(action * action, dim=-1))
        phase = state["phase"] + 1
        done = phase >= PERIOD
        x = torch.where(done[:, None], self.t["x0"], x)
        phase = torch.where(done, 0, phase)
        return {"x": x, "phase": phase}, x, reward, done


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(jts, tenv, init_fn):
    """The port's TrainState holding the JAX TrainState's params, Adam
    state and env state."""
    ts = init_fn(0)
    conv = ppo_state_from_optax(_np_tree(jts.params), _np_tree(jts.opt_state))
    ts.net.load_state_dict(conv["weights"])
    env_state = {"x": torch.from_numpy(np.array(jts.env_state["x"])),
                 "phase": torch.from_numpy(
                     np.array(jts.env_state["phase"], np.int32))}
    return ts.replace(
        opt_state=tppo.adam_state_from_state_dicts(
            ts.net, conv["count"], conv["mu"], conv["nu"]),
        env_state=env_state, obs=torch.from_numpy(np.array(jts.obs)))


def _jax_draws(rng, cfg):
    """The noise and permutations JAX's train_step draws from `rng` (its
    ppo.py:99 and :156-158 key chain), as torch tensors."""
    noise = []
    for _ in range(cfg.unroll_length):
        rng, k_act = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k_act, (cfg.num_envs,
                                                          ACT))))
    total = cfg.unroll_length * cfg.num_envs
    perms = []
    for _ in range(cfg.num_epochs):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, total)))
    return (torch.from_numpy(np.stack(noise)),
            torch.from_numpy(np.stack(perms).astype(np.int64)))


def _flat(tree):
    """A flax tree or an ActorCritic's state_dict-keyed dict as
    {port name: numpy}, kernels transposed to nn.Linear's layout."""
    if isinstance(tree, dict) and "pi.dense0.weight" in tree:
        return {k: v.detach().numpy() for k, v in tree.items()}
    from dxk_tpu_torch.utils.convert import policy_state_dict_from_flax
    return {k: v.numpy() for k, v in policy_state_dict_from_flax(
        _np_tree(tree)).items()}


def _check(jts, jm, ts, tm):
    """Params, Adam moments and metrics of the two states agree."""
    bad = {}
    jp, tp = _flat(jts.params), _flat(dict(ts.net.state_dict()))
    for k in jp:
        d = float(np.abs(jp[k] - tp[k]).max())
        if not d <= TOL:
            bad[f"param {k}"] = d
    adam = [s for s in jax.tree_util.tree_leaves(
        jts.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    assert int(adam.count) == ts.opt_state.count
    names = [n for n, _p in ts.net.named_parameters()]
    for moment, tl in (("mu", ts.opt_state.mu), ("nu", ts.opt_state.nu)):
        jmo = _flat(getattr(adam, moment))
        for n, t in zip(names, tl):
            d = float(np.abs(jmo[n] - t.numpy()).max())
            scale = float(np.abs(jmo[n]).max())
            if not (d <= TOL and d <= MOMENT_REL * scale):
                bad[f"{moment} {n}"] = (d, scale)
    for k, v in jm.items():
        d = abs(float(v) - float(tm[k]))
        if not d <= TOL:
            bad[f"metric {k}"] = (float(v), float(tm[k]))
    assert not bad, bad


@pytest.fixture(scope="module")
def both():
    cfg_j = jppo.PPOConfig(**CONFIG)
    cfg_t = tppo.PPOConfig(**CONFIG)
    j_init, j_step = jppo.make_train(JaxToyEnv(), cfg_j)
    tenv = TorchToyEnv()
    t_init, t_step = tppo.make_train(tenv, cfg_t)
    j_step = jax.jit(j_step)
    jts0 = j_init(jax.random.PRNGKey(3))
    jts1, jm1 = j_step(jts0)
    jts2, jm2 = j_step(jts1)
    return dict(cfg=cfg_t, tenv=tenv, t_init=t_init, t_step=t_step,
                jts=(jts0, jts1, jts2), jm=(jm1, jm2))


def test_config_defaults_match():
    assert tppo.PPOConfig() == tppo.PPOConfig(
        **{k: getattr(jppo.PPOConfig(), k)
           for k in jppo.PPOConfig.__dataclass_fields__})


def test_two_train_steps_match_jax(both):
    """Iteration 1 from the JAX init, iteration 2 carried in the port's own
    state: params, Adam moments and count, metrics."""
    jts0, jts1, jts2 = both["jts"]
    ts = _port_state(jts0, both["tenv"], both["t_init"])
    ts, tm1 = both["t_step"](ts, _jax_draws(jts0.rng, both["cfg"]))
    _check(jts1, both["jm"][0], ts, tm1)
    # the rollouts ended in both envs and reset some of them
    assert 0.0 < float(tm1["episode_done_rate"]) < 1.0
    ts, tm2 = both["t_step"](ts, _jax_draws(jts1.rng, both["cfg"]))
    _check(jts2, both["jm"][1], ts, tm2)


def test_second_step_from_carried_jax_state(both):
    """Iteration 2 from the JAX state after iteration 1, carried over with
    ppo_state_from_optax (Adam's count 8 and its moments)."""
    _jts0, jts1, jts2 = both["jts"]
    ts = _port_state(jts1, both["tenv"], both["t_init"])
    assert ts.opt_state.count == 8
    ts, tm2 = both["t_step"](ts, _jax_draws(jts1.rng, both["cfg"]))
    _check(jts2, both["jm"][1], ts, tm2)


def test_gae_across_done_boundaries():
    """compute_gae against a numpy loop, on a rollout whose envs end and
    restart at different steps."""
    rng = np.random.default_rng(8)
    T, N = 9, 5
    reward = rng.normal(size=(T, N)).astype(np.float32)
    value = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.uniform(size=(T, N)) < 0.3
    last = rng.normal(size=N).astype(np.float32)
    g, lam = 0.99, 0.95
    want = np.zeros((T, N), np.float64)
    gae, nv = np.zeros(N), last.astype(np.float64)
    for t in reversed(range(T)):
        nd = 1.0 - done[t]
        delta = reward[t] + g * nv * nd - value[t]
        gae = delta + g * lam * nd * gae
        want[t] = gae
        nv = value[t]
    adv, ret = tppo.compute_gae(torch.from_numpy(reward),
                                torch.from_numpy(value),
                                torch.from_numpy(done), torch.from_numpy(last),
                                g, lam)
    assert done.any(axis=0).all() and not done.all()
    assert np.abs(adv.numpy() - want).max() <= 1e-5
    assert np.abs(ret.numpy() - (want + value)).max() <= 1e-5


@pytest.mark.parametrize("norm", [0.3, 0.5000001, 2.0])
def test_clip_and_adam_match_optax(norm):
    """clip_by_global_norm(0.5) then adam over three steps against optax's
    chain, with the gradients' global norm below, just above and well
    above 0.5. torch's clip_grad_norm_ (norm + 1e-6 in the divisor) misses
    optax's scale where it clips."""
    rng = np.random.default_rng(9)
    shapes = [(4, 3), (3,), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = tppo.AdamState(0, [torch.zeros_like(p) for p in tp],
                            [torch.zeros_like(p) for p in tp])
    for step in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        gn = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                         for g in grads))
        grads = [(g / gn * norm).astype(np.float32) for g in grads]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        clipped, _gn = tppo.clip_by_global_norm(
            [torch.from_numpy(g) for g in grads], 0.5)
        jclip, _ = optax.clip_by_global_norm(0.5).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for c, jc in zip(clipped, jclip):
            assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-7 * max(
                1.0, float(np.abs(np.asarray(jc)).max()))
        if norm > 0.5:
            torch_way = [torch.from_numpy(g.copy()).requires_grad_()
                         for g in grads]
            for t in torch_way:
                t.grad = t.detach().clone()
            torch.nn.utils.clip_grad_norm_(torch_way, 0.5)
            off = max(float(np.abs(t.grad.numpy() - np.asarray(jc)).max())
                      for t, jc in zip(torch_way, jclip))
            ours = max(float(np.abs(c.numpy() - np.asarray(jc)).max())
                       for c, jc in zip(clipped, jclip))
            assert off > ours
        tstate = tppo.adam_apply(tp, clipped, tstate, 3e-4)
        for a, b in zip(tp, jp):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-7
    adam = jstate[1][0]
    assert int(adam.count) == tstate.count == 3
    for a, b in zip(tstate.mu + tstate.nu, list(adam.mu) + list(adam.nu)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()


def test_advantages_use_population_std():
    """ppo_loss normalises the advantages by their population standard
    deviation, as jnp.std does: on a minibatch of 4 torch's default (the
    sample one) gives another loss."""
    rng = np.random.default_rng(10)
    net = tppo.ActorCritic(ACT, OBS, generator=torch.Generator()
                           .manual_seed(0))
    n = 4
    obs = torch.from_numpy(rng.normal(size=(n, OBS)).astype(np.float32))
    with torch.no_grad():
        mean, log_std, value = net(obs)
    log_std = log_std.detach()           # the parameter itself
    action = mean + torch.from_numpy(rng.normal(size=(n, ACT))
                                     .astype(np.float32))
    old_lp = tppo.gaussian_log_prob(mean, log_std, action) + torch.from_numpy(
        rng.normal(size=n).astype(np.float32) * 0.3)
    adv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ret = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    cfg = tppo.PPOConfig()
    batch = (obs, action, old_lp, value, adv, ret)
    loss = float(tppo.ppo_loss(net, batch, cfg)[0].detach())

    def numpy_loss(ddof):
        lp = tppo.gaussian_log_prob(mean, log_std, action).numpy()
        ratio = np.exp(lp - old_lp.numpy())
        a = adv.numpy()
        a = (a - a.mean()) / (a.std(ddof=ddof) + 1e-8)
        pg = -np.mean(np.minimum(ratio * a, np.clip(ratio, 0.9, 1.1) * a))
        return pg + 0.5 * 0.5 * np.mean((value.numpy() - ret.numpy()) ** 2)

    assert abs(loss - numpy_loss(0)) <= 1e-6
    assert abs(loss - numpy_loss(1)) > 1e-3
