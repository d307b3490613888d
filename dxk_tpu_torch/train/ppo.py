"""On-device PPO for the locomotion environment: the PyTorch counterpart of
the JAX package's train/ppo.py.

One training step rolls every env forward `unroll_length` steps under the
current policy (into preallocated (T, N, ...) device tensors, no autograd),
computes GAE advantages, then runs `num_epochs` passes of minibatched
clipped-surrogate updates, each a gradient of the PPO loss, clipped by
global norm and fed to Adam. Everything stays on the env's device and the
step reads nothing back to the host, so its launches queue behind one
another; the caller synchronises when it reads a metric.

Where the JAX package splits PRNG keys, the port draws from one
`torch.Generator` on the env's device, carried in the TrainState: the
action noise of every rollout step and the env's pokes, then one
permutation per epoch. The two frameworks draw different numbers from the
same seed, so a test hands both the same draws (`train_step(ts, draws)`).

The update follows optax exactly, written out so that its state is
explicit and can be carried over from a JAX TrainState
(`utils.convert.ppo_state_from_optax`):
  - `optax.clip_by_global_norm(max_norm)`: g / g_norm * max_norm, only when
    g_norm >= max_norm (torch's clip_grad_norm_ adds 1e-6 to the norm and
    scales by min(1, ...), which differs);
  - `optax.adam(lr)`: m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, the
    step count from 1, update -lr m_hat / (sqrt(v_hat) + eps), eps 1e-8,
    eps_root 0;
  - the advantages normalised with their population standard deviation
    (numpy's and JAX's default; torch's default is the sample one).
Matrix products run in full float32: make_train turns TF32 off.

No kernel of its own: the products, Adam and GAE are plain PyTorch, as
they are plain XLA in the JAX package. The rollout's env steps run the
fused-step kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dxk_tpu_torch.models.policy import ActorCritic
from dxk_tpu_torch.utils.profiling import profile_block, step_timer

ACTION_DIM = 27             # the JAX trainer's ActorCritic(action_dim=27)
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8             # optax.adam's defaults; eps_root is 0
# 0.5 log(2 pi) as the JAX package computes it, in float32
HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))


@dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    unroll_length: int = 32          # steps per rollout per env
    num_epochs: int = 10
    num_minibatches: int = 16
    learning_rate: float = 2.5e-5
    clip_range: float = 0.1
    gamma: float = 0.99
    gae_lambda: float = 0.95
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5


class Transition(NamedTuple):
    """A rollout, each field (T, N, ...)."""
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclass
class AdamState:
    """optax's ScaleByAdamState: the steps taken and both moments, one
    tensor per parameter in `net.parameters()` order."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class TrainState:
    """The policy (updated in place by train_step), Adam's state, the envs'
    state and observation, and the generator every draw comes from."""
    net: ActorCritic
    opt_state: AdamState
    env_state: Any
    obs: torch.Tensor
    generator: torch.Generator

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def gaussian_log_prob(mean, log_std, action):
    """Log density of `action` under the diagonal normal, summed over the
    last axis."""
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var) - log_std
                     - HALF_LOG_2PI, dim=-1)


def adam_init(net: torch.nn.Module) -> AdamState:
    params = list(net.parameters())
    return AdamState(count=0,
                     mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def adam_state_from_state_dicts(net: torch.nn.Module, count: int, mu: dict,
                                nu: dict) -> AdamState:
    """An AdamState for `net` from moments keyed like its state_dict (as
    utils.convert.ppo_state_from_optax gives them), on its device."""
    names = [n for n, _p in net.named_parameters()]
    missing = set(names) ^ set(mu) | set(names) ^ set(nu)
    if missing:
        raise ValueError(f"adam_state_from_state_dicts: keys differ from the "
                         f"policy's parameters: {sorted(missing)}")
    dev = next(net.parameters()).device
    return AdamState(count=int(count),
                     mu=[mu[n].to(dev, torch.float32).clone() for n in names],
                     nu=[nu[n].to(dev, torch.float32).clone() for n in names])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm: the gradients scaled by max_norm / g_norm
    (as (g / g_norm) * max_norm) when the global norm g_norm is at least
    max_norm, else unchanged. Returns (grads, g_norm); no host sync."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm)
            for g in grads], g_norm


def adam_apply(params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, learning_rate: float) -> AdamState:
    """One optax.adam step on `params` in place; returns the new state
    (the moments are updated in place as well)."""
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - ADAM_B1))
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1.0 - ADAM_B2))
    count = state.count + 1
    mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** count)
    nu_hat = torch._foreach_div(nu, 1.0 - ADAM_B2 ** count)
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    torch._foreach_mul_(updates, -learning_rate)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    return AdamState(count=count, mu=mu, nu=nu)


def ppo_loss(net, batch, config: PPOConfig):
    """The clipped-surrogate PPO loss of one minibatch (obs, action,
    old_log_prob, old_value, advantages, returns): (total, (pg_loss,
    v_loss, entropy))."""
    obs, action, old_log_prob, _old_value, advantages, returns = batch
    mean, log_std, value = net(obs)
    log_prob = gaussian_log_prob(mean, log_std, action)
    ratio = torch.exp(log_prob - old_log_prob)
    adv = ((advantages - advantages.mean())
           / (advantages.std(correction=0) + 1e-8))
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - config.clip_range,
                      1 + config.clip_range) * adv
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = torch.mean(torch.sum(
        log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1))
    total = pg_loss + config.vf_coef * v_loss - config.ent_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def update_minibatch(net, opt_state: AdamState, batch, config: PPOConfig):
    """One minibatch update: the loss's gradient, clipped by global norm,
    then an Adam step on the parameters in place. Returns (loss, new Adam
    state); the loss is a 0-d tensor on the parameters' device."""
    params = list(net.parameters())
    loss, _aux = ppo_loss(net, batch, config)
    grads = torch.autograd.grad(loss, params)
    grads, _g_norm = clip_by_global_norm(list(grads), config.max_grad_norm)
    return loss.detach(), adam_apply(params, grads, opt_state,
                                     config.learning_rate)


def compute_gae(reward, value, done, last_value, gamma: float,
                gae_lambda: float):
    """GAE over a (T, N) rollout, a reverse loop over T with the JAX
    package's (1 - done) masking. Returns (advantages, returns)."""
    not_done = 1.0 - done.to(reward.dtype)
    adv = torch.empty_like(reward)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(reward.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * next_value * not_done[t] - value[t]
        gae = delta + gamma * gae_lambda * not_done[t] * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


@torch.no_grad()
def rollout(net, env, env_state, obs, generator, T: int, noise=None):
    """T steps of every env under the policy `net`, actions drawn around its
    mean from `generator` (or taken from `noise` (T, N, 27)), the env's own
    draws from `generator` too. Returns (env_state, obs, Transition of
    (T, N, ...) tensors on the env's device)."""
    N, dev = obs.shape[0], obs.device
    out = Transition(
        obs=torch.empty((T, N, obs.shape[1]), device=dev),
        action=torch.empty((T, N, ACTION_DIM), device=dev),
        log_prob=torch.empty((T, N), device=dev),
        value=torch.empty((T, N), device=dev),
        reward=torch.empty((T, N), device=dev),
        done=torch.empty((T, N), dtype=torch.bool, device=dev))
    for t in range(T):
        mean, log_std, value = net(obs)
        eps = (noise[t] if noise is not None else torch.randn(
            mean.shape, generator=generator, device=dev))
        action = mean + eps * torch.exp(log_std)
        out.obs[t] = obs
        out.action[t] = action
        out.log_prob[t] = gaussian_log_prob(mean, log_std, action)
        out.value[t] = value
        env_state, obs, reward, done = env.step(env_state, action, generator)
        out.reward[t] = reward
        out.done[t] = done
    return env_state, obs, out


def make_train(env, config: PPOConfig = PPOConfig()):
    """Returns (init_fn(seed) -> TrainState, train_step(ts, draws=None,
    times=None) -> (TrainState, metrics)). The caller owns the outer loop
    (and checkpointing). `env` gives `reset(N)`, `step(env_state, action,
    generator)`, `obs_size` and `device`.

    `draws` = (noise (T, N, 27), perms (num_epochs, N T)) replaces the
    action noise and the epochs' permutations drawn from the state's
    generator (tests feed the JAX package's draws; the env's own draws
    still come from the generator). `times`, a dict, receives the seconds
    of the rollout ("rollout_s") and of GAE and the updates ("update_s"),
    each synchronised with the device at its end; without it train_step
    never waits for the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    T, N = config.unroll_length, config.num_envs
    dev = env.device
    obs_dim = getattr(env, "obs_size", 66)

    def init_fn(seed: int) -> TrainState:
        """The policy's weights drawn on the CPU from `seed` (the same on
        every device), the envs reset, the run's generator seeded with
        seed + 1 on the env's device."""
        net_gen = torch.Generator().manual_seed(int(seed))
        net = ActorCritic(ACTION_DIM, obs_dim, generator=net_gen).to(dev)
        env_state, obs = env.reset(N)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) + 1)
        return TrainState(net, adam_init(net), env_state, obs, gen)

    def train_step(ts: TrainState, draws: Optional[Tuple] = None,
                   times: Optional[dict] = None):
        noise, perms = draws if draws is not None else (None, None)
        timed = times is not None
        with profile_block("ppo.rollout"), (
                step_timer(times, "rollout_s", ts.obs) if timed
                else contextlib.nullcontext()):
            env_state, obs, traj = rollout(ts.net, env, ts.env_state, ts.obs,
                                           ts.generator, T, noise)
        with profile_block("ppo.update"), (
                step_timer(times, "update_s", ts.obs) if timed
                else contextlib.nullcontext()):
            metrics, opt_state = learn(ts, obs, traj, perms)
        return ts.replace(opt_state=opt_state, env_state=env_state,
                          obs=obs), metrics

    def learn(ts, obs, traj, perms):
        """GAE, then the epochs of minibatch updates; (metrics, Adam's
        state)."""
        with torch.no_grad():
            last_value = ts.net(obs)[2]
            advantages, returns = compute_gae(
                traj.reward, traj.value, traj.done, last_value,
                config.gamma, config.gae_lambda)

        # flatten (T, N, ...) -> (T * N, ...), time-major
        def fl(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        data = (fl(traj.obs), fl(traj.action), fl(traj.log_prob),
                fl(traj.value), fl(advantages), fl(returns))
        total = data[0].shape[0]
        nmb = config.num_minibatches
        mb_size = total // nmb
        opt_state = ts.opt_state
        epoch_losses = []
        for e in range(config.num_epochs):
            perm = (perms[e] if perms is not None else torch.randperm(
                total, generator=ts.generator, device=dev))
            perm = perm[:mb_size * nmb].reshape(nmb, mb_size)
            losses = []
            for m in range(nmb):
                sel = perm[m]
                batch = tuple(x[sel] for x in data)
                loss, opt_state = update_minibatch(ts.net, opt_state, batch,
                                                   config)
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())

        reward = traj.reward
        metrics = {
            "loss": torch.stack(epoch_losses).mean(),
            "reward_mean": reward.mean(),
            "reward_per_step": reward.sum() / (reward.shape[0]
                                               * reward.shape[1]),
            "episode_done_rate": traj.done.float().mean(),
            "value_mean": traj.value.mean(),
        }
        return metrics, opt_state

    return init_fn, train_step
