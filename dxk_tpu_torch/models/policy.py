"""Policy / value networks: the 66/71 -> tanh(128) -> tanh(128) -> 27
actor and its critic, as `torch.nn.Module`s (the JAX package's
models/policy.py in flax). The three layers of each head are plain
`nn.Linear` matrix products.

A fresh network is initialised as flax initialises the JAX one: every
`Dense` kernel `lecun_normal` (a normal of variance 1 / fan_in truncated at
two of its standard deviations, rescaled so that the variance stays 1 /
fan_in) and zero biases, except the action head's last kernel,
`uniform(0, 1e-4)`; `log_std` zeros. The draws come from the generator
passed in (torch's default generator when none is), never from a seed
taken elsewhere.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so that the truncated draw keeps its scale
TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's `lecun_normal` on an `nn.Linear` weight (out, in): a normal of
    standard deviation sqrt(1 / in) / TRUNCATED_NORMAL_STD cut at two of
    those deviations."""
    std = math.sqrt(1.0 / weight.shape[1]) / TRUNCATED_NORMAL_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(std)
    return weight


def _dense(in_dim, out_dim, generator, uniform_scale=None):
    """An nn.Linear made without torch's default initialisation (which
    would draw from the global generator), initialised as flax's Dense."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    if uniform_scale is None:
        lecun_normal_(layer.weight, generator)
    else:
        with torch.no_grad():
            nn.init.uniform_(layer.weight, 0.0, uniform_scale,
                             generator=generator)
    with torch.no_grad():
        nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: int = 128,
                 out_scale: float = 1.0, generator=None):
        super().__init__()
        self.dense0 = _dense(in_dim, hidden, generator)
        self.dense1 = _dense(hidden, hidden, generator)
        # tiny action-head init, as in the JAX package
        self.dense2 = _dense(hidden, out_dim, generator,
                             0.01 * out_scale if out_scale != 1.0 else None)

    def forward(self, x):
        x = torch.tanh(self.dense0(x))
        x = torch.tanh(self.dense1(x))
        return self.dense2(x)


class ActorCritic(nn.Module):
    """forward(obs) -> (mean, log_std, value). Built on the CPU; `generator`
    (a CPU torch.Generator, or None for torch's default one) draws the
    initial weights, in the order flax draws them: the actor's three
    layers, then the critic's."""

    def __init__(self, action_dim: int, obs_dim: int, hidden: int = 128,
                 generator=None):
        super().__init__()
        self.pi = MLP(obs_dim, action_dim, hidden, out_scale=0.01,
                      generator=generator)
        self.vf = MLP(obs_dim, 1, hidden, generator=generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs):
        mean = self.pi(obs)
        value = self.vf(obs)[..., 0]
        return mean, self.log_std, value


def make_policy(action_dim: int, obs_dim: int, generator=None,
                device="cuda"):
    """A freshly initialised ActorCritic on `device`, its weights drawn on
    the CPU from `generator` (torch's default generator when None)."""
    return ActorCritic(action_dim, obs_dim, generator=generator).to(device)


@torch.no_grad()
def policy_apply(net, obs):
    """Deterministic inference: the action mean."""
    return net.pi(obs)
