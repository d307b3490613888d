"""Gym-style host adapters for LocoEnv: Box spaces, reset() -> obs,
step(action) -> (obs, reward, done, info), with numpy in and out, and a
vectorised variant stepping `num_envs` envs in lockstep on one device.
Counterpart of the JAX package's envs/gym_adapter.py.

For interop (SB3-style trainers, evaluation scripts); the fast path is
`LocoEnv.reset` / `LocoEnv.step` on batched tensors. The poke draws of the
steps come from the adapter's own `torch.Generator`, seeded by `seed`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dxk_tpu_torch.envs.loco_env import ACTION_SIZE, LocoEnv


class Box:
    """Minimal gym.spaces.Box stand-in (gym is not a dependency)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = np.broadcast_to(np.asarray(low, dtype), shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype), shape).copy()
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(lo, hi).astype(self.dtype)


class VecLocoEnv:
    """`num_envs` LocoEnvs stepped in lockstep as one batch on `device`:
    observations (num_envs, obs_size), rewards and dones (num_envs,), as
    numpy."""

    def __init__(self, num_envs: int = 16, seed: int = 0, device="cuda",
                 **env_kwargs):
        self.env = LocoEnv(device=device, **env_kwargs)
        self.num_envs = num_envs
        self.observation_space = Box(-np.inf, np.inf, (self.env.obs_size,))
        self.action_space = Box(self.env.action_min.cpu().numpy(),
                                self.env.action_max.cpu().numpy(),
                                (ACTION_SIZE,))
        self._gen = torch.Generator(device=self.env.device)
        self._gen.manual_seed(seed)
        self._state = None

    def reset(self):
        self._state, obs = self.env.reset(self.num_envs)
        return obs.cpu().numpy()

    def step(self, actions):
        a = torch.as_tensor(np.asarray(actions, np.float32),
                            device=self.env.device)
        self._state, obs, rewards, dones = self.env.step(self._state, a,
                                                         self._gen)
        return (obs.cpu().numpy(), rewards.cpu().numpy(),
                dones.cpu().numpy(), [{}] * self.num_envs)


class GymLocoEnv:
    """Single-env host API: obs (obs_size,), a float reward, a bool done."""

    def __init__(self, seed: int = 0, device="cuda", **env_kwargs):
        self._vec = VecLocoEnv(num_envs=1, seed=seed, device=device,
                               **env_kwargs)
        self.env = self._vec.env
        self.observation_space = self._vec.observation_space
        self.action_space = self._vec.action_space

    def reset(self):
        return self._vec.reset()[0]

    def step(self, action):
        obs, reward, done, _ = self._vec.step(np.asarray(action)[None])
        return obs[0], float(reward[0]), bool(done[0]), {}
