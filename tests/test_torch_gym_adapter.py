"""Port parity, module envs/gym_adapter.py: Box spaces equal to the JAX
adapter's, tests/test_gym_adapter.py's API checks on the port, and one
vectorised step from a state carried across from the JAX adapter matching
the JAX adapter's step: observations, rewards, positions and velocities
within 1e-4, dones equal (tests/test_torch_loco_env.py's bound over its
env steps; 2 "jacobi" iterations and no pokes keep the JAX compile to
seconds)."""
import jax
import numpy as np
import pytest
import torch

from dxk_tpu.envs import gym_adapter as jga
from dxk_tpu_torch.envs import gym_adapter as tga
from dxk_tpu_torch.utils.convert import env_state_from_numpy

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

TOL = 1e-4


@pytest.mark.parametrize("cls", ["GymLocoEnv", "VecLocoEnv"])
def test_spaces_match_jax(cls):
    j = getattr(jga, cls)(solver_iterations=8)
    t = getattr(tga, cls)(solver_iterations=8, device="cpu")
    for name in ("observation_space", "action_space"):
        js, ts = getattr(j, name), getattr(t, name)
        assert ts.shape == js.shape and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)
    a = t.action_space.sample(np.random.default_rng(0))
    assert a.shape == (27,) and np.all(a >= t.action_space.low)


def test_single_env_api():
    env = tga.GymLocoEnv(solver_iterations=8, device="cpu")
    obs = env.reset()
    assert obs.shape == (66,)
    total = 0.0
    for _ in range(5):
        obs, r, done, info = env.step(np.zeros(27, np.float32))
        assert isinstance(r, float) and isinstance(done, bool)
        total += r
    assert np.isfinite(total) and total > 0


def test_vec_env_api():
    env = tga.VecLocoEnv(num_envs=4, solver_iterations=8, device="cpu")
    obs = env.reset()
    assert obs.shape == (4, 66)
    obs, r, d, infos = env.step(np.zeros((4, 27), np.float32))
    assert r.shape == (4,) and d.shape == (4,) and len(infos) == 4


def test_step_from_jax_state_matches_jax():
    kw = dict(solver_iterations=2, solver_mode="jacobi", enable_pokes=False)
    jenv = jga.VecLocoEnv(num_envs=2, **kw)
    tenv = tga.VecLocoEnv(num_envs=2, device="cpu", **kw)
    rng = np.random.default_rng(0)
    jenv.reset()
    tenv.reset()
    jenv.step(rng.uniform(-1, 1, (2, 27)).astype(np.float32))
    js = jax.tree_util.tree_map(np.asarray, jenv._state)
    tenv._state = env_state_from_numpy(dict(
        physics={**{k: getattr(js.physics, k) for k in (
            "pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")},
            "controls": vars(js.physics.controls)},
        smoothed_action=js.smoothed_action, steps=js.steps), device="cpu")
    a = rng.uniform(-1, 1, (2, 27)).astype(np.float32)
    jobs, jrew, jdone, _ = jenv.step(a)
    tobs, trew, tdone, infos = tenv.step(a)
    assert len(infos) == 2
    assert np.abs(tobs - jobs).max() <= TOL
    assert np.abs(trew - jrew).max() <= TOL
    np.testing.assert_array_equal(tdone, jdone)
    for k in ("pos", "lin_vel"):
        j = np.asarray(getattr(jenv._state.physics, k))
        t = getattr(tenv._state.physics, k).numpy()
        assert np.abs(t - j).max() <= TOL, k
