"""Port parity, envs/loco_env.py in the reference modes: the JAX
package's entry() configuration, LocoEnv(solver_iterations=10,
max_narrow_pairs=32) in its default "scan" mode (capped narrowphase
tables: capsule-capsule 99 pairs in 32 slots, capsule-box 45 in 32,
box-box 3), two env steps at 4 envs on the same seeded actions, pokes off
(the two packages draw them from different generators), against the JAX
env stepped compiled and vmapped. Observation, reward, done and the
physics state after each step: positions and rotations within 1e-6,
velocities within 1e-5 of max(1, their largest), observation and reward
within 1e-5. And the per-group narrowphase caps of max_narrow_pairs and
narrow_caps in every mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.envs.loco_env import LocoEnv as JaxLocoEnv
from dxk_tpu_torch.envs.loco_env import LocoEnv

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

B = 4
ENTRY_KW = dict(solver_iterations=10, max_narrow_pairs=32,
                enable_pokes=False)


def _diff(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - b.numpy().astype(np.float64)).max(initial=0.0))


def test_entry_configuration_matches_jax():
    jenv = JaxLocoEnv(**ENTRY_KW)
    tenv = LocoEnv(device="cpu", **ENTRY_KW)
    assert tenv.settings.solver_mode == jenv.settings.solver_mode == "scan"
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jst, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    jstep = jax.jit(jax.vmap(jenv.step))
    tst, tobs = tenv.reset(B)
    assert _diff(jobs, tobs) <= 1e-6
    acts = np.random.default_rng(12).uniform(-1, 1, (2, B, 27)).astype(
        np.float32)
    for a in acts:
        jst, jobs, jrew, jdone = jstep(jst, jnp.asarray(a))
        tst, tobs, trew, tdone = tenv.step(tst, torch.from_numpy(a))
        assert np.array_equal(np.asarray(jdone), tdone.numpy())
        assert _diff(jobs, tobs) <= 1e-5
        assert _diff(jrew, trew) <= 1e-5
        jp, tp = jst.physics, tst.physics
        assert _diff(jp.pos, tp.pos) <= 1e-6
        assert _diff(jp.rot, tp.rot) <= 1e-6
        for k in ("lin_vel", "ang_vel"):
            scale = max(1.0, float(np.abs(np.asarray(getattr(jp, k))).max()))
            assert _diff(getattr(jp, k), getattr(tp, k)) <= 1e-5 * scale, k
    assert torch.isfinite(tobs).all()


@pytest.mark.parametrize("mode", ["scan", "jacobi", "colored", "fused",
                                  "fused_seq"])
def test_narrowphase_caps_match_jax(mode):
    """Per-group (type_a, type_b, table size, max_narrow, phase): the
    non-fused modes cap each table at max_narrow_pairs and narrow_caps
    overrides a bucket; the fused modes keep the whole tables and ignore
    both, in both packages."""
    kw = dict(solver_mode=mode, max_narrow_pairs=32,
              narrow_caps={(1, 3): 16})

    def groups(scene):
        return [(g.type_a, g.type_b, int(g.pairs.shape[0]), g.max_narrow,
                 g.phase) for g in scene.pair_groups]
    want = groups(JaxLocoEnv(**kw).scene)
    assert groups(LocoEnv(device="cpu", **kw).scene) == want
    caps = {g[:2]: g[3] for g in want}
    if mode.startswith("fused"):
        assert caps == {(1, 1): 99, (1, 3): 45, (3, 3): 3}
    else:
        assert caps == {(1, 1): 32, (1, 3): 16, (3, 3): 3}
