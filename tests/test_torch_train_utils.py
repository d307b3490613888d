"""Port checks of the training slice's utilities and entry point, on the
CPU: utils/checkpoint.py and utils/profiling.py (mirrors of the JAX
package's tests/test_utils.py checkpoint and stats tests), LocoEnv taking
the JAX constructor's narrowphase arguments, a fresh policy's
initialisation against flax's (lecun_normal kernels, zero biases), and
`python -m dxk_tpu_torch.train.train_locomotion` trained one iteration on
the CPU and resumed. No JAX here."""
import math
import os

import numpy as np
import pytest
import torch

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). Every port test file spends that first call at import.
torch.sqrt(torch.ones(4096))

from dxk_tpu_torch.envs.loco_env import LocoEnv  # noqa: E402
from dxk_tpu_torch.models.policy import (TRUNCATED_NORMAL_STD,  # noqa: E402
                                         ActorCritic)
from dxk_tpu_torch.train import train_locomotion  # noqa: E402
from dxk_tpu_torch.utils.checkpoint import (BestModelTracker,  # noqa: E402
                                            Checkpointer)
from dxk_tpu_torch.utils.profiling import (StatsLogger,  # noqa: E402
                                           profile_block, step_timer, sync)


class TestCheckpoint:
    def test_save_restore_best_tracker(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "ckpt"))
        tracker = BestModelTracker(ckpt)
        state = {"w": torch.arange(4.0), "step": torch.tensor(1)}
        assert tracker.update(1, 1.0, state)
        assert not tracker.update(2, 0.5, state)      # no improvement
        state2 = {"w": torch.arange(4.0) * 2, "step": torch.tensor(3)}
        assert tracker.update(3, 2.0, state2)
        restored = ckpt.restore(template=state)
        assert torch.equal(restored["w"], torch.arange(4.0) * 2)
        # the sidecar carries the best reward into a new tracker
        assert BestModelTracker(ckpt).best == 2.0

    def test_prunes_to_max_to_keep_and_loads_a_module(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
        nets = [ActorCritic(27, 66, generator=torch.Generator().manual_seed(s))
                for s in range(3)]
        for step, net in enumerate(nets):
            ckpt.save(10 * step, net.state_dict())
        assert ckpt.latest_step == 20
        assert sorted(os.listdir(tmp_path)) == ["10", "20"]
        target = ActorCritic(27, 66, generator=torch.Generator().manual_seed(9))
        ckpt.restore(10, template=target)
        assert all(torch.equal(a, b) for a, b in zip(
            target.state_dict().values(), nets[1].state_dict().values()))
        with pytest.raises(ValueError):
            ckpt.restore(template={"other": torch.zeros(1)})
        assert Checkpointer(str(tmp_path / "none")).restore() is None


class TestStats:
    def test_logger_csv(self, tmp_path):
        path = str(tmp_path / "stats.csv")
        log = StatsLogger(path)
        log.log(0, {"contacts": torch.tensor(5), "reward": 1.5})
        log.log(1, {"contacts": torch.tensor(7), "reward": 2.5})
        log.flush()
        text = open(path).read()
        assert "contacts" in text and "2.5" in text

    def test_timer_and_blocks(self):
        out = {}
        x = torch.ones(3)
        with profile_block("block"), step_timer(out, "t", x):
            x = x * 2
        sync({"a": [x]})
        assert out["t"] >= 0.0


@pytest.mark.parametrize("mode", ["fused", "fused_seq"])
def test_loco_env_takes_the_jax_narrowphase_arguments(mode):
    """examples/train_locomotion.py passes narrow_caps; the fused modes
    ignore both arguments, as the JAX package's LocoEnv does."""
    env = LocoEnv(solver_iterations=2, solver_mode=mode, max_narrow_pairs=8,
                  narrow_caps={(1, 1): 24, (1, 3): 20, (3, 3): 3},
                  device="cpu")
    plain = LocoEnv(solver_iterations=2, solver_mode=mode, device="cpu")
    assert env.settings == plain.settings
    assert [g.pairs.shape for g in env.scene.pair_groups] == [
        g.pairs.shape for g in plain.scene.pair_groups]


def test_fresh_policy_initialised_as_flax():
    """Kernels lecun_normal: over ten seeds each layer's std within 5 % of
    sqrt(1 / fan_in), nothing past flax's cut at 2 sqrt(1 / fan_in) /
    0.87962566; biases zero; the action head's last kernel in
    [0, 1e-4); log_std zero; the same seed gives the same weights."""
    nets = [ActorCritic(27, 66, generator=torch.Generator().manual_seed(s))
            for s in range(10)]
    for name, w in nets[0].named_parameters():
        ws = torch.stack([dict(n.named_parameters())[name].detach()
                          for n in nets])
        if name.endswith("bias") or name == "log_std":
            assert float(ws.abs().max()) == 0.0, name
        elif name == "pi.dense2.weight":
            assert 0.0 <= float(ws.min()) and float(ws.max()) < 1e-4
        else:
            target = math.sqrt(1.0 / w.shape[1])
            assert abs(float(ws.std()) / target - 1.0) < 0.05, name
            cut = 2.0 * target / TRUNCATED_NORMAL_STD
            assert float(ws.abs().max()) <= cut * (1 + 1e-6), name
            assert float(ws.abs().max()) > 0.9 * cut, name     # reaches it
    again = ActorCritic(27, 66, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        again.state_dict().values(), nets[0].state_dict().values()))


def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--num-envs", "2", "--unroll", "2",
            "--iters", "1", "--solver-iterations", "2",
            "--ckpt-dir", str(tmp_path / "ckpt"),
            "--csv", str(tmp_path / "train.csv"), *extra]


def test_train_locomotion_trains_and_resumes_on_the_cpu(tmp_path):
    """One iteration: 4 minibatches x 10 epochs of Adam updates, finite
    metrics, the parameters moved and saved at step 1; --resume starts
    from step 1 with the saved parameters."""
    run = train_locomotion.main(_argv(tmp_path))
    (m,) = run["metrics"]
    assert m["adam_updates"] == 40 and run["final_step"] == 1
    assert all(np.isfinite(m[k]) for k in ("loss", "reward_per_step",
                                           "episode_done_rate"))
    params = run["train_state"].net.state_dict()
    assert max(float((params[k] - run["initial_params"][k]).abs().max())
               for k in params) > 0.0
    assert os.path.exists(tmp_path / "train.csv")
    resumed = train_locomotion.main(_argv(tmp_path, "--resume"))
    assert resumed["start"] == 1 and resumed["final_step"] == 2
    assert all(torch.equal(resumed["initial_params"][k], params[k])
               for k in params)
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step == 2


def test_train_locomotion_needs_a_card_unless_told(tmp_path):
    argv = _argv(tmp_path)[2:]                    # no --device: the card
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_locomotion.main(argv)
    with pytest.raises(NotImplementedError, match="Queue A 10"):
        train_locomotion.main(argv + ["--mesh"])


def test_train_locomotion_defaults_follow_tmpdir(tmp_path, monkeypatch):
    """The checkpoint directory and the CSV default to names of the port's
    own under $TMPDIR: never the JAX example's /tmp/dxk_loco_* paths."""
    import tempfile
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)   # re-read $TMPDIR
    args = train_locomotion.parse_args([])
    assert args.ckpt_dir == str(tmp_path / "dxk_torch_loco_ckpt")
    assert args.csv == str(tmp_path / "dxk_torch_loco_train.csv")
