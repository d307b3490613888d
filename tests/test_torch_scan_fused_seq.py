"""The mirror of the JAX package's tests/test_fused_seq.py on the port, on
the CPU where both are plain PyTorch: the port's "scan" (the reference
step) and "fused_seq" (the fused step's plain version) of the mixed scene
(three stacked boxes, a sphere, a capsule on a ball joint to the ground),
30 solver iterations: bit-equal velocities and positions after the first
step (identical operation order), and positions within 5e-3 after 50
steps. On the card the kernel contracts multiply-adds and eager PyTorch
does not, so there chip_smoke.py holds the pair to a stated tolerance."""
import torch

from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from test_torch_fused_seq import _mixed_builder

DT = 1.0 / 120.0


def _scene():
    return _mixed_builder(SceneBuilder).finalize(device="cpu")


def _step(scene, state, mode):
    return physics_step(scene, state, PhysicsSettings(solver_mode=mode),
                        DT)[0]


def test_first_step_bit_exact():
    scene = _scene()
    s0 = scene.initial_state(1)
    a = _step(scene, s0, "scan")
    b = _step(scene, s0, "fused_seq")
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        assert float((getattr(a, k) - getattr(b, k)).abs().max()) == 0.0, k


def test_short_horizon_matches_scan():
    scene = _scene()
    sa = sb = scene.initial_state(1)
    for _ in range(50):
        sa = _step(scene, sa, "scan")
        sb = _step(scene, sb, "fused_seq")
    assert float((sa.pos - sb.pos).abs().max()) < 5e-3
    assert bool(torch.isfinite(sb.pos).all())
