"""Port parity, module utils/timestep.py (the fixed-timestep frame driver).

The frame driver's states against the JAX package's `frame` on the same
scene and frame times: the timer exactly (both run the same float32
arithmetic), the physics state, previous transforms and interpolated render
transforms within 1e-4 (a falling sphere that lands and bounces: the steps
agree to float32 rounding, which the contact's impulses grow to ~1e-5 over
120 substeps, as tests/test_torch_reference_step.py's five-step bound
allows). Also tests/test_utils.py's two checks on the port:
frames equal manual substeps, render transforms between the previous and
current state."""
import jax
import numpy as np
import pytest
import torch

from dxk_tpu.physics import PhysicsSettings as JaxSettings
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.utils import timestep as jts
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.utils import timestep as tts

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

TOL = 1e-4


def simple_scene(builder, device=None):
    """tests/test_utils.py's ball over a ground box."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    ball = b.add_body(position=(0, 3, 0))
    b.add_sphere_collider(ball, (0, 0, 0), 0.5)
    return (b.finalize() if device is None else b.finalize(device=device),
            ball)


@pytest.mark.parametrize("dt,frames,max_iterations", [
    (1 / 60.0, 60, 4),        # two substeps a frame; the ball lands
    (0.013, 40, 4),           # one or two substeps, time carried over
    (0.05, 10, 4),            # past max_iterations: time dropped
])
def test_frames_match_jax(dt, frames, max_iterations):
    jscene, ball = simple_scene(JaxSceneBuilder)
    tscene, _ = simple_scene(SceneBuilder, "cpu")
    js = JaxSettings(num_rigid_solver_iterations=4, solver_mode="jacobi")
    ts = PhysicsSettings(num_rigid_solver_iterations=4, solver_mode="jacobi")
    jf = jax.jit(lambda fs: jts.frame(jscene, fs, js, dt, frame_rate=120,
                                      max_iterations=max_iterations))
    jfs = jts.init_frame_state(jscene.initial_state())
    tfs = tts.init_frame_state(tscene.initial_state(1))
    for _ in range(frames):
        jfs, jpos, jrot = jf(jfs)
        tfs, tpos, trot = tts.frame(tscene, tfs, ts, dt, frame_rate=120,
                                    max_iterations=max_iterations)
        assert np.float32(tfs.timer) == np.float32(jfs.timer)
        for j, t in ((jfs.state.pos, tfs.state.pos),
                     (jfs.state.lin_vel, tfs.state.lin_vel),
                     (jfs.prev_pos, tfs.prev_pos),
                     (jfs.prev_rot, tfs.prev_rot),
                     (jpos, tpos), (jrot, trot)):
            assert float(np.abs(np.asarray(j) - t[0].numpy()).max()) <= TOL
    assert float(tfs.state.pos[0, ball, 1]) < 2.9


def test_frame_driver_matches_manual_substeps():
    """30 frames of 1/60 s at 120 Hz are 60 substeps (default settings)."""
    scene, ball = simple_scene(SceneBuilder, "cpu")
    settings = PhysicsSettings()
    fs = tts.init_frame_state(scene.initial_state(2))
    for _ in range(30):
        fs, _rpos, _rrot = tts.frame(scene, fs, settings, 1 / 60.0,
                                     frame_rate=120)
    manual = scene.initial_state(2)
    for _ in range(60):
        manual = physics_step(scene, manual, settings, 1 / 120)[0]
    assert torch.equal(fs.state.pos, manual.pos)


def test_interpolation_bounded():
    scene, ball = simple_scene(SceneBuilder, "cpu")
    settings = PhysicsSettings(num_rigid_solver_iterations=4,
                               solver_mode="jacobi")
    fs = tts.init_frame_state(scene.initial_state(1))
    for _ in range(20):
        fs, rpos, _rrot = tts.frame(scene, fs, settings, 0.013,
                                    frame_rate=120)
        lo = torch.minimum(fs.prev_pos[0, ball], fs.state.pos[0, ball])
        hi = torch.maximum(fs.prev_pos[0, ball], fs.state.pos[0, ball])
        assert bool((rpos[0, ball] >= lo - 1e-5).all())
        assert bool((rpos[0, ball] <= hi + 1e-5).all())
