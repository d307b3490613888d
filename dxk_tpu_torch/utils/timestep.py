"""Fixed-timestep frame driver with transform interpolation: accumulate
frame time, run up to `max_iterations` fixed 1/frame_rate substeps, drop
the time beyond that, and expose render transforms interpolated between the
previous and the current physics state. Counterpart of the JAX package's
utils/timestep.py; its masked `lax.scan` over substeps is a loop here.

The frame clock is one float32 host scalar shared by every env of the
batch, as the JAX timer is a float32 scalar: the substep count of a frame
is decided on the host, with the JAX package's float32 arithmetic, and no
device value is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from dxk_tpu_torch.core.maths import lerp, quat_normalize
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene.scene import Scene, State


@dataclass
class FrameState:
    """The current physics state, the previous substep's transforms and
    the substep timer."""

    state: State             # current physics state
    prev_pos: torch.Tensor   # (B, N+1, 3) previous substep transforms
    prev_rot: torch.Tensor   # (B, N+1, 4)
    timer: np.float32        # accumulated time


def init_frame_state(state: State) -> FrameState:
    return FrameState(state=state, prev_pos=state.pos, prev_rot=state.rot,
                      timer=np.float32(0.0))


def frame(scene: Scene, fs: FrameState, settings: PhysicsSettings, dt,
          frame_rate: int = 120, max_iterations: int = 4
          ) -> Tuple[FrameState, torch.Tensor, torch.Tensor]:
    """Advance one render frame by `dt`. Returns (FrameState, render_pos,
    render_rot), the transforms interpolated by timer / fixed_dt."""
    fixed_dt = 1.0 / frame_rate
    fdt = np.float32(fixed_dt)
    timer = np.float32(fs.timer) + np.float32(dt)

    will_step = timer >= fdt
    prev_pos = fs.state.pos if will_step else fs.prev_pos
    prev_rot = fs.state.rot if will_step else fs.prev_rot

    state = fs.state
    for _ in range(max_iterations):
        if timer >= fdt:
            state, _ = physics_step(scene, state, settings, fixed_dt)
            timer = timer - fdt
    # drop the excess time
    if timer >= fdt:
        timer = np.fmod(timer, fdt)

    t = float(timer / fdt)
    render_pos = lerp(prev_pos, state.pos, t)
    render_rot = quat_normalize(lerp(prev_rot, state.rot, t))
    return (FrameState(state=state, prev_pos=prev_pos, prev_rot=prev_rot,
                       timer=timer), render_pos, render_rot)
