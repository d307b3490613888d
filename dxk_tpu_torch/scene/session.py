"""Editor-style play / pause / stop and undo over a scene's state.

Pressing play snapshots the editor state and starts stepping; stop throws
the runtime state away and restores the snapshot; the undo stack holds
snapshots of edits. Counterpart of the JAX package's scene/session.py. A
JAX state is immutable, so there a snapshot is a reference; torch tensors
can be written in place, so here every snapshot is a clone.
"""

from __future__ import annotations

import torch


class SceneSession:
    """Play / pause / stop and snapshot / undo over (scene, state).

    - `play()` snapshots the current (editor) state and starts stepping.
    - `pause()` / `resume()` freeze stepping (`step()` becomes a no-op).
    - `stop()` discards the runtime state and restores the play snapshot.
    - `snapshot()` pushes a copy of the current state on the undo stack;
      `undo()` pops and restores it.
    """

    def __init__(self, scene, step_fn, state=None):
        """step_fn(state) -> state, e.g. a physics_step closure. `state`
        defaults to scene.initial_state() (one env)."""
        self.scene = scene
        self._step_fn = step_fn
        self.state = state if state is not None else scene.initial_state()
        self._play_snapshot = None
        self._undo_stack = []
        self.playing = False
        self.paused = False

    # ---- play / pause / stop ----------------------------------------------

    def play(self):
        if self.playing:
            return
        self._play_snapshot = self.state.map_tensors(torch.clone)
        self.playing = True
        self.paused = False

    def pause(self):
        if self.playing:
            self.paused = True

    def resume(self):
        if self.playing:
            self.paused = False

    def stop(self):
        if not self.playing:
            return
        self.state = self._play_snapshot
        self._play_snapshot = None
        self.playing = False
        self.paused = False

    def step(self, *args, **kwargs):
        """Advance one frame unless stopped or paused. Returns the state."""
        if self.playing and not self.paused:
            self.state = self._step_fn(self.state, *args, **kwargs)
        return self.state

    # ---- undo stack ---------------------------------------------------------

    def snapshot(self):
        self._undo_stack.append(self.state.map_tensors(torch.clone))

    def undo(self):
        """Restore the most recent snapshot; no-op on an empty stack."""
        if self._undo_stack:
            self.state = self._undo_stack.pop()
        return self.state

    @property
    def undo_depth(self):
        return len(self._undo_stack)

    # ---- convenience --------------------------------------------------------

    def edit(self, fn):
        """Apply a state edit (e.g. move an entity in the editor): state ->
        state. Records an undo snapshot first."""
        self.snapshot()
        self.state = fn(self.state)
        return self.state

    def device_get(self):
        """A host copy of the current state (for serialization or a UI)."""
        return self.state.map_tensors(
            lambda x: x.detach().to("cpu", copy=True))

    # ---- editor picking ----------------------------------------------------

    def pick_nearest_body(self, point, k=1):
        """Editor picking: in every env, the k bodies whose positions are
        nearest `point` (3,). Returns (indices (B, k), sq_dists (B, k)), on
        the state's device."""
        from dxk_tpu_torch.utils.knn import knn

        pos = self.state.pos                                   # (B, N+1, 3)
        q = torch.as_tensor(point, dtype=torch.float32, device=pos.device)
        idx, sq = knn(pos, q.expand(pos.shape[0], 1, 3), k)
        return idx[:, 0], sq[:, 0]
