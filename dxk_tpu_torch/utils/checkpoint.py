"""Checkpoint / resume: the counterpart of the JAX package's
utils/checkpoint.py (orbax there, `torch.save` here).

`Checkpointer` keeps one sub-directory per step (`<directory>/<step>/
state.pt`) and prunes all but the newest `max_to_keep`. `BestModelTracker`
saves on a new best mean reward and keeps that reward in a
`best_reward.txt` sidecar, so a resumed run does not checkpoint its first,
possibly worse, iteration as the best.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _to_template(saved, template):
    """`saved` in the structure of `template`: tensors copied onto the
    template tensor's device and dtype, dicts matched key by key; raises
    where the structures differ."""
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(_to_template(saved, template.state_dict()))
        return template
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint: {getattr(saved, 'shape', saved)} "
                             f"where the template holds {template.shape}")
        return saved.to(template.device, template.dtype)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError("checkpoint: keys differ from the template's")
        return type(template)((k, _to_template(saved[k], v))
                              for k, v in template.items())
    return saved


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state: Any) -> None:
        """`state` (a tensor, a module's state_dict, a dict of tensors and
        numbers) written under `step`, tensors copied to the CPU; then the oldest
        steps beyond `max_to_keep` removed."""
        path = os.path.join(self.directory, str(int(step)))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(_cpu(state), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The state saved under `step` (default: the latest; None if there
        is none), in `template`'s structure, devices and dtypes when one is
        given (a module is loaded in place and returned)."""
        step = self.latest_step if step is None else step
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(int(step)),
                                        STATE_FILE), map_location="cpu",
                           weights_only=True)
        return saved if template is None else _to_template(saved, template)

    @property
    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None


def _cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, torch.nn.Module):
        return _cpu(state.state_dict())
    if isinstance(state, dict):
        return {k: _cpu(v) for k, v in state.items()}
    return state


class BestModelTracker:
    """Save-on-new-best semantics: track the mean episode reward and save
    when it improves. The best reward is persisted to a sidecar file so a
    resumed run (--resume) does not checkpoint its first, possibly worse,
    iteration as 'best'."""

    def __init__(self, ckpt: Checkpointer):
        self.ckpt = ckpt
        self._sidecar = os.path.join(ckpt.directory, "best_reward.txt")
        self.best = -float("inf")
        if os.path.exists(self._sidecar):
            try:
                with open(self._sidecar) as f:
                    self.best = float(f.read().strip())
            except (ValueError, OSError):
                pass

    def update(self, step: int, mean_reward: float, state: Any) -> bool:
        if mean_reward > self.best:
            self.best = mean_reward
            self.ckpt.save(step, state)
            os.makedirs(self.ckpt.directory, exist_ok=True)
            with open(self._sidecar, "w") as f:
                f.write(repr(float(mean_reward)))
            return True
        return False
