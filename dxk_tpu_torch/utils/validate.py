"""Debug-mode finiteness validation — the VALIDATE analog.

Each pipeline stage of `physics_step` registers a named finiteness check
when `PhysicsSettings.validate` is on, and the step reports, per env, the
FIRST offending stage (or -1) in `StepInfo.validate_stage`: a (B,) int32
tensor that stays on the step's device (no host copy inside the step), so
callers can gate host-side raises themselves. Counterpart of the JAX
package's utils/validate.py; off, the tracker is not made and nothing is
checked.

A checked tensor whose leading dimension is the env batch is judged per
env; any other tensor (a scene's static table) is shared by every env.
"""

from __future__ import annotations

import dataclasses

import torch

# stage name -> id, in pipeline order (the JAX package's ids)
STAGE_NAMES = (
    "world_colliders",
    "aabbs",
    "contacts",
    "body_velocities",
    "constraint_prep",
    "solved_velocities",
    "integrated_state",
)
STAGE_ID = {n: i for i, n in enumerate(STAGE_NAMES)}


def _float_leaves(tree):
    """The floating-point tensors of a tensor, dataclass, tuple, list or
    dict tree."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _float_leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _float_leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _float_leaves(x)


class StageTracker:
    """Collects per-env finiteness flags of one step of `batch` envs."""

    def __init__(self, batch: int, device):
        self.batch = batch
        self.device = device
        self._bad = []   # (stage_id, (B,) bool: some value not finite)

    def check(self, stage: str, tree):
        bad = torch.zeros(self.batch, dtype=torch.bool, device=self.device)
        for x in _float_leaves(tree):
            if x.dim() >= 1 and x.shape[0] == self.batch:
                bad = bad | ~torch.isfinite(x).reshape(self.batch, -1).all(1)
            else:
                bad = bad | ~torch.isfinite(x).all()
        self._bad.append((STAGE_ID[stage], bad))

    def first_bad(self) -> torch.Tensor:
        """(B,) int32: each env's first offending stage id, or -1 where
        every checked stage was finite."""
        out = torch.full((self.batch,), -1, dtype=torch.int32,
                         device=self.device)
        for sid, bad in reversed(self._bad):
            out = torch.where(bad, sid, out)
        return out


def check_finite(tree, name: str = "value") -> torch.Tensor:
    """0-d bool tensor: True when every float tensor of `tree` is finite.
    `name` is unused: it keeps the JAX package's signature."""
    del name
    ok = torch.ones((), dtype=torch.bool)
    for x in _float_leaves(tree):
        ok = ok.to(x.device) & torch.isfinite(x).all()
    return ok
