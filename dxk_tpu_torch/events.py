"""Collision / trigger events as data.

`physics_step` returns each step's solved contact pairs and per-pair summed
normal impulse in `StepInfo`; this module turns two consecutive StepInfos
into begin / end events (the reference engine's sorted merge of its
previous and current collision lists), and two trigger-overlap masks into
enter / leave masks. Counterpart of the JAX package's events.py.

  - `trigger_events`: pure mask algebra over the scene's static
    trigger-pair list, on any batch shape and device.
  - `collision_events`: host-side. Contact pairs occupy different rows
    from step to step (the reference step compacts them per env), so the
    diff keys on the collider-id pair. `StepInfo.contact_pairs` is (P, 2),
    shared by every env, on the fused step and (B, P, 2) on the reference
    step; `contact_mask` and `contact_impulse` are (B, P).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def trigger_events(prev_overlap, overlap):
    """Enter / leave masks over the scene's static trigger-pair list: a
    pair only in the new overlap enters, one only in the old leaves. Both
    args are bool tensors of the same shape (StepInfo.trigger_overlap)."""
    enter = overlap & ~prev_overlap
    leave = prev_overlap & ~overlap
    return enter, leave


@dataclass(frozen=True)
class CollisionEvent:
    """One begin / end event: the two colliders (and their owning bodies)
    plus the solver's accumulated normal impulse (for an end event, the
    last impulse seen)."""

    collider_a: int
    collider_b: int
    body_a: int
    body_b: int
    impulse: float


def _host_info(info, env=None):
    """(pairs, mask, impulse) of a batched StepInfo as numpy: pairs
    (B, P, 2), mask and impulse (B, P), or of env `env` alone (P, 2) and
    (P,), sliced before the host copy; P is 0 for a scene without contact
    rows."""
    if info.contact_pairs is None:
        B = info.num_contacts.shape[0]
        lead = () if env is not None else (B,)
        return (np.zeros(lead + (0, 2), np.int32), np.zeros(lead + (0,), bool),
                np.zeros(lead + (0,), np.float32))
    pairs, mask, imp = info.contact_pairs, info.contact_mask, \
        info.contact_impulse
    if env is not None:
        mask, imp = mask[env], imp[env]
        pairs = pairs[env] if pairs.dim() == 3 else pairs
    pairs, mask, imp = (x.detach().cpu().numpy() for x in (pairs, mask, imp))
    if env is None and pairs.ndim == 2:
        pairs = np.broadcast_to(pairs, (mask.shape[0],) + pairs.shape)
    return pairs, mask, imp


def _pair_impulses(pairs, mask, imp, min_impulse):
    """{(collider, collider): summed impulse} of one env's live rows."""
    out = {}
    for i in range(pairs.shape[0]):
        a, b = int(pairs[i, 0]), int(pairs[i, 1])
        if not mask[i] or a < 0:          # -1 = heightfield row
            continue
        key = (a, b) if a <= b else (b, a)
        out[key] = out.get(key, 0.0) + float(imp[i])
    if min_impulse > 0.0:
        # only collisions whose impulse clears a set threshold count
        out = {k: v for k, v in out.items() if v >= min_impulse}
    return out


def _diff(body_of, prev, cur):
    def ev(key, imp):
        a, b = key
        return CollisionEvent(a, b, int(body_of[a]), int(body_of[b]),
                              float(imp))

    begins = [ev(k, v) for k, v in sorted(cur.items()) if k not in prev]
    ends = [ev(k, v) for k, v in sorted(prev.items()) if k not in cur]
    return begins, ends


def _env_events(body_of, cur, prev, min_impulse):
    """(begins, ends) of one env's host (pairs, mask, impulse) triples."""
    p = _pair_impulses(*prev, min_impulse) if prev is not None else {}
    return _diff(body_of, p, _pair_impulses(*cur, min_impulse))


def collision_events_batched(scene, prev_info, info, min_impulse: float = 0.0
                             ) -> List[Tuple[List[CollisionEvent],
                                             List[CollisionEvent]]]:
    """Per-env begin / end diffs of batched StepInfos: one (begins, ends)
    per env. Begins carry the step's accumulated normal impulse, ends the
    last impulse seen. `prev_info` None: every live pair begins."""
    body_of = scene.colliders.body.detach().cpu().numpy()
    cur = _host_info(info)
    prev = _host_info(prev_info) if prev_info is not None else None
    return [_env_events(body_of, tuple(x[e] for x in cur),
                        tuple(x[e] for x in prev) if prev is not None
                        else None, min_impulse)
            for e in range(cur[1].shape[0])]


def collision_events(scene, prev_info, info, min_impulse: float = 0.0,
                     env: int = 0
                     ) -> Tuple[List[CollisionEvent], List[CollisionEvent]]:
    """Begin / end diff of one env (`env`) of batched StepInfos; only that
    env's rows are copied to the host. See collision_events_batched."""
    body_of = scene.colliders.body.detach().cpu().numpy()
    prev = (_host_info(prev_info, env) if prev_info is not None else None)
    return _env_events(body_of, _host_info(info, env), prev, min_impulse)
