"""Collision-sound triggers, the physics side of the audio hook: the JAX
package's utils/sound.py (numpy only; this is the port's own copy).

The reference's demo plays a 3D "Collision" sound per begin event with a
random pitch in [0.5, 1.5] and volume = saturate(remap(contact speed, 0.2,
20, 0, 1)) (application.cpp:192-201). The port's collision events carry
the solver's accumulated normal impulse (events.py); the speed is
recovered as impulse * (invMassA + invMassB), the delta-v that impulse gave
the pair.
"""

from __future__ import annotations

import numpy as np

_RNG = None


def _default_rng():
    global _RNG
    if _RNG is None:
        _RNG = np.random.default_rng(519431)
    return _RNG


def collision_sound_triggers(scene, begins, rng=None,
                             min_speed: float = 0.2,
                             max_speed: float = 20.0,
                             pitch_range=(0.5, 1.5),
                             sound_id: str = "Collision"):
    """Map collision-begin events (events.collision_events) to playable
    triggers: a list of dicts {sound_id, body_a, body_b, pitch, volume},
    the volume remapped and saturated; events below min_speed are dropped.

    `rng`: np.random.Generator for the pitch (default: one module-level
    generator seeded 519431 once, so that repeated calls advance the
    sequence). The scene's inverse masses are copied to the host once a
    call that has events."""
    if not begins:
        return []
    if rng is None:
        rng = _default_rng()
    inv_mass = scene.body_params.inv_mass.detach().cpu().numpy()
    out = []
    for ev in begins:
        speed = float(ev.impulse) * float(inv_mass[ev.body_a]
                                          + inv_mass[ev.body_b])
        volume = (speed - min_speed) / (max_speed - min_speed)
        volume = min(max(volume, 0.0), 1.0)
        if volume <= 0.0:
            continue
        out.append(dict(sound_id=sound_id, body_a=ev.body_a,
                        body_b=ev.body_b,
                        pitch=float(rng.uniform(*pitch_range)),
                        volume=volume))
    return out
