"""Port parity, module utils/sound.py: collision_sound_triggers of both
packages on the demo scene's bodies, for the same begin events and the
same numpy generator, and through each package's module-level default
generator (seeded 519431 once). The mapping is float64 host arithmetic
on the same float32 inverse masses, so triggers are held equal."""
import numpy as np
import torch

from dxk_tpu.events import CollisionEvent as JaxCollisionEvent
from dxk_tpu.utils import sound as jsound
from dxk_tpu_torch.events import CollisionEvent
from dxk_tpu_torch.examples.demo_scene import build_demo_scene
from dxk_tpu_torch.utils import sound as tsound

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


def _events(scene, n, seed):
    """n begin events between seeded collider pairs, impulses from 0 to
    ~100 N s (below and above the audible band)."""
    rng = np.random.default_rng(seed)
    body = scene.colliders.body.numpy()
    C = body.shape[0]
    out = []
    for _ in range(n):
        a, b = sorted(rng.choice(C, 2, replace=False).tolist())
        out.append((a, b, int(body[a]), int(body[b]),
                    float(np.float32(rng.exponential(10.0)))))
    return out


def test_triggers_match_jax(monkeypatch):
    import examples.demo_scene as jdemo
    jb, _ = jdemo.build_demo_scene()
    jscene = jb.finalize(max_narrow_pairs_per_group=64)
    tb, _ = build_demo_scene(device="cpu")
    scene = tb.finalize(max_narrow_pairs_per_group=64, device="cpu")
    assert np.array_equal(scene.body_params.inv_mass.numpy(),
                          np.asarray(jscene.body_params.inv_mass))
    ev = _events(scene, 200, 9)
    got = tsound.collision_sound_triggers(
        scene, [CollisionEvent(*e) for e in ev],
        rng=np.random.default_rng(519431))
    want = jsound.collision_sound_triggers(
        jscene, [JaxCollisionEvent(*e) for e in ev],
        rng=np.random.default_rng(519431))
    assert got == want
    assert 0 < len(got) < len(ev)            # some dropped as inaudible
    # the module-level default generators advance the same sequence (each
    # module's own, fresh here and restored after the test)
    monkeypatch.setattr(tsound, "_RNG", None)
    monkeypatch.setattr(jsound, "_RNG", None)
    for _ in range(2):
        got = tsound.collision_sound_triggers(
            scene, [CollisionEvent(*e) for e in ev[:50]])
        want = jsound.collision_sound_triggers(
            jscene, [JaxCollisionEvent(*e) for e in ev[:50]])
        assert got == want
