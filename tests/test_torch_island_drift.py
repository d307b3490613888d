"""Port parity, BASELINE config 1's default path over many steps: the
sideways drift of bench.py's box towers on the island step.

At the bench tuning (16 unit boxes a tower, 1.001 spawn gaps,
contact_phases=2, candidate_margin=0.25, 30 iterations, dt 1/120) the
towers of the JAX package's own island step drift sideways from the first
steps on and lean past tests/test_islands.py's 0.25 m bound within a few
hundred steps (tools/island_towers_cpu.py). This holds the port's drift
against the JAX package's: 16 towers, 60 steps, the port's "fused" island
step (the kernel's plain version) against the JAX island "colored" step,
both from bench.py's spawn:

  - each island's largest x/z box move, averaged over the islands,
    within 15 % of the JAX package's (measured here: 4 %; per island the
    drift differs by up to ~30 % between the packages, as between two
    islands of one package, since float rounding picks its direction);
  - the median top-box fall within 2e-3 m of the JAX package's (measured
    here: 1e-4 m);
  - in both packages the average move is past 1 cm, so the drift is the
    reference step's, not the port's.

The JAX "fused" step of a box-box scene is not compiled here (half a
minute with XLA's fusion pass off); tools/island_towers_cpu.py --towers 16
--steps 60 --jax-modes colored,fused prints both packages' drift in each
mode."""
import jax
import numpy as np
import torch

from dxk_tpu.physics import PhysicsSettings as JaxSettings
from dxk_tpu.physics import physics_step as jax_physics_step
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu.scene.islands import islandize as jax_islandize
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.islands import islandize

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

DT = 1.0 / 120.0
ITERS = 30
TOWERS = 16
STEPS = 60
XZ_REL_TOL = 0.15
DROP_TOL = 2e-3
MIN_DRIFT = 0.01


def bench_towers(builder):
    """bench.py's towers (16 unit boxes, 1.001 apart) in a row 3 m apart."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (60, 1, 60))
    for t in range(TOWERS):
        for i in range(16):
            bd = b.add_body(position=(t * 3.0, 0.5 + 1.001 * i, 0.0))
            b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


def drift(pos, pos0):
    """Each island's top-box fall and its largest x/z box move."""
    top = pos0.shape[1] - 2               # the dummy body is last
    xz = np.abs(pos - pos0)[:, :-1][..., [0, 2]].max(axis=(1, 2))
    return pos0[:, top, 1] - pos[:, top, 1], xz


def test_island_drift_matches_jax():
    kw = dict(contact_phases=2, candidate_margin=0.25)
    jscene = bench_towers(JaxSceneBuilder).finalize(**kw)
    jim = jax_islandize(jscene)
    js = JaxSettings(num_rigid_solver_iterations=ITERS,
                     solver_mode="colored")
    jstep = jax.jit(jax.vmap(
        lambda x: jax_physics_step(jim.sub_scene, x, js, DT)[0]))
    jst = jim.gather(jscene.initial_state())
    pos0 = np.asarray(jst.pos)
    for _ in range(STEPS):
        jst = jstep(jst)

    tscene = bench_towers(SceneBuilder).finalize(device="cpu", **kw)
    tim = islandize(tscene)
    ts = PhysicsSettings(num_rigid_solver_iterations=ITERS,
                         solver_mode="fused")
    tst = tim.gather(tscene.initial_state(1))
    np.testing.assert_array_equal(tst.pos.numpy(), pos0)
    for _ in range(STEPS):
        tst = physics_step(tim.sub_scene, tst, ts, DT)[0]

    assert bool(torch.isfinite(tst.pos).all())
    j_drop, j_xz = drift(np.asarray(jst.pos), pos0)
    t_drop, t_xz = drift(tst.pos.numpy(), pos0)
    assert j_xz.mean() > MIN_DRIFT and t_xz.mean() > MIN_DRIFT, (
        j_xz.mean(), t_xz.mean())
    assert abs(t_xz.mean() - j_xz.mean()) < XZ_REL_TOL * j_xz.mean(), (
        t_xz.mean(), j_xz.mean())
    assert abs(np.median(t_drop) - np.median(j_drop)) < DROP_TOL, (
        np.median(t_drop), np.median(j_drop))
