"""Port parity, module physics.py: heightfield terrain on the reference
step. chip_smoke.py's terrain scene (BASELINE config 4's terrain under
config 3's ragdoll and four pieces of shape debris, no ground box) is
taken by the fused step in "fused"; in "jacobi" it runs the reference
step, with one terrain row per collider as a trailing phase slice
(contact_pairs -1 on those rows). One step of its seeded start lowered
0.5 m onto the terrain, 3 solver iterations, against the JAX package's
compiled step; the tolerances of tests/test_torch_scan_step.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from test_torch_scan_step import DT, assert_step_matches, jax_step

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


@functools.lru_cache(maxsize=None)
def scenes():
    return (chip_smoke.terrain_builder(JaxSceneBuilder,
                                       jax_add_ragdoll).finalize(),
            chip_smoke.terrain_scene("cpu"))


def test_one_jacobi_step_matches_jax():
    jscene, tscene = scenes()
    st = chip_smoke.terrain_initial_state(tscene, 1, 5)
    dyn = tscene.body_params.inv_mass > 0.0
    pos = st.pos.clone()
    pos[0, dyn, 1] -= 0.5
    st = st.replace(pos=pos)
    j0 = jscene.initial_state().replace(**{
        k: jnp.asarray(getattr(st, k)[0].numpy())
        for k in ("pos", "rot", "lin_vel", "ang_vel")})
    jout = jax_step(jscene, j0, "jacobi", 3)
    tout = physics_step(tscene, st, PhysicsSettings(
        num_rigid_solver_iterations=3, solver_mode="jacobi"), DT)
    assert_step_matches(jout, tout)
    C = tscene.colliders.ctype.shape[0]
    info = tout[1]
    # the terrain rows: the trailing C rows, live for some colliders
    assert bool(info.contact_mask[0, -C:].any())
    assert bool((info.contact_pairs[0, -C:] == -1).all())
    assert int(info.num_contacts[0]) > 0
