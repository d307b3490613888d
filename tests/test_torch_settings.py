"""Port parity, PhysicsSettings (physics.py): the port has every field of
the JAX package's PhysicsSettings, each with the JAX default, so
`physics_step(scene, state, PhysicsSettings())` runs the same solvers in
both packages ("scan" sequential impulses, "scan" cloth). Exact: these are
constants."""
import dataclasses

import pytest
import torch

from dxk_tpu.physics import PhysicsSettings as JaxSettings
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

PORT_FIELDS = [f.name for f in dataclasses.fields(PhysicsSettings)]
# the cloth fields, the last the port took over (ROADMAP Queue A 5a)
CLOTH_FIELDS = {"num_cloth_velocity_iterations",
                "num_cloth_position_iterations", "num_cloth_drift_iterations",
                "cloth_solver_mode", "cloth_two_way"}


@pytest.mark.parametrize("name", PORT_FIELDS)
def test_default_matches_jax(name):
    assert getattr(PhysicsSettings(), name) == getattr(JaxSettings(), name)


def test_only_cloth_fields_missing():
    """No field is missing any more: the port has every JAX field, in the
    JAX package's order, the cloth fields among them."""
    jax_fields = [f.name for f in dataclasses.fields(JaxSettings)]
    assert PORT_FIELDS == jax_fields
    assert CLOTH_FIELDS <= set(PORT_FIELDS)


def test_default_step_is_scan():
    """The default settings step exactly as solver_mode="scan" does."""
    b = SceneBuilder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    for i in range(3):
        body = b.add_body(position=(0.1 * i, 0.49 + 0.99 * i, 0))
        b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    scene = b.finalize(device="cpu")
    st = scene.initial_state(2)
    a = physics_step(scene, st, PhysicsSettings(), 1 / 120)[0]
    s = physics_step(scene, st, PhysicsSettings(solver_mode="scan"),
                     1 / 120)[0]
    j = physics_step(scene, st, PhysicsSettings(solver_mode="jacobi"),
                     1 / 120)[0]
    assert torch.equal(a.pos, s.pos) and torch.equal(a.lin_vel, s.lin_vel)
    assert not torch.equal(a.lin_vel, j.lin_vel)
