"""Port parity of the fused step on chip_smoke.py's sphere and cylinder
check pile (two spheres, a capsule, two cylinders and the golden hull on a
ground box; a row for every pair): one and three steps of one env, the
port's plain version against the JAX package's "fused" step run eagerly and
unbatched. The helpers and the golden scenes' steps are in
tests/test_torch_shapes.py; this file only holds the pile's trajectory, so
that it runs on a test worker of its own."""
import pytest

# importing test_torch_shapes also spends the process's first torch.sqrt
# call, as every port test file does
from test_torch_shapes import (_touching_state, _trajectory, check_one_step,
                               check_three_steps)


@pytest.fixture(scope="module")
def pile_run():
    """Three steps of the pile's first env (a jumble: every body overlapping
    others at seeded turns, the sphere-sphere, sphere-capsule,
    sphere-cylinder, sphere-hull, cylinder-cylinder and cylinder-box rows
    live)."""
    return _trajectory("pile", _touching_state("pile"), 3)


def test_pile_one_step_matches_jax(pile_run):
    """≤1e-6 on positions and rotations, ≤1e-5 on velocities after one
    step of 10 iterations."""
    check_one_step("pile", pile_run)


def test_pile_three_steps_match_jax(pile_run):
    """≤1e-4 after each of three steps on every state field."""
    check_three_steps(pile_run)
