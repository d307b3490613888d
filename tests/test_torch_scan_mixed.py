"""Port parity, module physics.py: one reference step of the golden
mixed_shape_drop (a convex hull, a cylinder and a capsule on a tilted box
ramp over a ground box) in "scan", with the three bodies lowered onto the
ramp and each other so that capsule-box, capsule-hull, cylinder-box and
box-hull rows are live, 3 solver iterations, against the JAX package's step run op by op
under jax.disable_jit() (a compiled JAX step of this scene takes minutes
to build on the CPU, and one op by op ~80 s, so "jacobi" and "colored"
are held on the other golden scenes; every bucket of this one is held in
tests/test_torch_narrowphase_ref.py); the tolerances of
tests/test_torch_scan_step.py."""
import torch

from test_torch_scan_step import (assert_step_matches, golden_scenes,
                                  lowered_state, run_step_case)

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

# metres the hull, the cylinder and the capsule are lowered
LOWER = {1: 1.4, 2: 2.15, 3: 3.2}


def test_one_step_matches_jax():
    start = lowered_state(golden_scenes("mixed_shape_drop")[1], LOWER)
    jout, tout = run_step_case("mixed_shape_drop", "scan", start, iters=3,
                               compiled=False)
    assert_step_matches(jout, tout)
    live = tout[1].contact_mask[0]
    pairs = tout[1].contact_pairs[0][live].tolist()
    # capsule-ramp, capsule-hull, cylinder-ramp and ramp-hull rows
    assert sorted(pairs) == [[1, 2], [3, 1], [4, 1], [4, 2]]
