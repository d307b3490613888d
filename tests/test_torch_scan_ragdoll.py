"""Port parity, module physics.py: one reference step of the golden
ragdoll_settle (a ragdoll on a ground box: capsule-capsule, capsule-box
and box-box rows, six hinges and seven cone-twists in five colours) in
"scan", "jacobi" and "colored", from the seeded golden start lowered
0.6 m onto the ground, against the JAX package's compiled step; the
tolerances of tests/test_torch_scan_step.py."""
import pytest
import torch

from test_torch_scan_step import (assert_step_matches, golden_scenes,
                                  lowered_state, run_step_case)

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


@pytest.mark.parametrize("mode", ["scan", "jacobi", "colored"])
def test_one_step_matches_jax(mode):
    start = lowered_state(golden_scenes("ragdoll_settle")[1], 0.6)
    jout, tout = run_step_case("ragdoll_settle", mode, start)
    assert_step_matches(jout, tout)
    assert int(tout[1].contact_mask.sum()) >= 4
