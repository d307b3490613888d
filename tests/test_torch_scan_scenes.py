"""Port parity, module physics.py: one reference step of the golden
constraint_zoo (a chain of one link per joint type, with limits) in
"scan", "jacobi" and "colored", from tests/test_torch_fused_seq.py's
moved state (every link turned, moved and thrown, every limit past its
bound, seeded motors), against the JAX package's compiled step; the
tolerances of tests/test_torch_scan_step.py."""
import pytest
import torch

from dxk_tpu_torch.utils.convert import state_from_numpy
from test_torch_fused_seq import moved_state
from test_torch_scan_step import assert_step_matches, run_step_case

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


@pytest.mark.parametrize("mode", ["scan", "jacobi", "colored"])
def test_one_step_matches_jax(mode):
    start = state_from_numpy(moved_state("constraint_zoo", 1, 8), "cpu")
    jout, tout = run_step_case("constraint_zoo", mode, start)
    assert_step_matches(jout, tout)
