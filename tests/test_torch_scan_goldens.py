"""The golden trajectories of tests/test_golden_trajectories.py on the
port's "scan" (the JAX package's goldens, recorded by its "scan"), every
25th step's positions and rotations within 1e-3: double_pendulum over
1000 steps here (sphere_bounce and box_stack are in
tests/test_torch_scan_step.py); constraint_zoo over 1000 steps,
ragdoll_settle over its first 50 and mixed_shape_drop over 1000 steps
(which fails, MIXED_REASON) and over its first 250 are marked slow, as
the JAX package marks the same three."""
import pytest
import torch

from test_torch_scan_step import GOLDEN_TOL, golden_deviation

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


def test_golden_double_pendulum():
    assert golden_deviation("double_pendulum", 1000) <= GOLDEN_TOL


MIXED_REASON = (
    "the 1000-step case fails. The port's \"scan\" is bit-equal to the "
    "golden at steps 25 and 50, 9.5e-7 off at step 75, past 1e-3 at step "
    "350 and 0.239 away within 1000 steps; with its damping as the product "
    "by the reciprocal (the form a compiler may fold the division into) "
    "still 0.101. The JAX package's step run op by op from the port's "
    "step-50 state is bit-equal to the port to step 66, parts from it at "
    "step 67 by one ulp (a 3-term product, which XLA rounds as a chain of "
    "fused multiply-adds) and is 9.5e-7 from the golden at step 75, as the "
    "port is (tools/golden_divergence_cpu.py). Whether the JAX package's "
    "compiled step follows the golden to step 1000 here is not measured: "
    "its compile takes tens of GiB")


@pytest.mark.slow
@pytest.mark.parametrize("name,steps", [("constraint_zoo", 1000),
                                        ("mixed_shape_drop", 250),
                                        ("mixed_shape_drop", 1000),
                                        ("ragdoll_settle", 50)])
def test_golden_slow(name, steps):
    assert golden_deviation(name, steps) <= GOLDEN_TOL, (
        MIXED_REASON if name == "mixed_shape_drop" else name)
