"""The 24-sided prism's cases of tests/test_torch_wide_hull.py (caps of 24
loop points, past the fused kernel's per-thread clip buffers): the plain
box-hull and hull-hull recipes against the JAX package's, the prism
against a box and, as side B, against the tetrahedron. A file of its own
so that the two files' eager JAX clips run on two test workers."""
import pytest
import torch

import test_torch_wide_hull as tw

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). Every port test file spends that first call at import.
torch.sqrt(torch.ones(4096))

_lanes = tw._lanes          # the lane-count fixture


@pytest.mark.parametrize("name", ["prism24"])
def test_box_wide_hull_cm(name):
    tw.test_box_wide_hull_cm(name)


@pytest.mark.parametrize("pair", [("tetra", "prism24")])
def test_wide_hull_hull_cm(pair):
    tw.test_wide_hull_hull_cm(pair)
