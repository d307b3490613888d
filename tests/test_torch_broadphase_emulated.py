"""Port check of csrc/broadphase.cu without a GPU: the source of the three
broadphase kernels (overlap matrix, K-select, sort-and-sweep), compiled with
g++ through tools/emulate_broadphase_cpu.py's CUDA shim, equals the plain
versions integer for integer on the small cases of
chip_smoke.BROADPHASE_CASES (C from 1 to 600: ragged tiles and row starts,
K-select column chunks; B 1 and 3; K 1, 8 and 20 (past the sliced walk); 1 and 4 contact phases;
statics first, in the middle and last; shared bodies; rows past K) and,
for the sort-and-sweep kernel alone, on chip_smoke.SWEEP_CASES (input
handed over unsorted; NaN, +-inf and inverted boxes; windows 1 to 9, past
C; rows whose window overflows; K 20, and K 300, past the shared tile,
with rows of more than 300 hits). The overlap matrix runs with whole
rows staged (SM count 1) and in column chunks (SM count 132). The plain
versions are held against the JAX package by tests/test_torch_broadphase.py;
no JAX here."""
import os
import shutil
import sys

import pytest
import torch

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). Every port test file spends that first call at import.
torch.sqrt(torch.ones(4096))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402

NO_GXX = shutil.which("g++") is None
pytestmark = pytest.mark.skipif(
    NO_GXX, reason="g++ is needed to build csrc/broadphase.cu on the CPU")


@pytest.fixture(scope="module")
def emu():
    import emulate_broadphase_cpu as emu_mod
    return emu_mod, emu_mod.build()


@pytest.mark.parametrize(
    "case", cs.BROADPHASE_CASES[:cs.BROADPHASE_SMALL_CASES],
    ids=lambda c: f"seed{c[0]}-B{c[1]}-C{c[2]}-K{c[3]}-ph{c[4]}")
def test_emulated_kernels_equal_plain(emu, case):
    mod, dll = emu
    r = mod.check_case(dll, case)
    assert mod.failures(r) == 0, r
    assert set(r) >= {"overlap_sms1", "overlap_sms132", "kselect", "sap"}


@pytest.mark.parametrize(
    "case", cs.SWEEP_CASES,
    ids=lambda c: f"seed{c[0]}-B{c[1]}-C{c[2]}-K{c[3]}-window{c[5]}-"
    + c[6].replace(" ", "-"))
def test_emulated_sweep_equals_plain(emu, case):
    mod, dll = emu
    r = mod.check_sweep_case(dll, case)
    assert mod.failures(r) == 0, r
    assert "sap" in r


def test_cases_reach_the_edges():
    """The small cases hold rows past K, statics at both ends and in the
    middle, a K-select past one column chunk and the one-collider env; the
    sweep's cases hold unsorted input, NaN, +-inf and inverted boxes,
    windows 1 and 4 and one past C, overflowing rows, K 20 and a K past
    the sweep's shared tile with rows of more hits than that."""
    small = cs.BROADPHASE_CASES[:cs.BROADPHASE_SMALL_CASES]
    assert {c[2] for c in small} >= {1, 31, 130, 600}
    assert {c[1] for c in small} == {1, 3}
    assert {c[3] for c in small} == {1, 8, 20}
    assert {c[4] for c in small} == {1, 4}
    seed, B, C, K, nph, statics, share, _window = small[6]
    _mn, _mx, body, owner, _ct = cs.broadphase_colliders(seed, B, C, statics,
                                                          share)
    assert int(owner[0]) == 1 and int(owner[C // 2]) == 1
    assert int(owner[-1]) == 1
    assert int((owner > 1).sum()) > 0          # force fields / triggers
    assert int((body[:-1] == body[1:]).sum()) > 0

    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    sweep = cs.SWEEP_CASES
    assert max(c[2] for c in sweep) <= 600
    assert {c[5] for c in sweep} >= {1, 4}
    assert any((c[2] - 1) // 128 * 128 + c[5] * 128 > c[2] for c in sweep)
    assert 20 in {c[3] for c in sweep}
    seen = dict(unsorted=0, nan=0, inf=0, inverted=0, overflowing=0,
                over_k=0, over_tile_k=0)
    for case in sweep:
        args = cs.sweep_case_inputs(case)
        _idx, _cls, cnt, ovf = sp.sap_sweep_plain(*args)
        r = cs.sweep_case_summary(case, args, cnt, ovf)
        x = args[0][..., 0]
        seen["unsorted"] += int((x[:, 1:] < x[:, :-1]).sum())
        seen["nan"] += r["nan"]
        seen["inf"] += r["inf"]
        seen["inverted"] += r["inverted"]
        seen["overflowing"] += r["rows_overflowing"]
        seen["over_k"] += r["rows_over_k"]
        if case[3] > sp.MAX_K:
            seen["over_tile_k"] += r["rows_over_k"]
    assert all(v > 0 for v in seen.values()), seen
