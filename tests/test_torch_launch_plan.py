"""The fused kernel's launch plan and working set (ops/kernels/fused_step.py:
FusedTables.shared_layout, launch_plan, scratch_shapes), on the CPU.

The kernel (csrc/fused_step.cu) packs several envs into a block, each on a
team of whole warps, keeps in shared memory only what its solve rewrites and
puts the contact points and row deltas in a device-memory scratch. These
tests hold the plan the wrapper computes for chip_smoke.py's scenes, the
1,081-row box pile that the one-env-per-block layout could not hold, the
static tables the kernel's live lists are built from, and the claim that
summing only the live rows' deltas changes no bit. They build scenes only;
nothing of JAX is compiled, no kernel is launched (the g++ emulation,
tools/emulate_fused_step_cpu.py, runs the kernel itself)."""
import numpy as np
import pytest
import torch

import chip_smoke
from dxk_tpu_torch.envs.loco_env import LocoEnv
from dxk_tpu_torch.ops.heightmap import make_heightfield
from dxk_tpu_torch.ops.kernels import fused_step as fs

# The first torch.sqrt call of a process can come back at reduced precision on
# this CPU build of PyTorch; every test file spends it at import.
torch.sqrt(torch.ones(4096))

SCENES = {
    "loco": lambda: LocoEnv(solver_mode="fused", device="cpu").scene,
    "zoo": lambda: chip_smoke.zoo_scene(device="cpu"),
    "settle": lambda: chip_smoke.settle_scene("cpu"),
    "mixed": lambda: chip_smoke.shapes_scene("mixed_shape_drop", "cpu"),
    "terrain": lambda: chip_smoke.terrain_scene("cpu"),
    "bigpile": lambda: chip_smoke.bigpile_scene("cpu"),
}
# (E, W) at 4096 envs: one warp per env; the zoo's 24.7 KB of shared memory
# an env (14.6 KB of them its 96 joints' rows) fit three envs a block, three
# blocks an SM, the others eight envs a block, two blocks an SM
PLAN_4096 = {"loco": (8, 1), "zoo": (3, 1), "settle": (8, 1),
             "mixed": (8, 1), "terrain": (8, 1), "bigpile": (8, 1)}
_TABLES = {}


def tables(name):
    if name not in _TABLES:
        _TABLES[name] = fs.fused_tables(SCENES[name](), "cpu")
    return _TABLES[name]


def check_plan(tab, batch, plan):
    assert plan.threads == 32 * plan.envs * plan.warps <= 256
    assert plan.blocks == -(-batch // plan.envs)
    block_w, env_w = tab.shared_layout()
    assert (plan.block_bytes, plan.env_bytes) == (4 * block_w, 4 * env_w)
    assert plan.smem_bytes == plan.block_bytes + plan.envs * plan.env_bytes
    assert plan.smem_bytes <= fs.BLOCK_SHARED
    # the blocks an SM holds by warps and by shared memory
    per_sm = min(fs.SM_WARPS // (plan.envs * plan.warps),
                 fs.SM_SHARED // (plan.smem_bytes + fs.BLOCK_RESERVED))
    assert per_sm >= 1


@pytest.mark.parametrize("name", sorted(PLAN_4096))
def test_launch_plan_at_4096(name):
    """At the main paths' 4096 envs every scene runs one warp per env, and
    the ragdoll scenes and the zoo pack several envs into a block."""
    tab = tables(name)
    plan = tab.launch_plan(4096)
    check_plan(tab, 4096, plan)
    assert (plan.envs, plan.warps) == PLAN_4096[name]
    if name in ("loco", "zoo", "settle"):
        assert plan.envs > 1


@pytest.mark.parametrize("batch,want", [(1, (1, 8)), (256, (1, 8)),
                                        (1000, (4, 2)), (1001, (4, 2)),
                                        (2112, (8, 1))])
def test_launch_plan_fills_the_card_at_small_batches(batch, want):
    """Below 132 SMs x 16 warps of envs each env gets more warps (up to
    eight: the one-block-per-env geometry at bench.py's 256), so no batch
    leaves SMs idle that the one-env-per-block kernel used; the box pile's
    check batches (256 and a ragged 1000) run it on teams of several warps
    behind named barriers. A ragged batch's last block has missing envs."""
    for name in ("loco", "settle", "bigpile"):
        tab = tables(name)
        plan = tab.launch_plan(batch)
        check_plan(tab, batch, plan)
        assert (plan.envs, plan.warps) == want, name
    assert tables("bigpile").launch_plan(1001).blocks * 4 > 1001


def test_bigpile_fits_where_one_env_per_block_did_not():
    """47 boxes, all pairs: 1,081 box-box rows and 4,324 point slots. The
    one-env-per-block layout needed 581,632 bytes of shared memory a block
    (the wrapper refused anything above 227 KB); one env of the new layout
    needs under 11 KB, and the plan launches it."""
    tab = tables("bigpile")
    assert (tab.num_rows, tab.num_points, tab.num_bodies) == (1081, 4324, 48)
    assert chip_smoke.one_block_per_env_bytes(tab) == 581632 > 227 * 1024
    block_w, env_w = tab.shared_layout()
    assert 4 * (block_w + env_w) < 11 * 1024
    for batch in (256, 1000, 4096):
        check_plan(tab, batch, tab.launch_plan(batch))


@pytest.mark.parametrize("name", sorted(PLAN_4096))
def test_shared_memory_does_not_grow_with_point_slots(name):
    """An env's shared words: velocities, inverse inertias, joint rows and
    impulses, one joint pass's deltas, inverse degrees and live lists. Per
    pair row that is 7 bytes of lists (u16 row, two u16 entries, a u8 mask)
    and nothing per point slot; the points' 30 fields (120 bytes a slot) and
    the rows' 12 deltas are in the scratch."""
    tab = tables(name)
    nb, P, nph = tab.num_bodies, tab.num_rows, tab.num_phases
    _block_w, env_w = tab.shared_layout()
    jmax = max(max(tab.joint_counts.values()), 1)
    fixed = 4 * (15 * nb + tab.joint_row_floats + tab.joint_acc_floats
                 + 12 * jmax + nph * nb) + 2 * (nph * (nb + 1) + nph + 1)
    assert fixed <= 4 * env_w <= fixed + 7 * P + 11 * 16     # 11 parts
    assert 4 * env_w < fs.POINT_FIELDS * 4 * tab.num_points


@pytest.mark.parametrize("name", sorted(PLAN_4096))
def test_scratch_shapes(name):
    tab = tables(name)
    assert fs.scratch_shapes(tab, 37) == (
        (37, tab.num_points, fs.POINT_FIELDS), (37, tab.num_rows, 12))


def test_launch_plan_raises_when_one_env_does_not_fit():
    tab = fs.FusedTables(chip_smoke.shapes_scene("sphere_bounce", "cpu"),
                         "cpu")
    tab.shared_layout = lambda: (16, fs.BLOCK_SHARED // 4)
    with pytest.raises(NotImplementedError):
        tab.launch_plan(4096)


def _static_lists(tab):
    """phase_rows, and per phase and body the incidence entries (2 r + side)
    of the static tables the kernel reads (FusedTables' itab)."""
    nb, P, nph = tab.num_bodies, tab.num_rows, tab.num_phases
    it = tab.itab.numpy()
    o = tab.ioffs
    phase_rows = it[o[1]:o[1] + nph + 1]
    con_ptr = it[o[2]:o[2] + nph * nb + 1]
    con_idx = it[o[3]:o[3] + 2 * P]
    lists = [[con_idx[con_ptr[ph * nb + n]:con_ptr[ph * nb + n + 1]].tolist()
              for n in range(nb)] for ph in range(nph)]
    return phase_rows, lists


@pytest.mark.parametrize("name", sorted(PLAN_4096))
def test_live_list_order(name):
    """What the team's first warp builds its live lists from: each phase's
    rows are one ascending range, phases in order; each (phase, body)
    incidence list holds the phase's entries of that body in the plain
    version's summation order (a group's a-sides in row order, then its
    b-sides); every entry fits the lists' u16. Filtering these lists by a
    live mask keeps that order, so the live rows come out in row order (the
    sequential walk's order) and the per-body sums in the plain order."""
    tab = fs.FusedTables(SCENES[name](), "cpu")
    phase_rows, lists = _static_lists(tab)
    assert phase_rows[0] == 0 and phase_rows[-1] == tab.num_rows
    assert (np.diff(phase_rows) >= 0).all()
    assert 2 * tab.num_rows <= 0xFFFF
    row0 = 0
    for ph, glist in enumerate(tab.phase_groups):
        want = [[] for _ in range(tab.num_bodies)]
        for g in glist:
            m = tab.metas[g]
            for side, bodies in ((0, m["body_a"]), (1, m["body_b"])):
                for p, b in enumerate(bodies.tolist()):
                    want[b].append(2 * (row0 + p) + side)
            row0 += m["pg"]
        assert row0 == phase_rows[ph + 1]
        assert lists[ph] == want


@pytest.mark.parametrize("name", ["loco", "settle", "bigpile"])
def test_live_sums_equal_full_sums_bit_for_bit(name):
    """The kernel sums, per body and phase, only its live entries' deltas,
    starting at +0.0; the plain version index_adds every row's delta into
    zeros, a dead row's being x - x = +0.0. Under round-to-nearest a sum is
    -0.0 only when both terms are, so the partial sums are never -0.0 and
    adding +0.0 changes no bit: the two agree exactly, also in the inverse
    degree of each body (live entries counted, at least 1). Seeded deltas
    of every sign and magnitude, zeros of both signs among them."""
    tab = fs.FusedTables(SCENES[name](), "cpu")
    nb, P = tab.num_bodies, tab.num_rows
    phase_rows, lists = _static_lists(tab)
    rng = np.random.default_rng(8)
    for trial in range(4):
        live = rng.random(P) < (0.05, 0.3, 0.7, 1.0)[trial]
        raw = rng.standard_normal((P, 2, 6)) * 10.0 ** rng.integers(
            -8, 3, (P, 2, 6))
        raw[rng.random((P, 2, 6)) < 0.1] = -0.0
        raw[rng.random((P, 2, 6)) < 0.1] = 0.0
        x = torch.from_numpy(raw.astype(np.float32))
        delta = torch.where(torch.from_numpy(live)[:, None, None], x, x - x)
        for ph, glist in enumerate(tab.phase_groups):
            full = torch.zeros((nb, 6))
            deg = torch.zeros(nb)
            for g in glist:
                m = tab.metas[g]
                r0 = sum(tab.metas[h]["pg"] for h in range(g))
                rows = torch.arange(r0, r0 + m["pg"])
                lv = torch.from_numpy(live[r0:r0 + m["pg"]]).float()
                for side, key in ((0, "body_a"), (1, "body_b")):
                    idx = torch.from_numpy(m[key])
                    full.index_add_(0, idx, delta[rows, side])
                    deg.index_add_(0, idx, lv)
            part = torch.zeros((nb, 6))
            idg = torch.zeros(nb)
            flat = delta.reshape(2 * P, 6)
            for n in range(nb):
                ent = [e for e in lists[ph][n] if live[e >> 1]]
                s = torch.zeros(6)
                for e in ent:
                    s = s + flat[e]
                part[n] = s
                idg[n] = 1.0 / max(float(len(ent)), 1.0)
            assert torch.equal(part.view(torch.int32),
                               full.view(torch.int32)), (name, trial, ph)
            assert torch.equal(idg, 1.0 / torch.clamp(deg, min=1.0))


def test_make_heightfield_defaults_to_the_card():
    """The port's public entries run on the card unless asked for the CPU:
    make_heightfield's default device is "cuda", as SceneBuilder.finalize's
    is (no card here: the default raises)."""
    h = make_heightfield(np.zeros((3, 3)), 1.0, device="cpu")
    assert h.heights.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        make_heightfield(np.zeros((3, 3)), 1.0)
