"""Port parity, modules ops/kernels/broadphase_kernel.py,
ops/kernels/kselect_broadphase.py, ops/kernels/sap_broadphase.py,
ops/broadphase.py, ops/narrowphase.py, ops/manifold.py and ops/solver.py:
the plain versions of the three broadphase kernels and the table /
K-select compaction equal the JAX package exactly (integer outputs); the
box-box narrowphase and the contact prep + phased solve agree to float
rounding.

The JAX broadphase kernels run in interpret mode on the CPU, as
tests/test_pallas_broadphase.py and tests/test_sap_broadphase.py run them.
Inputs are made with numpy from fixed seeds and handed to both packages."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.ops import broadphase as jbp
from dxk_tpu.ops import narrowphase as jnp_ops
from dxk_tpu.ops import solver as jsolver
from dxk_tpu.ops.integrator import SolverBodies as JaxSolverBodies
from dxk_tpu.ops.pallas.broadphase_kernel import aabb_overlap_matrix_pallas
from dxk_tpu.ops.pallas.kselect_broadphase import (
    kselect_broadphase as jax_kselect)
from dxk_tpu.ops.pallas.sap_broadphase import sap_broadphase as jax_sap
from dxk_tpu.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu.scene import SceneBuilder as JaxSceneBuilder
from dxk_tpu_torch.ops import broadphase as tbp
from dxk_tpu_torch.ops import narrowphase as tnp_ops
from dxk_tpu_torch.ops import solver as tsolver
from dxk_tpu_torch.ops.integrator import SolverBodies
from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
from dxk_tpu_torch.ops.kernels.kselect_broadphase import kselect_broadphase
from dxk_tpu_torch.ops.kernels.sap_broadphase import (sap_broadphase,
                                                      sap_sweep,
                                                      sap_sweep_plain,
                                                      sweep_stops)
from dxk_tpu_torch.scene import SceneBuilder

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

B = 2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_colliders(seed, c=200, tied=False):
    """B envs of random AABBs plus per-collider (body, owner, ctype): a few
    statics, some colliders sharing a body. `tied` puts the x-mins on a
    coarse grid, so many are equal (the sort-and-sweep tie case)."""
    rng = np.random.default_rng(seed)
    mn = rng.uniform(-6, 6, (B, c, 3)).astype(np.float32)
    if tied:
        mn[..., 0] = np.round(mn[..., 0] / 4.0) * 4.0 + 0.5
    mx = (mn + rng.uniform(0.5, 3.0, (B, c, 3))).astype(np.float32)
    owner = np.where(rng.uniform(size=c) < 0.1, 1, 0).astype(np.int32)
    owner[0] = 1
    mn[:, 0] = (-30.0, -1.0, -30.0)       # a broad static ground
    mx[:, 0] = (30.0, 0.5, 30.0)
    body = np.arange(c, dtype=np.int32) // 2       # pairs of colliders share
    body[owner == 1] = c
    ctype = rng.integers(0, 4, c).astype(np.int32)
    return mn, mx, body, owner, ctype


def test_overlap_matrix_plain_equals_jax():
    mn, mx, *_ = _random_colliders(0, 300)
    got = bk.aabb_overlap_matrix(_t(mn), _t(mx)).numpy()
    for e in range(B):
        want = np.asarray(aabb_overlap_matrix_pallas(jnp.asarray(mn[e]),
                                                     jnp.asarray(mx[e])))
        assert got.dtype == np.int8
        assert np.array_equal(got[e], want)


@pytest.mark.parametrize("num_phases,k_sel", [(1, 4), (4, 8)])
def test_kselect_plain_equals_jax(num_phases, k_sel):
    mn, mx, body, owner, ctype = _random_colliders(1)
    idx, cls, cnt = kselect_broadphase(_t(mn), _t(mx), _t(body), _t(owner),
                                       _t(ctype), num_phases, k_sel)
    assert int((cnt > k_sel).sum()) > 0      # some rows overflow K
    for e in range(B):
        w_idx, w_cls, w_cnt = jax_kselect(
            jnp.asarray(mn[e]), jnp.asarray(mx[e]), jnp.asarray(body),
            jnp.asarray(owner), jnp.asarray(ctype), num_phases=num_phases,
            k_sel=k_sel)
        assert np.array_equal(idx[e].numpy(), np.asarray(w_idx))
        assert np.array_equal(cls[e].numpy(), np.asarray(w_cls))
        assert np.array_equal(cnt[e].numpy(), np.asarray(w_cnt))


@pytest.mark.parametrize("num_phases,k_sel,tied,window", [
    (1, 4, False, 2), (4, 8, False, 4), (4, 8, True, 1)])
def test_sap_plain_equals_jax(num_phases, k_sel, tied, window):
    mn, mx, body, owner, ctype = _random_colliders(2, tied=tied)
    broad = (0,)
    idx, cls, hits, wovf = sap_broadphase(
        _t(mn), _t(mx), _t(body), _t(owner), _t(ctype), num_phases, k_sel,
        window, broad)
    for e in range(B):
        want = jax_sap(jnp.asarray(mn[e]), jnp.asarray(mx[e]),
                       jnp.asarray(body), jnp.asarray(owner),
                       jnp.asarray(ctype), num_phases=num_phases,
                       k_sel=k_sel, window=window, broad_idx=broad)
        for g, w in zip((idx[e], cls[e], hits[e], wovf[e]), want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    if tied:
        assert int(wovf.sum()) > 0           # the window-overflow count bites


@pytest.mark.parametrize("case", cs.SWEEP_CASES,
                         ids=lambda c: f"seed{c[0]}-C{c[2]}-window{c[5]}-"
                         + c[6].replace(" ", "-"))
def test_sweep_stops_are_exact(case):
    """sap_kernel ends a row's walk at `sweep_stops`: every column from
    there to the window's end fails the x test, the stop is the first column
    with that property (from the row's next column on), and the plain
    sweep's partners all lie before it; on unsorted input and NaN too."""
    args = cs.sweep_case_inputs(case)
    mn_s, mx_s, window = args[0], args[1], args[7]
    stops = sweep_stops(mn_s, mx_s, window)
    C = mn_s.shape[1]
    ii = torch.arange(C)
    j_end = torch.clamp((ii // 128) * 128 + window * 128, max=C)
    cols = ii[None, None, :]
    in_window = cols < j_end[None, :, None]
    fails_x = mn_s[:, None, :, 0] > mx_s[:, :, None, 0]      # (B, row, col)
    assert bool((fails_x | ~in_window | (cols < stops[..., None])).all())
    later = stops > ii + 1
    can_pass = ~fails_x & in_window & (cols >= stops[..., None] - 1)
    assert bool((can_pass.any(-1) | ~later).all())
    assert int(later.sum()) > 0 and int((stops < j_end).sum()) > 0
    idx, _cls, _cnt, _ovf = sap_sweep_plain(*args)
    assert bool(((idx < 0) | (idx < stops[..., None])).all())


def test_aabb_overlap_mask_and_compact_pairs_equal_jax():
    mn, mx, *_ = _random_colliders(3, 40)
    ii, jj = np.triu_indices(40, k=1)
    all_pairs = np.stack([ii, jj], -1).astype(np.int32)      # dense table
    sparse = all_pairs[::7]                                  # sparse table
    assert tbp.is_dense(len(all_pairs), 40)
    assert not tbp.is_dense(len(sparse), 40)
    for pairs in (all_pairs, sparse):
        mask = tbp.aabb_overlap_mask(_t(mn), _t(mx), _t(pairs))
        for k in (5, len(pairs) + 1):
            sel, smask, dropped = tbp.compact_pairs(_t(pairs), mask, k)
            for e in range(B):
                w_mask = jbp.aabb_overlap_mask(jnp.asarray(mn[e]),
                                               jnp.asarray(mx[e]),
                                               jnp.asarray(pairs))
                assert np.array_equal(mask[e].numpy(), np.asarray(w_mask))
                w = jbp.compact_pairs(jnp.asarray(pairs), w_mask, k)
                assert np.array_equal(sel[e].numpy(), np.asarray(w[0]))
                assert np.array_equal(smask[e].numpy(), np.asarray(w[1]))
                assert int(dropped[e]) == int(w[2])


def _soup(builder_cls, n=40):
    """A mixed sphere / box / capsule soup over a broad ground box."""
    rng = np.random.RandomState(0)
    b = builder_cls()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (30, 1, 30))
    for i in range(n):
        p = (rng.uniform(-3, 3), rng.uniform(0.3, 2.5), rng.uniform(-3, 3))
        body = b.add_body(position=p)
        kind = i % 3
        if kind == 0:
            b.add_sphere_collider(body, (0, 0, 0), 0.4)
        elif kind == 1:
            b.add_box_collider(body, (0, 0, 0), (0.35, 0.35, 0.35))
        else:
            b.add_capsule_collider(body, (0, -0.2, 0), (0, 0.2, 0), 0.25)
    return b


@pytest.mark.parametrize("broadphase", ["kselect", "sap"])
def test_kselect_group_pairs_equal_jax(broadphase):
    kw = dict(max_narrow_pairs_per_group=6, contact_phases=4,
              broadphase=broadphase, broadphase_k=2)
    jscene = _soup(JaxSceneBuilder).finalize(**kw)
    tscene = _soup(SceneBuilder).finalize(device="cpu", **kw)
    st = jscene.initial_state()
    rng = np.random.default_rng(4)
    pos = np.asarray(st.pos)[None] + rng.normal(
        0, 0.05, (B,) + st.pos.shape).astype(np.float32)
    pos[0] = np.asarray(st.pos)            # env 0 at the initial pose
    pos[:, -1] = np.asarray(st.pos)[-1]
    rot = np.broadcast_to(np.asarray(st.rot), (B,) + st.rot.shape)
    mns, mxs = [], []
    for e in range(B):
        w = world_colliders(jscene, jnp.asarray(pos[e]), jnp.asarray(rot[e]))
        mn, mx = collider_aabbs(jscene, w)
        mns.append(np.asarray(mn))
        mxs.append(np.asarray(mx))
    got, n_ov, n_drop = tbp.kselect_group_pairs(tscene, _t(np.stack(mns)),
                                                _t(np.stack(mxs)))
    assert int(n_drop.sum()) > 0 and int(n_ov.sum()) > 0
    want, w_ov, w_drop = jax.jit(jax.vmap(
        lambda mn, mx: jbp.kselect_group_pairs(jscene, mn, mx)))(
        jnp.asarray(np.stack(mns)), jnp.asarray(np.stack(mxs)))
    assert np.array_equal(n_ov.numpy(), np.asarray(w_ov))
    assert np.array_equal(n_drop.numpy(), np.asarray(w_drop))
    assert sorted(got) == sorted(want)
    for gi in want:
        for g, w in zip(got[gi], want[gi]):
            assert np.array_equal(g.numpy(), np.asarray(w)), gi


def _random_box_pairs(seed, n=192):
    """Box pairs: random poses near contact, then flat stacks (the exact
    face-face SAT tie) and slightly tilted stacks."""
    rng = np.random.default_rng(seed)
    ha = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qa, qb = q.astype(np.float32)
    ca = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cb = (ca + rng.normal(0, 0.6, (n, 3))).astype(np.float32)
    m = n // 3
    # stacked flat: equal unit boxes, B on top of A, penetrating slightly
    ha[:m] = hb[:m] = 0.5
    qa[:m] = qb[:m] = (0.0, 0.0, 0.0, 1.0)
    cb[:m] = ca[:m] + np.stack([rng.uniform(-0.2, 0.2, m),
                                1.0 - rng.uniform(0.0, 0.01, m),
                                rng.uniform(-0.2, 0.2, m)], -1)
    # tilted stacks: a small rotation about a random axis
    ang = rng.uniform(-0.05, 0.05, m)
    ax = rng.normal(size=(m, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    qa[m:2 * m] = (0.0, 0.0, 0.0, 1.0)
    qb[m:2 * m] = np.concatenate([ax * np.sin(ang / 2)[:, None],
                                  np.cos(ang / 2)[:, None]], -1)
    cb[m:2 * m] = ca[m:2 * m] + (0.0, 0.995, 0.0)
    ha[m:2 * m] = hb[m:2 * m] = 0.5
    return ca, ha, qa, cb, hb, qb


def test_box_box_contact_matches_jax():
    args = _random_box_pairs(5)
    want = jax.jit(jax.vmap(jnp_ops.box_box_contact))(
        *(jnp.asarray(a) for a in args))
    got = tnp_ops.box_box_contact(*(_t(a).reshape(B, -1, a.shape[-1])
                                    for a in args))
    pts, dps, nrm, cnt, hit = (x.reshape(-1, *x.shape[2:]) for x in got)
    w_pts, w_dps, w_nrm, w_cnt, w_hit = (np.asarray(x) for x in want)
    assert np.array_equal(hit.numpy(), w_hit)
    assert np.array_equal(cnt.numpy(), w_cnt)
    assert w_hit[:64].all() and (w_cnt[:64] == 4).all()   # flat stacks hit
    assert 0 < w_hit.sum() < len(w_hit)
    live = w_hit
    assert np.abs(nrm.numpy()[live] - w_nrm[live]).max() <= 1e-6
    slots = np.arange(4)[None] < w_cnt[:, None]
    assert np.abs(dps.numpy() - w_dps)[slots].max() <= 1e-6
    assert np.abs(pts.numpy() - w_pts)[slots].max() <= 1e-6


def _prep_and_solve(mode):
    """prep_contacts + solve_constraints in `mode` on random bodies and
    contact rows, in both packages. Returns (bodies, JAX prep, solved
    bodies and impulses, port prep, solved bodies and impulses)."""
    rng = np.random.default_rng(6)
    nb, P, iters = 7, 12, 10             # 6 bodies + dummy, 12 pair rows
    q = rng.normal(size=(B, nb, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    A = rng.normal(size=(B, nb, 3, 3))
    inv_inertia = (A @ np.swapaxes(A, -1, -2) * 0.5).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, nb).astype(np.float32)
    inv_mass[-1] = 0.0
    inv_inertia[:, -1] = 0.0
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    bodies = dict(rot=q.astype(np.float32), local_cog=f32(nb, 3) * 0.1,
                  pos_cog=f32(B, nb, 3), inv_inertia=inv_inertia,
                  inv_mass=inv_mass, v=f32(B, nb, 3), w=f32(B, nb, 3))
    bodies["v"][:, -1] = bodies["w"][:, -1] = 0.0
    body_a = rng.integers(0, nb - 1, (B, P)).astype(np.int32)
    body_b = ((body_a + rng.integers(1, nb - 1, (B, P))) % (nb - 1)
              ).astype(np.int32)
    body_b[:, :3] = nb - 1                                 # ground contacts
    nrm = f32(B, P, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.repeat(nrm[:, :, None], 4, axis=2)
    point = (bodies["pos_cog"][np.arange(B)[:, None], body_a][:, :, None]
             + f32(B, P, 4, 3) * 0.3)
    depth = np.abs(f32(B, P, 4)) * 0.02
    mask = (rng.uniform(size=(B, P, 4)) < 0.8).astype(np.float32)
    fric = rng.uniform(0.3, 1.0, (B, P)).astype(np.float32)
    rest = rng.uniform(0.0, 0.3, (B, P)).astype(np.float32)
    sizes = (5, 4, 3)
    dt = np.float32(1.0 / 120.0)

    static = ("local_cog", "inv_mass")

    def jax_env(body_state, body_a, body_b, point, nrm, depth, fric, rest,
                mask):
        jb = JaxSolverBodies(**body_state,
                             **{k: jnp.asarray(bodies[k]) for k in static})
        prep = jsolver.prep_contacts(jb, body_a, body_b, point, nrm, depth,
                                     fric, rest, mask, dt, phase_sizes=sizes)
        out, imp = jsolver.solve_constraints(
            jb, jsolver.Prepped(contacts=prep), iters, mode)
        return prep, out, imp

    prep, out, imp = jax.jit(jax.vmap(jax_env))(
        {k: jnp.asarray(v) for k, v in bodies.items() if k not in static},
        *(jnp.asarray(x) for x in (body_a, body_b, point, nrm, depth, fric,
                                   rest, mask)))

    tb = SolverBodies(**{k: _t(v) for k, v in bodies.items()})
    tprep = tsolver.prep_contacts(
        tb, _t(body_a).long(), _t(body_b).long(), _t(point), _t(nrm),
        _t(depth), _t(fric), _t(rest), _t(mask), float(dt),
        phase_sizes=sizes)
    tout, timp = tsolver.solve_constraints(
        tb, tsolver.Prepped(contacts=tprep), iters, mode)
    return bodies, prep, out, imp, tprep, tout, timp


def test_prep_and_solve_match_jax():
    """prep_contacts + solve_constraints (phased jacobi) on random bodies
    and contact rows: prep within 1e-6, solved velocities within 1e-5."""
    bodies, prep, out, imp, tprep, tout, timp = _prep_and_solve("jacobi")
    for name in ("rel_a", "rel_b", "tangent", "eff_mass_n", "eff_mass_t",
                 "bias", "friction", "n_to_wa", "n_to_wb", "t_to_wa",
                 "t_to_wb", "inv_ma", "inv_mb"):
        w = np.asarray(getattr(prep, name))
        g = getattr(tprep, name).numpy()
        assert np.abs(g - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), name
    assert np.abs(tout.v.numpy() - np.asarray(out.v)).max() <= 1e-5
    assert np.abs(tout.w.numpy() - np.asarray(out.w)).max() <= 1e-5
    assert np.abs(timp.numpy() - np.asarray(imp)).max() <= 1e-5
    # the solve did change velocities
    assert np.abs(np.asarray(out.v) - bodies["v"]).max() > 1e-2


def test_scan_mode_raises():
    """The sequential "scan" contact pass is ported: on the random rows of
    test_prep_and_solve_match_jax it runs and its solved velocities and
    impulses are within 1e-5 of the JAX package's."""
    bodies, _prep, out, imp, _tprep, tout, timp = _prep_and_solve("scan")
    assert np.abs(tout.v.numpy() - np.asarray(out.v)).max() <= 1e-5
    assert np.abs(tout.w.numpy() - np.asarray(out.w)).max() <= 1e-5
    assert np.abs(timp.numpy() - np.asarray(imp)).max() <= 1e-5
    assert np.abs(np.asarray(out.v) - bodies["v"]).max() > 1e-2


@pytest.mark.parametrize("fn", [
    lambda x: bk.aabb_overlap_matrix(x, x),
    lambda x: kselect_broadphase(x, x, *(torch.zeros(4, dtype=torch.int32,
                                                     device="meta"),) * 3),
    lambda x: sap_sweep(x, x, *(torch.zeros((1, 4), dtype=torch.int32,
                                            device="meta"),) * 3, 1, 8, 4),
])
def test_non_cpu_tensor_never_takes_plain_version(fn):
    """A tensor that is not on the CPU goes to the kernel's checks, never
    to the plain version (here: a meta tensor is refused)."""
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 4, 3), device="meta"))
