"""Port parity, module ops/solver.py (the solves of the reference step):
the six joint solves `_distance/_ball/_fixed/_hinge/_cone_twist/
_slider_solve_one`, one iteration of each pass (`_gs_pass`,
`_contact_gs_pass`, `_jacobi_pass`, `_colored_pass`) and three iterations
of `solve_constraints` in "scan", "jacobi" and "colored", against the JAX
package.

Inputs: the preps of tests/test_torch_fused_seq.py's moved states (every
dynamic body turned, moved and thrown, the zoo chain's limits past their
bounds, seeded motors on in about two of three joints) of the golden
constraint zoo (one joint of each type) and of the loco ragdoll (six
hinges and seven cone-twists in five colours), seeded accumulators, and
for contacts seeded pair rows (random bodies, the dummy included, points,
normals, depths and point masks) in two contact phases. The JAX preps run
vmapped and compiled; its solves and passes run unbatched, env by env,
under jax.disable_jit(). Velocities within 1e-5 x max(1, |v|) of the JAX
package's, accumulators within 1e-5 (the two packages sum a few products
in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.ops import solver as jsolver
from dxk_tpu.ops.integrator import integrate_forces as jax_integrate_forces
from dxk_tpu_torch.ops import solver as tsolver
from dxk_tpu_torch.ops.integrator import integrate_forces
from dxk_tpu_torch.utils.convert import state_from_numpy
from test_torch_fused_seq import _jax_state, moved_state, scenes

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

B = 2
DT = 1.0 / 120.0
TOL = 1e-5
N_ACC = {"distance": 0, "ball": 0, "fixed": 0, "hinge": 2, "cone_twist": 4,
         "slider": 2}
ZOO_TYPES = tuple(N_ACC)
CASES = [("constraint_zoo", t) for t in ZOO_TYPES] + [
    ("loco", "hinge"), ("loco", "cone_twist")]
P_ROWS = 10              # seeded contact rows, phases of 6 and 4


@functools.lru_cache(maxsize=None)
def setup(name):
    """Port and JAX bodies and preps of one moved state: (port bodies,
    port preps {type: prep}, [JAX bodies per env], {type: [JAX prep per
    env]}, numpy fields)."""
    jscene, tscene = scenes(name)
    fields = moved_state(name, B, 11)
    dt32 = np.float32(DT)
    tst = state_from_numpy(fields, device="cpu")
    tb = integrate_forces(tscene, tst, float(dt32))
    tpreps = {}
    for t in ZOO_TYPES:
        if getattr(tscene, t) is None:
            continue
        j = getattr(tscene, t)
        fn = tsolver._PREPS[t]
        tpreps[t] = (fn(tb, j, dt32) if N_ACC[t] == 0
                     else fn(tb, j, tst.controls, dt32))
    jdt = jnp.float32(DT)
    jst = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_jax_state(jscene, fields, e)
                                     for e in range(B)])
    jb = jax.jit(jax.vmap(lambda s: jax_integrate_forces(jscene, s, jdt)))(
        jst)
    jpreps = {}
    for t in tpreps:
        joints = getattr(jscene, t)
        fn = getattr(jsolver, f"prep_{t}")
        if N_ACC[t] == 0:
            p = jax.jit(jax.vmap(lambda b: fn(b, joints, jdt)))(jb)
        else:
            p = jax.jit(jax.vmap(lambda b, c: fn(b, joints, c, jdt)))(
                jb, jst.controls)
        jpreps[t] = [jax.tree_util.tree_map(lambda x: x[e], p)
                     for e in range(B)]
    jbodies = [jax.tree_util.tree_map(lambda x: x[e], jb) for e in range(B)]
    return tb, tpreps, jbodies, jpreps, fields


def _accs(n_acc, J, seed):
    """Seeded accumulators: limit-like ones >= 0, motor-like signed."""
    rng = np.random.default_rng(seed)
    return tuple(np.float32(rng.uniform(0.0 if k % 2 == 0 else -0.5, 0.5,
                                        (B, J))) for k in range(n_acc))


def _close(got, want, rel=True):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0))) if rel else 1.0
    return float(np.abs(got - want).max(initial=0.0)) <= TOL * scale


@pytest.mark.parametrize("name,jtype", CASES,
                         ids=[f"{n}-{t}" for n, t in CASES])
def test_solve_one_matches_jax(name, jtype):
    """One joint type's `_*_solve_one` on the whole type at once, from the
    integrated velocities and seeded accumulators."""
    tb, tpreps, jbodies, jpreps, _ = setup(name)
    prep = tpreps[jtype]
    a, b = prep.body_a, prep.body_b
    accs = _accs(N_ACC[jtype], a.shape[0], 5)
    tfn = getattr(tsolver, f"_{jtype}_solve_one")
    jfn = getattr(jsolver, f"_{jtype}_solve_one")
    inertia = jtype != "distance"
    targs = [prep, tb.inv_mass[a], tb.inv_mass[b]]
    if inertia:
        targs += [tb.inv_inertia[:, a], tb.inv_inertia[:, b]]
    tout = tfn(*targs, tb.v[:, a], tb.w[:, a], tb.v[:, b], tb.w[:, b],
               *(torch.from_numpy(x) for x in accs))
    an, bn = a.numpy(), b.numpy()
    for e in range(B):
        jb, jp = jbodies[e], jpreps[jtype][e]
        jargs = [jp, jb.inv_mass[an], jb.inv_mass[bn]]
        if inertia:
            jargs += [jb.inv_inertia[an], jb.inv_inertia[bn]]
        with jax.disable_jit():
            jout = jfn(*jargs, jb.v[an], jb.w[an], jb.v[bn], jb.w[bn],
                       *(jnp.asarray(x[e]) for x in accs))
        for k, (g, w) in enumerate(zip(tout, jout)):
            assert _close(g[e].numpy(), w, rel=k < 4), (e, k)


def _jax_contact_prep(jb, rows, e):
    return jsolver.prep_contacts(
        jb, *(jnp.asarray(rows[k][e]) for k in (
            "body_a", "body_b", "point", "normal", "depth", "friction",
            "restitution", "mask")), jnp.float32(DT),
        phase_sizes=(6, P_ROWS - 6))


@functools.lru_cache(maxsize=None)
def contact_rows(name):
    """Seeded contact rows on the scene's bodies: numpy fields (B, P, ...)
    and the port's prep."""
    tb, _tp, _jb, _jp, _f = setup(name)
    n1 = tb.v.shape[1]
    rng = np.random.default_rng(3)
    nrm = rng.normal(size=(B, P_ROWS, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.uniform(size=(B, P_ROWS, 4)) < 0.7
    ba = rng.integers(0, n1, (B, P_ROWS))
    bb = rng.integers(0, n1, (B, P_ROWS))
    live = mask.any(-1)
    rows = dict(
        body_a=np.where(live, ba, n1 - 1).astype(np.int32),
        body_b=np.where(live, bb, n1 - 1).astype(np.int32),
        point=np.float32(rng.uniform(-1, 1, (B, P_ROWS, 4, 3))
                         + tb.pos_cog.numpy()[0, :1, None]),
        normal=np.float32(np.repeat(nrm[:, :, None], 4, axis=2)),
        depth=np.float32(rng.uniform(-0.01, 0.05, (B, P_ROWS, 4))),
        friction=np.float32(rng.uniform(0.2, 1.0, (B, P_ROWS))),
        restitution=np.float32(rng.uniform(0.0, 0.4, (B, P_ROWS))),
        mask=np.float32(mask))
    T = torch.from_numpy
    prep = tsolver.prep_contacts(
        tb, T(rows["body_a"]).long(), T(rows["body_b"]).long(),
        T(rows["point"]), T(rows["normal"]), T(rows["depth"]),
        T(rows["friction"]), T(rows["restitution"]), T(rows["mask"]),
        np.float32(DT), phase_sizes=(6, P_ROWS - 6))
    return rows, prep


PASSES = [("constraint_zoo", t) for t in ZOO_TYPES] + [
    ("loco", "hinge"), ("loco", "cone_twist")]


@pytest.mark.parametrize("kind", ["gs", "jacobi", "colored"])
@pytest.mark.parametrize("name,jtype", PASSES,
                         ids=[f"{n}-{t}" for n, t in PASSES])
def test_joint_pass_matches_jax(name, jtype, kind):
    """One iteration of `_gs_pass`, `_jacobi_pass` or `_colored_pass` over
    one joint type."""
    tb, tpreps, jbodies, jpreps, _ = setup(name)
    prep = tpreps[jtype]
    J = prep.body_a.shape[0]
    accs = _accs(N_ACC[jtype], J, 6)
    tfn = getattr(tsolver, f"_{jtype}_solve_one")
    jfn = getattr(jsolver, f"_{jtype}_solve_one")
    targs = (tb.v, tb.w, tb.inv_mass, tb.inv_inertia,
             tuple(torch.from_numpy(x) for x in accs))
    if kind == "gs":
        tout = tsolver._gs_pass(prep, tfn, N_ACC[jtype], *targs)
    elif kind == "jacobi":
        tout = tsolver._jacobi_pass(prep, tfn, *targs)
    else:
        tout = tsolver._colored_pass(prep, tfn, *targs)
    for e in range(B):
        jb, jp = jbodies[e], jpreps[jtype][e]
        jargs = (jb.v, jb.w, jb.inv_mass, jb.inv_inertia,
                 tuple(jnp.asarray(x[e]) for x in accs))
        with jax.disable_jit():
            if kind == "gs":
                jout = jsolver._gs_pass(jp, jfn, N_ACC[jtype], *jargs)
            elif kind == "jacobi":
                jout = jsolver._jacobi_pass(jp, jfn, *jargs)
            else:
                jout = jsolver._colored_pass(jp, jfn, *jargs)
        assert _close(tout[0][e].numpy(), jout[0])
        assert _close(tout[1][e].numpy(), jout[1])
        for g, w in zip(tout[2], jout[2]):
            assert _close(g[e].numpy(), w, rel=False)
    if kind != "jacobi":     # the pass changed velocities
        assert float((tout[1] - tb.w).abs().max()) > 1e-4


def test_loco_colours():
    """The loco ragdoll's joint preps carry the JAX package's colours (the
    six hinges share no body: one colour; the cone-twists five)."""
    _tb, tpreps, _jb, jpreps, _ = setup("loco")
    for t in ("hinge", "cone_twist"):
        assert tpreps[t].num_colors == jpreps[t][0].num_colors
        assert np.array_equal(tpreps[t].color.numpy(),
                              np.asarray(jpreps[t][0].color))
    assert tpreps["cone_twist"].num_colors == 5


def test_contact_gs_pass_matches_jax():
    """One sequential pass over the seeded contact rows (dead rows on the
    dummy body, rows sharing bodies), from seeded accumulators."""
    tb, _tp, jbodies, _jp, _ = setup("constraint_zoo")
    rows, prep = contact_rows("constraint_zoo")
    rng = np.random.default_rng(4)
    imp = [np.float32(rng.uniform(0.0, 0.3, (B, P_ROWS, 4)))
           for _ in range(2)]
    tv, tw, (tn, tt) = tsolver._contact_gs_pass(
        prep, tb.v, tb.w, tuple(torch.from_numpy(x) for x in imp))
    for e in range(B):
        jb = jbodies[e]
        with jax.disable_jit():
            jprep = _jax_contact_prep(jb, rows, e)
            jv, jw, (jn, jt) = jsolver._contact_gs_pass(
                jprep, jb.v, jb.w, tuple(jnp.asarray(x[e]) for x in imp))
        assert _close(tv[e].numpy(), jv)
        assert _close(tw[e].numpy(), jw)
        assert _close(tn[e].numpy(), jn, rel=False)
        assert _close(tt[e].numpy(), jt, rel=False)
    assert float(tn.max()) > 0.3            # impulses grew past the seeds


def test_contact_gs_pass_skips_only_inert_points():
    """The sequential pass skips a point only where it cannot change
    anything: from zero accumulators (as solve_constraints starts, whose
    "scan" case below matches JAX) exactly the points without an effective
    mass in any env; from the seeded accumulators of
    test_contact_gs_pass_matches_jax some of those are out of their clamp,
    and are solved."""
    _tb, _tp, _jb, _jp, _ = setup("constraint_zoo")
    _rows, prep = contact_rows("constraint_zoo")
    massless = ~torch.any((prep.eff_mass_n != 0.0)
                          | (prep.eff_mass_t != 0.0), dim=0).numpy()
    zero = tuple(torch.zeros(B, P_ROWS, 4) for _ in range(2))
    assert massless.any()
    assert np.array_equal(tsolver.live_points(prep, zero), ~massless)
    rng = np.random.default_rng(4)
    seeded = tuple(torch.from_numpy(np.float32(
        rng.uniform(0.0, 0.3, (B, P_ROWS, 4)))) for _ in range(2))
    assert (tsolver.live_points(prep, seeded) & massless).any()


@pytest.mark.parametrize("mode", ["scan", "jacobi", "colored"])
@pytest.mark.parametrize("name", ["constraint_zoo", "loco"])
def test_solve_constraints_matches_jax(name, mode):
    """Three iterations over every joint type of the scene and the seeded
    contact rows (two phases)."""
    tb, tpreps, jbodies, jpreps, _ = setup(name)
    rows, cprep = contact_rows(name)
    tout, timp = tsolver.solve_constraints(
        tb, tsolver.Prepped(contacts=cprep, **tpreps), 3, mode)
    for e in range(B):
        jb = jbodies[e]
        if e > 0 and mode == "scan":
            break            # one env of the sequential JAX solve (~8 s)
        with jax.disable_jit():
            jprepped = jsolver.Prepped(
                contacts=_jax_contact_prep(jb, rows, e),
                **{t: p[e] for t, p in jpreps.items()})
            jout, jimp = jsolver.solve_constraints(jb, jprepped, 3, mode)
        assert _close(tout.v[e].numpy(), jout.v)
        assert _close(tout.w[e].numpy(), jout.w)
        assert _close(timp[e].numpy(), jimp, rel=False)
    assert torch.isfinite(tout.w).all()
