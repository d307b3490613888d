"""Where a golden trajectory and the port's "scan" part, on the CPU.

The goldens (tests/golden/<name>.npy, every 25th step's positions and
rotations) were recorded by the JAX package's "scan" compiled with the
scene closed over, so XLA folds the scene's values into constants. This
script steps one env of a golden scene for --steps steps in four ways and
keeps every step's positions and rotations:

  jax_closed    the JAX step compiled as the golden recorder compiles it
  jax_traced    the JAX step compiled with the scene as an argument, so
                none of its values is folded into a constant
  port          the port's "scan" as it is
  port_product  the port's "scan" with the velocity damping taken as a
                product with the reciprocal 1 / (1 + dt * damping), the
                form a compiler may fold a division by a constant into

With --eager-from S the port steps S steps from the golden start, then
the JAX package's "scan" op by op (jax.disable_jit(): nothing folded or
fused) and the port each take --eager-steps more steps from the port's
state, and one JSON line per step gives how far apart they are and each
one's deviation at a golden checkpoint. An op-by-op step takes about a
minute (box_stack) to three (the mixed drop). With --stages it first
prints, for step S + 1, each stage's largest difference (world
colliders, each pair group's contacts, the integrated bodies, the contact
prep, the solve, the integrated state), per output field.

--dots prints how XLA's CPU dot rounds a batch of seeded 3x3 products
against the port's form (each product rounded, then summed) and against
a chain of fused multiply-adds.

Otherwise it prints one JSON line per pair of runs: the first step at
which the two differ at all and by how much, the first step past each of
1e-6 ... 1e-3,
the difference at a few steps and the largest difference within the
first 25, 50, 250 and 1000 steps; then one line per run with its largest
deviation from the golden over the first 25, 50, 250 and 1000 steps, and
the first checkpoint (every 25th step) at which it leaves the golden at
all and past each threshold.

    JAX_PLATFORMS=cpu python3 tools/golden_divergence_cpu.py box_stack [--steps 1000]
    JAX_PLATFORMS=cpu python3 tools/golden_divergence_cpu.py mixed_shape_drop --port-only
    JAX_PLATFORMS=cpu python3 tools/golden_divergence_cpu.py mixed_shape_drop --eager-from 50 --eager-steps 25
    JAX_PLATFORMS=cpu python3 tools/golden_divergence_cpu.py box_stack --eager-from 17 --eager-steps 0 --stages
    JAX_PLATFORMS=cpu python3 tools/golden_divergence_cpu.py --dots
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DT = 1.0 / 120.0
EVERY = 25
THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3)
AT_STEPS = (1, 10, 25, 50, 100, 250, 500, 1000)
WINDOWS = (25, 50, 250, 1000)


def jax_runs(name, steps):
    import jax
    from dxk_tpu.models.ragdoll import add_ragdoll
    from dxk_tpu.physics import PhysicsSettings, physics_step
    from dxk_tpu.scene import SceneBuilder

    import chip_smoke
    scene = chip_smoke.golden_builder(SceneBuilder, name,
                                      add_ragdoll).finalize()
    settings = PhysicsSettings(solver_mode="scan")
    closed = jax.jit(lambda s: physics_step(scene, s, settings, DT)[0])
    traced = jax.jit(lambda sc, s: physics_step(sc, s, settings, DT)[0])
    out = {}
    for label, step in (("jax_closed", closed),
                        ("jax_traced", lambda s: traced(scene, s))):
        t0 = time.time()
        st = scene.initial_state()
        rows = []
        for _ in range(steps):
            st = step(st)
            rows.append(np.concatenate([np.asarray(st.pos).ravel(),
                                        np.asarray(st.rot).ravel()]))
        out[label] = np.stack(rows)
        print(json.dumps({"run": label, "seconds": time.time() - t0}),
              flush=True)
    return out


def port_runs(name, steps):
    import torch

    import chip_smoke
    from dxk_tpu_torch import physics
    from dxk_tpu_torch.ops import integrator

    torch.sqrt(torch.ones(4096))   # see tests/test_torch_*.py
    scene = chip_smoke.shapes_scene(name, "cpu")
    settings = physics.PhysicsSettings(solver_mode="scan")
    bp = scene.body_params
    undamped = scene.replace(body_params=bp.replace(
        linear_damping=torch.zeros_like(bp.linear_damping),
        angular_damping=torch.zeros_like(bp.angular_damping)))

    def product_form(_scene, state, dt):
        # damping 0 divides by 1.0, which is exact; then the product
        b = integrator.integrate_forces(undamped, state, dt)
        lin = 1.0 / (1.0 + dt * bp.linear_damping[:, None])
        ang = 1.0 / (1.0 + dt * bp.angular_damping[:, None])
        return b.replace(v=b.v * lin, w=b.w * ang)

    out = {}
    for label, integrate in (("port", integrator.integrate_forces),
                             ("port_product", product_form)):
        physics.integrate_forces = integrate
        t0 = time.time()
        st = scene.initial_state(1)
        rows = []
        for _ in range(steps):
            st, _info = physics.physics_step(scene, st, settings, DT)
            rows.append(np.concatenate([st.pos[0].numpy().ravel(),
                                        st.rot[0].numpy().ravel()]))
        out[label] = np.stack(rows)
        print(json.dumps({"run": label, "seconds": time.time() - t0}),
              flush=True)
    physics.integrate_forces = integrator.integrate_forces
    return out


STATE_FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                "torque_acc")


STAGES = ("world_colliders", "_contacts_for_group", "integrate_forces",
          "prep_contacts", "solve_constraints", "integrate_velocities")


def _leaves(x):
    """(field path, numpy array) of every array in an output, batch
    axis of one dropped on the port's side."""
    import torch
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        a = x.detach().numpy()
        return [("", a[0] if a.ndim and a.shape[0] == 1 else a)]
    if isinstance(x, (tuple, list)):
        return [(f"{i}{'.' + k if k else ''}", a)
                for i, y in enumerate(x) for k, a in _leaves(y)]
    if hasattr(x, "__dataclass_fields__"):
        return [(f"{f}{'.' + k if k else ''}", a)
                for f in x.__dataclass_fields__
                for k, a in _leaves(getattr(x, f))]
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return [("", np.asarray(x))]
    return []


def _recording(stages, modules, calls):
    """Wrap each stage function in `modules` ({name: module}) so that its
    outputs are appended to `calls`; returns the originals."""
    saved = []
    for name in stages:
        mod = modules[name]
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            calls.append((_name, _leaves(out)))
            return out
        setattr(mod, name, wrapped)
        saved.append((mod, name, orig))
    return saved


def stage_diffs(jstep, tstep, jmods, tmods):
    """Run one step on each side with every stage recorded and print, per
    stage call, the fields that differ and by how much."""
    jcalls, tcalls = [], []
    saved = (_recording(STAGES, jmods, jcalls)
             + _recording(STAGES, tmods, tcalls))
    try:
        jstep()
        tstep()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    for (name, jl), (_name, tl) in zip(jcalls, tcalls):
        diffs = {}
        for (key, a), (_key, b) in zip(jl, tl):
            if a.shape != b.shape:
                diffs[key] = f"shape {a.shape} vs {b.shape}"
            elif a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                if (a != b).any():
                    diffs[key] = int((a != b).sum())
            elif a.size:
                d = float(np.abs(a.astype(np.float64) - b).max())
                if d:
                    diffs[key] = d
        print(json.dumps({"stage": name, "differing_fields": diffs}),
              flush=True)


def dot_rounding():
    """XLA's CPU 3x3 product against each product rounded then summed
    (the port's form) and against a fused multiply-add chain (products
    and sums in float64, rounded once each step)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a = np.float32(rng.normal(size=(20000, 3, 3)))
    b = np.float32(rng.normal(size=(20000, 3, 3)))
    xla = np.asarray(jax.jit(jax.vmap(lambda x, y: x.T @ y))(
        jnp.asarray(a), jnp.asarray(b)))
    p = a[..., :, :, None] * b[..., :, None, :]           # (n, k, i, j)
    summed = (p[:, 0] + p[:, 1]) + p[:, 2]
    d = np.float64
    chain = np.float32(d(a[:, 0, :, None]) * d(b[:, 0, None, :]))
    for k in (1, 2):
        chain = np.float32(d(a[:, k, :, None]) * d(b[:, k, None, :])
                           + d(chain))
    print(json.dumps({"entries": int(xla.size),
                      "differ_from_products_summed":
                          int((summed != xla).sum()),
                      "differ_from_fma_chain": int((chain != xla).sum())}))


def eager_from(name, start, steps, gold, stages=False):
    """The port to step `start`, then JAX op by op and the port side by
    side from the port's state; one JSON line a step (with `stages`,
    first the stage differences of step start + 1)."""
    import jax
    import jax.numpy as jnp
    import torch
    from dxk_tpu.models.ragdoll import add_ragdoll
    from dxk_tpu.physics import PhysicsSettings as JaxSettings
    from dxk_tpu.physics import physics_step as jax_step
    from dxk_tpu.scene import SceneBuilder

    import chip_smoke
    from dxk_tpu_torch import physics

    torch.sqrt(torch.ones(4096))   # see tests/test_torch_*.py
    tscene = chip_smoke.shapes_scene(name, "cpu")
    jscene = chip_smoke.golden_builder(SceneBuilder, name,
                                       add_ragdoll).finalize()
    tset = physics.PhysicsSettings(solver_mode="scan")
    jset = JaxSettings(solver_mode="scan")
    tst = tscene.initial_state(1)
    for _ in range(start):
        tst, _info = physics.physics_step(tscene, tst, tset, DT)
    jst = jscene.initial_state().replace(**{
        k: jnp.asarray(getattr(tst, k)[0].numpy()) for k in STATE_FIELDS})
    if stages:
        import dxk_tpu.physics as jphysics
        from dxk_tpu_torch.ops import solver as tsolver

        def jax_once():
            with jax.disable_jit():
                jax_step(jscene, jst, jset, DT)
        stage_diffs(jax_once,
                    lambda: physics.physics_step(tscene, tst, tset, DT),
                    {n: jphysics for n in STAGES},
                    {n: tsolver if n in ("prep_contacts",
                                         "solve_constraints") else physics
                     for n in STAGES})
    for i in range(start + 1, start + steps + 1):
        t0 = time.time()
        with jax.disable_jit():
            jst = jax_step(jscene, jst, jset, DT)[0]
        secs = time.time() - t0
        tst, _info = physics.physics_step(tscene, tst, tset, DT)
        line = {"step": i, "jax_seconds": secs}
        for k in STATE_FIELDS[:4]:
            line[k] = float(np.abs(np.asarray(getattr(jst, k))
                                   - getattr(tst, k)[0].numpy()).max())
        if i % EVERY == 0:
            g = gold[i // EVERY - 1]
            for label, pos, rot in (
                    ("jax", np.asarray(jst.pos), np.asarray(jst.rot)),
                    ("port", tst.pos[0].numpy(), tst.rot[0].numpy())):
                row = np.concatenate([pos.ravel(), rot.ravel()])
                line[f"{label}_golden_deviation"] = float(
                    np.abs(row - g).max())
        print(json.dumps(line), flush=True)


def compare(a, b):
    diff = np.abs(a - b).max(axis=1)
    nz = np.flatnonzero(diff > 0.0)
    out = {"first_step_differing": int(nz[0]) + 1 if nz.size else None,
           "diff_there": float(diff[nz[0]]) if nz.size else 0.0}
    for t in THRESHOLDS:
        past = np.flatnonzero(diff > t)
        out[f"first_step_past_{t:g}"] = int(past[0]) + 1 if past.size else None
    out["diff_at"] = {s: float(diff[s - 1]) for s in AT_STEPS
                      if s <= len(diff)}
    out["max_within"] = {s: float(diff[:s].max()) for s in WINDOWS
                         if s <= len(diff)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", default="box_stack")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--port-only", action="store_true",
                    help="only the two port runs (a compiled JAX step of "
                         "the mixed drop takes tens of GiB to build)")
    ap.add_argument("--eager-from", type=int, default=None,
                    help="step JAX op by op beside the port from the "
                         "port's state at this step")
    ap.add_argument("--eager-steps", type=int, default=25)
    ap.add_argument("--stages", action="store_true",
                    help="with --eager-from: the stage differences of the "
                         "first step")
    ap.add_argument("--dots", action="store_true",
                    help="only the rounding of XLA's 3x3 products")
    args = ap.parse_args()
    if args.dots:
        dot_rounding()
        return
    gold = np.load(os.path.join(ROOT, "tests", "golden", f"{args.name}.npy"))
    if args.eager_from is not None:
        eager_from(args.name, args.eager_from, args.eager_steps, gold,
                   args.stages)
        return

    runs = {} if args.port_only else jax_runs(args.name, args.steps)
    runs.update(port_runs(args.name, args.steps))
    labels = list(runs)
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            print(json.dumps({"pair": [a, b], **compare(runs[a], runs[b])}),
                  flush=True)
    for label, traj in runs.items():
        marks = traj[EVERY - 1::EVERY]
        dev = np.abs(marks - gold[:len(marks)]).max(axis=1)
        first = {}
        for t in (0.0,) + THRESHOLDS:
            past = np.flatnonzero(dev > t)
            first[f"{t:g}"] = ((int(past[0]) + 1) * EVERY, float(dev[past[0]])
                               ) if past.size else None
        print(json.dumps({"run": label, "golden_deviation_within": {
            s: float(dev[:s // EVERY].max()) for s in WINDOWS
            if s <= args.steps},
            "first_checkpoint_past": first}), flush=True)


if __name__ == "__main__":
    main()
