"""Step a golden scene in solver_mode="fused_seq" with the port's plain
version and, side by side from the same state, with the JAX package's own
fused_seq step, on the CPU, and hold both against the golden trajectory.

The port runs `--start` steps from the golden start first (plain version,
30 iterations); then the JAX package's step (op by op under
jax.disable_jit(), unbatched) and the port's step each take `--steps`
steps from that state. One JSON line per step: the largest differences
between the two (positions, rotations, velocities), their live contact
rows, and at every 25th step each one's deviation from
tests/golden/<scene>.npy (and with --scan the JAX package's scan path's,
compiled, from the golden start). With --jax-steps 0 only the port runs,
and the lines give its deviation from the golden per checkpoint.

    python3 tools/fused_seq_vs_jax_cpu.py --scene box_stack --steps 50 --scan
    python3 tools/fused_seq_vs_jax_cpu.py --scene mixed_shape_drop \\
        --start 300 --steps 12
    python3 tools/fused_seq_vs_jax_cpu.py --scene double_pendulum \\
        --steps 1000 --jax-steps 0

A JAX fused_seq step of these scenes takes 20-60 s on the CPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the first torch.sqrt of a process that also runs JAX can come back at
# reduced precision on the CPU build of PyTorch; it is spent here
torch.sqrt(torch.ones(4096))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll  # noqa: E402
from dxk_tpu.physics import PhysicsSettings as JaxSettings  # noqa: E402
from dxk_tpu.physics import physics_step as jax_step  # noqa: E402
from dxk_tpu.scene import SceneBuilder as JaxBuilder  # noqa: E402
from dxk_tpu_torch.physics import PhysicsSettings, physics_step  # noqa: E402

FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")


def golden_dev(golden, t, pos, rot):
    """Max |deviation| from the golden checkpoint after step t (1-based)."""
    row = np.concatenate([np.asarray(pos, np.float64).ravel(),
                          np.asarray(rot, np.float64).ravel()])
    return float(np.abs(row - golden[t // cs.FIDELITY_EVERY - 1]).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=cs.GOLDEN_SCENES, required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--jax-steps", type=int, default=None,
                    help="steps of the JAX package's fused_seq (default: "
                         "--steps; 0 runs the port alone)")
    ap.add_argument("--scan", action="store_true",
                    help="also step the JAX package's scan path from the "
                         "golden start")
    args = ap.parse_args()
    jax_steps = args.steps if args.jax_steps is None else args.jax_steps
    dt = cs.FIDELITY_DT
    tscene = cs.shapes_scene(args.scene, "cpu")
    jscene = cs.golden_builder(JaxBuilder, args.scene,
                               jax_add_ragdoll).finalize()
    golden = np.load(cs.golden_path(args.scene))
    seq = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                          solver_mode="fused_seq")
    jseq = JaxSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                       solver_mode="fused_seq")
    tst = tscene.initial_state(1)
    for _ in range(args.start):
        tst = physics_step(tscene, tst, seq, dt)[0]
    jst = jscene.initial_state().replace(**{
        k: jnp.asarray(getattr(tst, k)[0].numpy()) for k in FIELDS})
    scan = scan_st = None
    if args.scan:
        jscan = JaxSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                            solver_mode="scan")
        scan = jax.jit(lambda s: jax_step(jscene, s, jscan, dt)[0])
        scan_st = jscene.initial_state()
        for _ in range(args.start):
            scan_st = scan(scan_st)
    t0 = time.time()
    for i in range(args.steps):
        t = args.start + i + 1
        tst, tinfo = physics_step(tscene, tst, seq, dt)
        out = dict(step=t, port_live_rows=int(tinfo.contact_mask.sum()))
        if i < jax_steps:
            with jax.disable_jit():
                jst, jinfo = jax_step(jscene, jst, jseq, dt)
            out["jax_live_rows"] = int(np.asarray(jinfo.contact_mask).sum())
            for k in ("pos", "rot", "lin_vel", "ang_vel"):
                out[f"jax_vs_port_{k}"] = float(np.abs(
                    np.asarray(getattr(jst, k))
                    - getattr(tst, k)[0].numpy()).max())
        if scan is not None:
            scan_st = scan(scan_st)
            for k in ("pos", "rot"):
                out[f"scan_vs_port_{k}"] = float(np.abs(
                    np.asarray(getattr(scan_st, k))
                    - getattr(tst, k)[0].numpy()).max())
        if t % cs.FIDELITY_EVERY == 0 and t // cs.FIDELITY_EVERY <= len(
                golden):
            out["port_vs_golden"] = golden_dev(golden, t, tst.pos[0],
                                               tst.rot[0])
            if i < jax_steps:
                out["jax_vs_golden"] = golden_dev(golden, t, jst.pos,
                                                  jst.rot)
            if scan is not None:
                out["scan_vs_golden"] = golden_dev(golden, t, scan_st.pos,
                                                   scan_st.rot)
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
