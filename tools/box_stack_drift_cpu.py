"""Sideways drift of box towers on the reference step, JAX package against
the PyTorch port, on the CPU.

Builds towers of 16 unit boxes with the box-stack options of bench.py
(capped pair groups in 4 contact phases, `jacobi`, 30 iterations,
dt 1/120) and steps the same start in the JAX package (kselect and table
broadphases) and in the port (kselect). Every 20 steps it prints one JSON
line: the largest sideways (x/z) box displacement in each, the largest
position difference port vs JAX, and JAX table vs JAX kselect.

    JAX_PLATFORMS=cpu python3 tools/box_stack_drift_cpu.py [--towers 4] [--steps 120]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def towers(builder, n, per_tower=16):
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (200, 1, 200))
    side = int(np.ceil(np.sqrt(n)))
    for t in range(n):
        x, z = (t % side) * 3.0, (t // side) * 3.0
        for i in range(per_tower):
            body = b.add_body(position=(x, 0.5 + 1.001 * i, z))
            b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--towers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    import jax
    import torch
    from dxk_tpu.physics import PhysicsSettings as JaxSettings
    from dxk_tpu.physics import physics_step as jax_step
    from dxk_tpu.scene import SceneBuilder as JaxBuilder
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene import SceneBuilder

    torch.sqrt(torch.ones(4096))   # see tests/test_torch_*.py
    kw = dict(max_narrow_pairs_per_group=512, contact_phases=4,
              broadphase_k=8)
    dt = 1.0 / 120.0
    jset = JaxSettings(num_rigid_solver_iterations=30, solver_mode="jacobi")
    jax_runs = {}
    for mode in ("kselect", "table"):
        scene = towers(JaxBuilder, args.towers).finalize(broadphase=mode, **kw)
        step = jax.jit(lambda s, scene=scene: jax_step(scene, s, jset, dt)[0])
        jax_runs[mode] = (step, scene.initial_state())
    tscene = towers(SceneBuilder, args.towers).finalize(
        broadphase="kselect", device="cpu", **kw)
    tset = PhysicsSettings(num_rigid_solver_iterations=30,
                           solver_mode="jacobi")
    tst = tscene.initial_state(1)
    start = np.asarray(jax_runs["kselect"][1].pos)

    def drift(pos):
        return float(np.abs((pos - start)[1:-1][:, [0, 2]]).max())

    for i in range(1, args.steps + 1):
        for mode, (step, st) in jax_runs.items():
            jax_runs[mode] = (step, step(st))
        tst, _info = physics_step(tscene, tst, tset, dt)
        if i % 20 == 0:
            jk = np.asarray(jax_runs["kselect"][1].pos)
            jt = np.asarray(jax_runs["table"][1].pos)
            tp = tst.pos[0].numpy()
            print(json.dumps({
                "step": i, "jax_xz_drift": drift(jk),
                "port_xz_drift": drift(tp),
                "port_vs_jax_max_pos_diff": float(np.abs(tp - jk).max()),
                "jax_table_vs_kselect_max_pos_diff":
                    float(np.abs(jt - jk).max())}), flush=True)


if __name__ == "__main__":
    main()
