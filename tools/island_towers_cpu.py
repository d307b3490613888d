"""The standing-tower invariant of bench.py's box stack on its default path
(islands), JAX package against the PyTorch port, on the CPU.

Builds bench.py's towers of 16 unit boxes (1.001 spawn gaps, 3 m apart,
contact_phases=2, candidate_margin=0.25), islandizes them in both packages
and steps every island from bench.py's spawn (or with chip_smoke.py's
seeded 0.5 mm jitter, --jitter) at 30 iterations and dt 1/120: the JAX
package in each of --jax-modes (jitted, vmapped; its "fused" step compiles
in about 40 s with XLA's fusion pass off, which this tool sets as
tests/conftest.py does), the port in each of --port-modes (the fused
kernel's plain version for "fused"). Every --every steps it prints one
JSON line per run: the largest and the median fall of an island's top
box, the largest, the median and the mean sideways (x/z) move of an
island's boxes since the start, and how many islands are past each bound
of tests/test_islands.py::test_island_towers_stand_at_bench_tuning (0.15
and 0.25).

    JAX_PLATFORMS=cpu python3 tools/island_towers_cpu.py [--towers 64]
        [--steps 600] [--every 25] [--jax-modes colored,fused]
        [--port-modes fused] [--jitter]
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
ITERATIONS = 30


def run_jax(mode, n_towers, pos0, steps, every):
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from dxk_tpu.physics import PhysicsSettings, physics_step
    from dxk_tpu.scene import SceneBuilder
    from dxk_tpu.scene.islands import islandize
    cs.BOX_TOWERS = n_towers
    scene = cs.box_towers(SceneBuilder).finalize(
        contact_phases=cs.ISLAND_PHASES, candidate_margin=cs.ISLAND_MARGIN)
    im = islandize(scene)
    s = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                        solver_mode=mode)
    step = jax.jit(jax.vmap(
        lambda x: physics_step(im.sub_scene, x, s, DT)[0]))
    st = im.gather(scene.initial_state().replace(pos=jnp.asarray(pos0)))
    yield from _trace(lambda x: step(x), st, steps, every,
                      lambda x: np.asarray(x.pos))


def run_port(mode, n_towers, pos0, steps, every):
    import torch

    import chip_smoke as cs
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene.islands import islandize
    cs.BOX_TOWERS = n_towers
    scene = cs.island_scene("cpu")
    im = islandize(scene)
    s = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                        solver_mode=mode)
    full = scene.initial_state(1)
    st = im.gather(full.replace(pos=torch.from_numpy(pos0)[None]))
    yield from _trace(lambda x: physics_step(im.sub_scene, x, s, DT)[0], st,
                      steps, every, lambda x: x.pos.numpy())


def _trace(step, st, steps, every, pos_of):
    p0 = pos_of(st)
    top = p0.shape[1] - 2              # an island's top box (dummy last)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        st = step(st)
        if i % every == 0:
            p = pos_of(st)
            drop = p0[:, top, 1] - p[:, top, 1]
            xz = np.abs(p - p0)[:, :-1][..., [0, 2]].max(axis=(1, 2))
            yield dict(step=i, seconds=time.perf_counter() - t0,
                       top_box_drop_max_m=float(drop.max()),
                       top_box_drop_median_m=float(np.median(drop)),
                       islands_over_drop_bound=int((drop >= 0.15).sum()),
                       max_xz_move_m=float(xz.max()),
                       median_xz_move_m=float(np.median(xz)),
                       mean_xz_move_m=float(xz.mean()),
                       islands_over_xz_bound=int((xz >= 0.25).sum()),
                       islands=int(p.shape[0]),
                       finite=bool(np.isfinite(p).all()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--towers", type=int, default=64)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--jax-modes", default="colored")
    ap.add_argument("--port-modes", default="fused")
    ap.add_argument("--jitter", action="store_true",
                    help="chip_smoke.box_initial_state's seeded jitter "
                         "(world 0) instead of bench.py's spawn")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_disable_hlo_passes" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_disable_hlo_passes=fusion"

    import chip_smoke as cs
    cs.BOX_TOWERS, cs.DEVICE, cs.BOX_BATCH = args.towers, "cpu", 1
    scene = cs.island_scene("cpu")
    st = (cs.box_initial_state(scene, 12) if args.jitter
          else scene.initial_state(1))
    pos0 = st.pos[0].numpy().astype(np.float32)
    for mode in filter(None, args.jax_modes.split(",")):
        for row in run_jax(mode, args.towers, pos0, args.steps, args.every):
            print(json.dumps({"package": "jax", "mode": mode, **row}),
                  flush=True)
    for mode in filter(None, args.port_modes.split(",")):
        for row in run_port(mode, args.towers, pos0, args.steps, args.every):
            print(json.dumps({"package": "port", "mode": mode, **row}),
                  flush=True)


if __name__ == "__main__":
    main()
