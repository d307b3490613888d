"""Replay one env of chip_smoke.py's shapes or terrain phase on the CPU,
JAX package against the PyTorch port.

chip_smoke.py prints, for each main-path run of its shapes phase, the state
of the env whose lowest body point ends deepest below the ground
(`runs[<scene>.B<batch>].deepest_env_state` in its `shapes` line), and for
the largest batch of its terrain phase the state of the env whose body
centre ends deepest below the terrain (`runs.<batch>.deepest_env_state` in
its `terrain` line; `--run terrain.B4096`). This script reads that line
from a saved chip_smoke.py output, puts the state into both packages' scene
and steps it with the JAX package's "fused" step (eagerly, op by op) and
with the port's plain version, 30 iterations, dt 1/120. Per step it prints
one JSON line: each dynamic collider's lowest point (for the terrain, each
body centre's height over the terrain) in both, the largest position and
velocity differences, and the port's live pair rows by recipe; then it
steps the port alone `--more` steps further and prints the heights again.

    JAX_PLATFORMS=cpu python3 tools/replay_shapes_state_cpu.py SMOKE_LOG
        [--run mixed_shape_drop.B4096|terrain.B4096] [--steps 3] [--more 60]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")
DT = 1.0 / 120.0         # chip_smoke.SHAPES_DT and TERRAIN_DT


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("smoke_log")
    ap.add_argument("--run", default="mixed_shape_drop.B4096")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--more", type=int, default=60)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from dxk_tpu.models.ragdoll import add_ragdoll as jax_add_ragdoll
    from dxk_tpu.ops.shapes import collider_aabbs as jax_aabbs
    from dxk_tpu.ops.shapes import world_colliders as jax_world
    from dxk_tpu.physics import PhysicsSettings as JaxSettings
    from dxk_tpu.physics import physics_step as jax_step
    from dxk_tpu.scene import SceneBuilder as JaxBuilder
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.utils.convert import state_from_numpy

    name = args.run.split(".")[0]
    terrain = name == "terrain"
    line = next(ln for ln in open(args.smoke_log) if ln.startswith(
        '{"phase": "%s"' % ("terrain" if terrain else "shapes")))
    runs = json.loads(line)["runs"]
    deep = (runs[args.run.split(".B")[1]] if terrain
            else runs[args.run])["deepest_env_state"]
    if terrain:
        jscene = cs.terrain_builder(JaxBuilder, jax_add_ragdoll).finalize()
        tscene = cs.terrain_scene("cpu")
    else:
        jscene = cs.golden_builder(JaxBuilder, name).finalize()
        tscene = cs.shapes_scene(name, "cpu")
    base = tscene.initial_state(1)
    fields = {k: getattr(base, k).numpy().copy() for k in FIELDS}
    for k in ("pos", "rot", "lin_vel", "ang_vel"):
        fields[k][0] = np.asarray(deep[k], np.float32)
    tst = state_from_numpy(fields | {"controls": None}, device="cpu")
    jst = jscene.initial_state().replace(
        **{k: jnp.asarray(fields[k][0]) for k in FIELDS})
    jset = JaxSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                       solver_mode="fused")
    tset = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                           solver_mode="fused")
    dyn = (tscene.colliders.body < tscene.num_bodies).numpy()

    def over_terrain(pos):
        p = torch.as_tensor(np.asarray(pos))[:tscene.num_bodies]
        return (p[:, 1] - height_at(tscene.heightfield, p[:, 0],
                                    p[:, 2])).tolist()

    def low_port(st):
        if terrain:
            return over_terrain(st.pos[0])
        mn, _ = collider_aabbs(tscene, world_colliders(tscene, st.pos,
                                                       st.rot))
        return mn[0, dyn, 1].tolist()

    def low_jax(st):
        if terrain:
            return over_terrain(st.pos)
        mn, _ = jax_aabbs(jscene, jax_world(jscene, st.pos, st.rot))
        return np.asarray(mn)[dyn, 1].tolist()

    tab = fs.fused_tables(tscene, "cpu")
    key = "centre_over_terrain_m" if terrain else "lowest_point_m"
    print(json.dumps({"run": args.run, "env": deep["env"],
                      key: low_port(tst)}), flush=True)
    for s in range(args.steps):
        with jax.disable_jit():
            jst = jax_step(jscene, jst, jset, DT)[0]
        tst, info = physics_step(tscene, tst, tset, DT)
        live, r0 = {}, 0
        rows = info.contact_mask[0]
        rows = rows.any(dim=-1) if rows.dim() == 2 else rows
        for m in tab.metas:
            rname = fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]] if m["native"]
                                    else fs.PASSED_ROW]
            live[rname] = live.get(rname, 0) + int(
                rows[r0:r0 + m["pg"]].sum())
            r0 += m["pg"]
        print(json.dumps({
            "step": s + 1, f"{key}_jax": low_jax(jst),
            f"{key}_port": low_port(tst),
            "max_abs_pos_diff": float(np.abs(np.asarray(jst.pos)
                                             - tst.pos[0].numpy()).max()),
            "max_abs_vel_diff": float(np.abs(np.asarray(jst.lin_vel)
                                             - tst.lin_vel[0].numpy()).max()),
            "live_rows_port": live}), flush=True)
    for _ in range(args.more):
        tst, _info = physics_step(tscene, tst, tset, DT)
    print(json.dumps({"port_steps_more": args.more,
                      f"{key}_port": low_port(tst),
                      "lin_vel": tst.lin_vel[0, 1:-1].tolist()}), flush=True)


if __name__ == "__main__":
    main()
