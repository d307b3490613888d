"""Time the fused-step kernel of one or more source trees on the GPU, each
in a process of its own, so two versions of the kernel can be compared in
one call on one card (run them in turns: parent, change, change, parent).

Each TREE is a directory holding a `dxk_tpu_torch/` package (for example an
unpacked `git archive <commit> dxk_tpu_torch`). For each, the script builds
that tree's kernel, rolls 4096 envs of the scene 60 steps — the loco env
with seeded random actions, or chip_smoke.py's constraint zoo
(`--scene zoo`, built with the tree's own package) — then times the kernel
on the resulting inputs: five runs of 20 back-to-back launches queued
behind a spin of the card, CUDA events. One JSON line per tree: the five
times in ms, their median and the kernel's ptxas register line.

    python3 tools/time_fused_kernel_trees.py [--scene loco|zoo] TREE [TREE ...]
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENVS = 4096
WARM_STEPS = 60
RUNS, REPS = 5, 20


def time_tree(tree, scene_name):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from dxk_tpu_torch.envs.loco_env import DT, LocoEnv
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import controls_pack

    fs.load_library(verbose=True)
    regs = [ln.strip() for ln in fs.BUILD_LOG.splitlines() if "Used" in ln]
    if scene_name == "zoo":
        sys.path.insert(1, ROOT)
        import chip_smoke as cs
        from dxk_tpu_torch.physics import PhysicsSettings, physics_step
        scene, dt = cs.zoo_scene(), cs.ZOO_DT
        settings = PhysicsSettings(num_rigid_solver_iterations=30,
                                   solver_mode="fused")
        s = cs.zoo_initial_state(scene, ENVS, 0)
        for _ in range(WARM_STEPS):
            s, _info = physics_step(scene, s, settings, dt)
    else:
        env = LocoEnv(solver_mode="fused", solver_iterations=30,
                      device="cuda")
        scene, dt = env.scene, DT
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        st, _obs = env.reset(ENVS)
        for _ in range(WARM_STEPS):
            act = torch.rand((ENVS, 27), generator=gen, device="cuda") * 2 - 1
            st, _obs, _r, _d = env.step(st, act, gen)
        s = st.physics
    dt32 = np.float32(dt)
    wcol = world_colliders(scene, s.pos, s.rot)
    bodies = integrate_forces(scene, s, float(dt32))
    ctl = controls_pack(scene, s.controls if s.controls is not None
                        else scene.batched_controls(ENVS), dt32)
    solver = fs.make_fused_step_solver(scene, 30, 1.0)
    inv_dt = float(np.float32(1.0) / dt32)
    for _ in range(3):
        solver(bodies, wcol, ctl, inv_dt)
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            solver(bodies, wcol, ctl, inv_dt)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / REPS)
    return dict(tree=tree, scene=scene_name,
                device=torch.cuda.get_device_name(0), ms=times,
                median=sorted(times)[RUNS // 2], ptxas=regs)


def main():
    args = sys.argv[1:]
    scene = "loco"
    if args[:1] == ["--scene"]:
        scene, args = args[1], args[2:]
    if not args or scene not in ("loco", "zoo"):
        raise SystemExit(__doc__)
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(time_tree(os.path.abspath(args[1]), scene)),
              flush=True)
        return
    for tree in args:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--scene", scene, "--one", tree], check=True)


if __name__ == "__main__":
    main()
