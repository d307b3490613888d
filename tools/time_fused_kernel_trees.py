"""Time the loco scene's fused-step kernel of one or more source trees on the
GPU, each in a process of its own, so two versions of the kernel can be
compared in one call on one card (run them in turns: parent, change,
change, parent).

Each TREE is a directory holding a `dxk_tpu_torch/` package (for example an
unpacked `git archive <commit> dxk_tpu_torch`). For each, the script builds
that tree's kernel, rolls 4096 loco envs 60 steps with seeded random
actions, then times the kernel on the resulting inputs: five runs of 20
back-to-back launches queued behind a spin of the card, CUDA events. One
JSON line per tree: the five times in ms, their median and the kernel's
ptxas register line.

    python3 tools/time_fused_kernel_trees.py TREE [TREE ...]
"""

import json
import os
import subprocess
import sys

ENVS = 4096
WARM_STEPS = 60
RUNS, REPS = 5, 20


def time_tree(tree):
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
    env = LocoEnv(solver_mode="fused", solver_iterations=30, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st, _obs = env.reset(ENVS)
    for _ in range(WARM_STEPS):
        act = torch.rand((ENVS, 27), generator=gen, device="cuda") * 2 - 1
        st, _obs, _r, _d = env.step(st, act, gen)
    s, dt32 = st.physics, np.float32(DT)
    wcol = world_colliders(env.scene, s.pos, s.rot)
    bodies = integrate_forces(env.scene, s, float(dt32))
    ctl = controls_pack(env.scene, s.controls, dt32)
    solver = fs.make_fused_step_solver(env.scene, 30, 1.0)
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
    return dict(tree=tree, device=torch.cuda.get_device_name(0), ms=times,
                median=sorted(times)[RUNS // 2], ptxas=regs)


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_tree(os.path.abspath(sys.argv[2]))),
              flush=True)
        return
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)


if __name__ == "__main__":
    main()
