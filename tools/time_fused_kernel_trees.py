"""Time the fused-step kernel of one or more source trees on the GPU, each
in a process of its own, so two versions of the kernel can be compared in
one call on one card (run them in turns: parent, change, change, parent).

Each TREE is a directory holding a `dxk_tpu_torch/` package (for example an
unpacked `git archive <commit> dxk_tpu_torch`). For each, the script builds
that tree's kernel (once per library it needs), then for each scene rolls
4096 envs of it 60 steps
and times the kernel on the resulting inputs, at 30 solver iterations or
at each count of `--iterations` (0 leaves narrowphase and prep alone):
five runs of 20 back-to-back launches queued behind a spin of the card,
CUDA events. Scenes: "loco", the
loco env with seeded random actions; "zoo", "settle" and "mixed",
chip_smoke.py's constraint zoo, ragdoll settle and golden mixed-shape drop
(after 150 steps, when its bodies touch), each built with the tree's own
package (a tree whose package cannot build a scene prints that and goes
on). One JSON line per tree, scene and iteration count: the five times in ms,
their median and the kernel's ptxas lines.

    python3 tools/time_fused_kernel_trees.py [--scene loco,zoo,settle,mixed]
                                             [--iterations 0,30] TREE [TREE ...]
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENVS = 4096
WARM_STEPS = {"loco": 60, "zoo": 60, "settle": 60, "mixed": 150}
RUNS, REPS = 5, 20


def scene_state(name):
    """(scene, dt, state) of `name` after its warm-up steps at ENVS envs."""
    import torch
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    if name == "loco":
        from dxk_tpu_torch.envs.loco_env import DT, LocoEnv
        env = LocoEnv(solver_mode="fused", solver_iterations=30,
                      device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        st, _obs = env.reset(ENVS)
        for _ in range(WARM_STEPS[name]):
            act = torch.rand((ENVS, 27), generator=gen, device="cuda") * 2 - 1
            st, _obs, _r, _d = env.step(st, act, gen)
        return env.scene, DT, st.physics
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    if name == "zoo":
        scene, dt, init = cs.zoo_scene(), cs.ZOO_DT, cs.zoo_initial_state
    elif name == "settle":
        scene, dt = cs.settle_scene(), cs.SETTLE_DT
        init = cs.settle_initial_state
    else:
        scene, dt = cs.shapes_scene("mixed_shape_drop"), cs.SHAPES_DT
        init = cs.shapes_initial_state
    settings = PhysicsSettings(num_rigid_solver_iterations=30,
                               solver_mode="fused")
    s = init(scene, ENVS, 0)
    for _ in range(WARM_STEPS[name]):
        s, _info = physics_step(scene, s, settings, dt)
    return scene, dt, s


def time_tree(tree, scenes, iteration_counts):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import controls_pack

    # the tree's libraries, built before any scene's steps build them
    # quietly (a tree from before the sphere and cylinder recipes has one)
    if hasattr(fs, "BUILD_LOGS"):
        for shapes in (False, True):
            fs.load_library(verbose=True, shapes=shapes)
        logs = dict(fs.BUILD_LOGS)
    else:
        fs.load_library(verbose=True)
        logs = {"base": fs.BUILD_LOG}

    for name in scenes:
        try:
            scene, dt, s = scene_state(name)
        except NotImplementedError as e:
            print(json.dumps(dict(tree=tree, scene=name,
                                  skipped=f"NotImplementedError: {e}")),
                  flush=True)
            continue
        dt32 = np.float32(dt)
        wcol = world_colliders(scene, s.pos, s.rot)
        bodies = integrate_forces(scene, s, float(dt32))
        ctl = controls_pack(scene, s.controls if s.controls is not None
                            else scene.batched_controls(ENVS), dt32)
        inv_dt = float(np.float32(1.0) / dt32)
        tab = fs.fused_tables(scene, "cuda")
        log = logs["shapes" if getattr(tab, "has_shapes", False) else "base"]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln or "stack" in ln]
        for iters in iteration_counts:
            solver = fs.make_fused_step_solver(scene, iters, 1.0)
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
            print(json.dumps(dict(tree=tree, scene=name, iterations=iters,
                                  device=torch.cuda.get_device_name(0),
                                  ms=times, median=sorted(times)[RUNS // 2],
                                  ptxas=ptxas)), flush=True)


def main():
    args = sys.argv[1:]
    scenes, iters = ["loco"], [30]
    while args[:1] in (["--scene"], ["--iterations"]):
        if args[0] == "--scene":
            scenes = args[1].split(",")
        else:
            iters = [int(x) for x in args[1].split(",")]
        args = args[2:]
    if not args or any(s not in WARM_STEPS for s in scenes):
        raise SystemExit(__doc__)
    if len(args) == 2 and args[0] == "--one":
        time_tree(os.path.abspath(args[1]), scenes, iters)
        return
    for tree in args:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--scene", ",".join(scenes),
                        "--iterations", ",".join(map(str, iters)),
                        "--one", tree], check=True)


if __name__ == "__main__":
    main()
