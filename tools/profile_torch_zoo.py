"""Where a step of a fused-step scene spends its time on the GPU, at each
of chip_smoke.py's batches for that scene.

Scenes (`--scene`): "zoo", chip_smoke.py's constraint zoo (bench.py's
BASELINE config 2: 16 chains, 112 bodies, 96 joints), "settle", its
ragdoll drop-and-settle with the hull debris (BASELINE config 3: 16
bodies, 165 pair rows, 13 joints; bench.py counts 15 bodies), and "mixed",
its golden mixed-shape drop (a hull, a cylinder and a capsule onto a box
ramp: 3 dynamic bodies, 9 pair rows); 30 solver iterations, "fused". Or a
golden scene of tests/test_golden_trajectories.py by name (chip_smoke's
copies, from its golden start), by default at one env, the fidelity row's
batch, and with `--mode fused_seq` the sequential solve on joint rows
prepared outside the kernel, as bench.py's fidelity row runs it. Steps
the scene `--warm` steps (150 for "mixed" unless given: its bodies land
after about 80), then per batch prints
one JSON line: host time per step over `--steps` steps, and from
torch.profiler over `--profile-steps` steps, device busy time per step, the
device's idle share, the fused-step kernel's device time per step, device
kernel launches per step, the top device kernels by time, and the kernel
alone (CUDA events) with 0 and with 30 solver iterations, which splits its
time between narrowphase + prep and the solve.

    python3 tools/profile_torch_zoo.py [--scene zoo|settle|mixed] [--steps 50]
    python3 tools/profile_torch_zoo.py --scene ragdoll_settle --mode fused_seq
                                       [--batch 1 --batch 4096]
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dxk_tpu_torch.ops.kernels import fused_step as fs  # noqa: E402
from dxk_tpu_torch.physics import PhysicsSettings, physics_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--warm", type=int, default=None)
    ap.add_argument("--scene", choices=("zoo", "settle", "mixed")
                    + cs.GOLDEN_SCENES, default="zoo")
    ap.add_argument("--mode", choices=("fused", "fused_seq"),
                    default="fused")
    ap.add_argument("--batch", type=int, action="append",
                    help="batches to profile (default: the scene's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_zoo: no CUDA device")

    if args.scene == "zoo":
        scene, batches, dt = cs.zoo_scene(), cs.ZOO_BATCHES, cs.ZOO_DT
        state, bodies = cs.zoo_initial_state, scene.num_bodies
    elif args.scene == "settle":
        scene, batches, dt = (cs.settle_scene(), cs.SETTLE_BATCHES,
                              cs.SETTLE_DT)
        state, bodies = cs.settle_initial_state, cs.SETTLE_BODIES
    elif args.scene == "mixed":
        scene = cs.shapes_scene("mixed_shape_drop")
        batches, dt = cs.SHAPES_BATCHES, cs.SHAPES_DT
        state = cs.shapes_initial_state
        bodies = cs.SHAPES_BODIES["mixed_shape_drop"]
    else:
        scene = cs.shapes_scene(args.scene)
        batches, dt = (1,), cs.FIDELITY_DT
        state = lambda sc, b, _seed: sc.initial_state(b)  # noqa: E731
        bodies = int((scene.body_params.inv_mass > 0).sum())
    batches = tuple(args.batch or batches)
    if args.warm is None:
        args.warm = 150 if args.scene == "mixed" else 60
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode=args.mode)
    prep_in_kernel = args.mode == "fused"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = args.profile_steps
    for batch in batches:
        st = state(scene, batch, 0)
        for _ in range(args.warm):
            st, _info = physics_step(scene, st, settings, dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            st, _info = physics_step(scene, st, settings, dt)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                st, _info = physics_step(scene, st, settings, dt)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            # device-side events only: an operator's row repeats the time
            # of the kernels it launched
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", 0) or 0
            if dev_us > 0:
                rows.append((ev.key, dev_us, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows) / 1e3 / n
        kern_ms = sum(r[1] for r in rows
                      if "fused_step_kernel" in r[0]) / 1e3 / n
        # the kernel alone on this state with no solver iterations
        # (narrowphase, contact and joint prep) and with all of them
        bodies_, wcol, joints, inv_dt = cs.kernel_inputs(scene, st, dt,
                                                         prep_in_kernel)
        split = {}
        for iters in (0, cs.ITERATIONS):
            solver = fs.make_fused_step_solver(
                scene, iters, 1.0, sequential=args.mode == "fused_seq",
                joint_prep_in_kernel=prep_in_kernel)
            for _ in range(3):
                solver(bodies_, wcol, joints, inv_dt)
            split[iters] = cs.time_ms(
                lambda: solver(bodies_, wcol, joints, inv_dt), 20)
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "scene": args.scene,
            "mode": args.mode,
            "envs": batch, "bodies": bodies, "host_steps": args.steps,
            "profiled_steps": n, "host_step_ms": step_ms,
            "body_steps_per_s": bodies * batch / step_ms * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / step_ms,
            "fused_kernel_ms_per_step": kern_ms,
            "fused_kernel_ms_by_iterations": split,
            "device_launches_per_step": sum(r[2] for r in rows) / n,
            "top_device_kernels": [
                {"name": r[0][:80], "ms_per_step": r[1] / 1e3 / n,
                 "calls_per_step": r[2] / n} for r in rows[:8]],
        }), flush=True)


if __name__ == "__main__":
    main()
