"""Where a step of the 1k-box stack on the port's reference step spends its
time on the GPU, for each broadphase.

Builds the box stack of chip_smoke.py's box_stack phase (bench.py's
`_box_towers(1024)`, 32 envs, 30 solver iterations, "jacobi"), steps it
`--warm` steps, then per broadphase prints one JSON line: host time per
step with 30 solver iterations and with none (their difference is the
iterated contact solve), both over `--steps` steps; and from torch.profiler
over `--profile-steps` steps, device busy time per step, the device's idle
share, the broadphase kernel's device time per step, device kernel launches
per step and the top device kernels by time. For "sap" it also profiles the
sort-and-sweep route alone (`sap_broadphase` on the state's AABBs, as the
step calls it): its device launches and time per call, split into the
sweep kernel and the PyTorch sort, gathers and scatters around it.

    python3 tools/profile_torch_box_stack.py [--steps 10] [--profile-steps 3]
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
from dxk_tpu_torch.physics import PhysicsSettings, physics_step  # noqa: E402

KERNELS = {"table": "overlap_matrix_kernel", "kselect": "kselect_kernel",
           "sap": "sap_kernel"}


def host_ms(scene, st, settings, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st, _info = physics_step(scene, st, settings, cs.BOX_DT)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def device_rows(prof):
    """(name, device us, count) of the device-side events of a profile:
    an operator's row repeats the time of the kernels it launched."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def sweep_route(scene, st, n, acts):
    """Device launches and time of `sap_broadphase` alone, per call, on
    the AABBs of `st`: the sweep kernel against the rest of the route."""
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    mn, mx = cs.aabbs(scene, st)
    col = scene.colliders
    args = (mn, mx, col.body, col.owner_type, col.ctype,
            scene.num_contact_phases, scene.broadphase_k, scene.sap_window,
            scene.sap_broad)
    sp.sap_broadphase(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            sp.sap_broadphase(*args)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    sweep = [r for r in rows if KERNELS["sap"] in r[0]]
    rest = [r for r in rows if KERNELS["sap"] not in r[0]]
    return {
        "calls": n,
        "launches_per_call": sum(r[2] for r in rows) / n,
        "device_ms_per_call": sum(r[1] for r in rows) / 1e3 / n,
        "sweep_kernel_launches_per_call": sum(r[2] for r in sweep) / n,
        "sweep_kernel_ms_per_call": sum(r[1] for r in sweep) / 1e3 / n,
        "other_launches_per_call": sum(r[2] for r in rest) / n,
        "other_ms_per_call": sum(r[1] for r in rest) / 1e3 / n,
        "other_kernels": [
            {"name": r[0][:80], "ms_per_call": r[1] / 1e3 / n,
             "launches_per_call": r[2] / n} for r in rest],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--warm", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_box_stack: no CUDA device")

    scenes = cs.box_scenes()
    full = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                           solver_mode="jacobi")
    none = PhysicsSettings(num_rigid_solver_iterations=0,
                           solver_mode="jacobi")
    st = cs.box_initial_state(scenes["table"], 0)
    for _ in range(args.warm):
        st, _info = physics_step(scenes["table"], st, full, cs.BOX_DT)

    # host clocks first for every broadphase: a profiled window slows the
    # host calls that follow it in the same process
    host = {mode: (host_ms(scene, st, full, args.steps),
                   host_ms(scene, st, none, args.steps))
            for mode, scene in scenes.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = args.profile_steps
    for mode, scene in scenes.items():
        step_ms, step0_ms = host[mode]
        with torch.profiler.profile(activities=acts) as prof:
            s = st
            for _ in range(n):
                s, _info = physics_step(scene, s, full, cs.BOX_DT)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        busy_ms = sum(r[1] for r in rows) / 1e3 / n
        kern_ms = sum(r[1] for r in rows if KERNELS[mode] in r[0]) / 1e3 / n
        route = sweep_route(scene, s, n, acts) if mode == "sap" else None
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "broadphase": mode,
            "envs": cs.BOX_BATCH, "bodies": scene.num_bodies - 1,
            "host_steps": args.steps, "profiled_steps": n,
            "host_step_ms": step_ms,
            "host_step_ms_without_solver_iterations": step0_ms,
            "solver_iterations_share_of_host_time":
                (step_ms - step0_ms) / step_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / step_ms,
            "broadphase_kernel_ms_per_step": kern_ms,
            "device_launches_per_step": sum(r[2] for r in rows) / n,
            "top_device_kernels": [
                {"name": r[0][:80], "ms_per_step": r[1] / 1e3 / n,
                 "calls_per_step": r[2] / n} for r in rows[:8]],
            "sweep_route": route,
        }), flush=True)


if __name__ == "__main__":
    main()
