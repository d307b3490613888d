"""Run csrc/fused_step.cu on the CPU and hold it against the plain version.

A machine without nvcc cannot build the fused-step kernel. This script
compiles the same source with g++ instead: a small header maps the CUDA
keywords away, every CUDA thread of a block becomes a std::thread, and
__syncthreads() becomes a std::barrier, so the kernel's shared-memory
layout, indexing and per-type joint passes run as written (blocks one after
another). Built with -ffp-contract=off, like the card's -fmad=false, and
with the sphere and cylinder recipes (the build the card launches for
scenes with such rows; the other build is the same code without them). It
prints, per scene, the largest differences between the emulated kernel and
the plain version `_fused_core` (and how many floats differ in their
bits, zeros of either sign told apart): on the constraint zoo, on bench.py's
ragdoll settle (initial state and hull poses that send every hull recipe
down each of its branches), on the hull pile, on the golden mixed-shape drop
and sphere bounce (initial and after --shapes-steps steps), on the sphere
and cylinder check pile and on the locomotion scene.
sin/cos come from the C library, so scenes with the ragdoll (whose
cone-twist prep calls them) may differ by float rounding.

With --library prepped it builds the third library instead (every recipe,
-DDXK_PREPPED_JOINTS=1: joint rows prepared outside the kernel, averaged or
sequential solve, prep-passed heightfield rows) and holds it against the
plain version on the six golden scenes of tests/test_golden_trajectories.py,
in both modes it serves: "fused_seq" (sequential) and "fused" with
joint_prep_in_kernel=False (averaged), each on the initial state and after
--shapes-steps and --late-steps steps of the "fused" step (the states the
comparison reads; contacts are live by then); and on chip_smoke.py's
terrain scene (initial, after --shapes-steps steps, terrain poses) in
"fused_seq" and "fused" with the joint prep outside and inside the kernel.

    python3 tools/emulate_fused_step_cpu.py [--chains 2] [--batch 5]
                                            [--shapes-steps 60]
                                            [--only zoo|settle|shapes|loco ...]
    python3 tools/emulate_fused_step_cpu.py --library prepped [--batch 5]
                                            [--shapes-steps 60]
                                            [--late-steps 150]
                                            [--only-scene NAME|terrain ...]

Needs g++ with C++20; writes only under <repo>/build/emulate/.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dxk_tpu_torch.ops.integrator import integrate_forces  # noqa: E402
from dxk_tpu_torch.ops.kernels import fused_step as fs  # noqa: E402
from dxk_tpu_torch.ops.shapes import world_colliders  # noqa: E402
from dxk_tpu_torch.physics import (PhysicsSettings, controls_pack,  # noqa: E402
                                   joint_inputs, physics_step,
                                   terrain_inputs)

GROUPS = ("zoo", "settle", "shapes", "loco")

SHIM = r"""
#pragma once
#include <barrier>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
struct dim3_ { unsigned x, y, z; };
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim;
inline std::barrier<>* g_bar;
inline float* g_smem;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  __builtin_memcpy(&u, &x, 4);
  return u;
}
template <class K, class... A>
void emu_launch(int grid, int threads, int smem_bytes, K k, A... args) {
  std::vector<float> sm(smem_bytes / 4, -12345.0f);
  g_smem = sm.data();
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=]() { threadIdx.x = t; k(args...); });
    for (auto& th : ts) th.join();
  }
}
"""


def build(library="shapes"):
    """g++ build of csrc/fused_step.cu: the "shapes" library (the default)
    or the "prepped" one."""
    out = os.path.join(ROOT, "build", "emulate")
    os.makedirs(out, exist_ok=True)
    src = open(os.path.join(ROOT, "dxk_tpu_torch", "ops", "kernels", "csrc",
                            "fused_step.cu")).read()
    src = re.sub(r"fused_step_kernel<<<([^,]*), ([^,]*), ([^,]*), [^>]*>>>\(",
                 r"emu_launch(\1, \2, \3, fused_step_kernel, ", src)
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = g_smem;")
    with open(os.path.join(out, "cuda_runtime.h"), "w") as f:
        f.write(SHIM)
    with open(os.path.join(out, "fused_step.cpp"), "w") as f:
        f.write(src)
    prepped = library == "prepped"
    lib = os.path.join(out, f"libfused_step_emu_{library}.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-DDXK_SHAPE_RECIPES=1"]
                   + (["-DDXK_PREPPED_JOINTS=1"] if prepped else [])
                   + ["-fPIC", "-shared", "-Wno-unknown-pragmas", "-I", out,
                      "-o", lib, os.path.join(out, "fused_step.cpp"),
                      "-lpthread"], check=True)
    dll = ctypes.CDLL(lib)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = dll.dxk_fused_step_prepped_launch if prepped \
        else dll.dxk_fused_step_launch
    fn.restype = i
    fn.argtypes = ([ctypes.POINTER(i), fl, fl] + [p] * 10
                   + ([p, i, i, p, i] if prepped else []) + [p] * 6
                   + [i, i, p])
    return fn


def compare(launch, scene, state, dt, mode=None, prep_in_kernel=False):
    """Largest differences, emulated kernel vs plain version, one solve:
    the averaged solve with joint prep in the kernel (`mode` None, the
    shapes library), or "fused_seq" / "fused" on prepared joint rows (the
    prepped library; "fused" with `prep_in_kernel` preps them in the
    kernel). A heightfield scene's terrain rows are passed in prepared."""
    tab = fs.fused_tables(scene, "cpu")
    dt32 = np.float32(dt)
    w = world_colliders(scene, state.pos, state.rot)
    b = integrate_forces(scene, state, float(dt32))
    ctl = controls_pack(scene, state.controls, dt32)
    passed = terrain_inputs(scene, w, b, dt32)
    inv_dt = float(np.float32(1.0) / dt32)
    B, P = b.v.shape[0], tab.num_rows
    v, wv = torch.empty_like(b.v), torch.empty_like(b.w)
    imp = torch.empty((B, P, 4))
    live = torch.empty((B, P), dtype=torch.uint8)
    dims = tab.dims(B, cs.ITERATIONS)
    ins = [b.v, b.w, b.inv_mass, b.inv_inertia, b.pos_cog, b.rot, ctl, w.a,
           w.b, w.rot]
    ins = [x.contiguous().data_ptr() for x in ins]
    tables, extra = None, []
    if mode is not None:
        crows = fs.passed_rows(tab, passed) if passed is not None else None
        extra = [None, int(mode == "fused_seq"), 0,
                 crows.data_ptr() if crows is not None else None,
                 tab.passed_points]
        if not prep_in_kernel:
            tables = joint_inputs(scene, b, state.controls, dt32, False)
            jrows = fs.joint_rows_field_major(tab, tables, b.v)
            extra[0], extra[2] = jrows.data_ptr(), 1
    err = launch(
        (ctypes.c_int * len(dims))(*dims), 1.0, inv_dt, *ins, *extra,
        tab.itab.data_ptr(), tab.ftab.data_ptr(), v.data_ptr(),
        wv.data_ptr(), imp.data_ptr(), live.data_ptr(), tab.threads(),
        tab.shared_floats() * 4, None)
    if err:
        raise RuntimeError(f"emulated launch returned {err}")
    vw, pimp, plive = fs._fused_core(
        tab, cs.ITERATIONS, 1.0, inv_dt, torch.cat([b.v, b.w], -1),
        b.inv_mass, b.inv_inertia, b.pos_cog, b.rot, ctl, w.a, w.b, w.rot,
        joint_tables=tables, sequential=mode == "fused_seq", passed=passed)
    def bits(x):
        return x.contiguous().view(torch.int32)
    return dict(err_v=float((v - vw[..., :3]).abs().max()),
                err_w=float((wv - vw[..., 3:]).abs().max()),
                err_imp=float((imp - pimp).abs().max()),
                # floats whose bits differ (a zero of the other sign counts)
                bits_differ=int((bits(v) != bits(vw[..., :3])).sum()
                                + (bits(wv) != bits(vw[..., 3:])).sum()
                                + (bits(imp) != bits(pimp)).sum()),
                live_mismatch=int((live != plive).sum()),
                live_rows=int((plive != 0).sum()))


def terrain_main(launch, args):
    """The prepped library on the terrain scene (prep-passed heightfield
    rows): initial, after --shapes-steps steps and on terrain poses, in
    "fused_seq", "fused" on prepared joint rows and "fused" with the joint
    prep in the kernel (what physics_step launches for "fused")."""
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode="fused")
    scene = cs.terrain_scene("cpu")
    st = cs.terrain_initial_state(scene, args.batch, 0)
    states = {"terrain_initial": st}
    for _ in range(args.shapes_steps):
        st, _info = physics_step(scene, st, settings, cs.TERRAIN_DT)
    states[f"terrain_after_{args.shapes_steps}_steps"] = st
    states["terrain_poses"] = cs.terrain_poses(scene, 2 * args.batch, 0)
    for name, st in states.items():
        for mode, jp in (("fused_seq", False), ("fused", False),
                         ("fused", True)):
            print(json.dumps({"scene": name, "mode": mode,
                              "joint_prep_in_kernel": jp, **compare(
                                  launch, scene, st, cs.TERRAIN_DT, mode,
                                  jp)}), flush=True)


def prepped_main(args):
    """The prepped library on the six golden scenes, both modes, and on the
    terrain scene."""
    launch = build("prepped")
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode="fused")
    for name in args.only_scene or cs.GOLDEN_SCENES + ("terrain",):
        if name == "terrain":
            terrain_main(launch, args)
            continue
        scene = cs.shapes_scene(name, "cpu")
        st = cs.shapes_initial_state(scene, args.batch, 0)
        marks = {0, args.shapes_steps, args.late_steps}
        for t in range(max(marks) + 1):
            if t in marks:
                for mode in ("fused_seq", "fused"):
                    print(json.dumps({"scene": f"{name}_after_{t}_steps",
                                      "mode": mode, **compare(
                                          launch, scene, st, cs.SHAPES_DT,
                                          mode)}), flush=True)
            st, _info = physics_step(scene, st, settings, cs.SHAPES_DT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", choices=("shapes", "prepped"),
                    default="shapes")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--shapes-steps", type=int, default=60)
    ap.add_argument("--late-steps", type=int, default=150)
    ap.add_argument("--only", choices=GROUPS, action="append",
                    help="run only these scene groups (default: all)")
    ap.add_argument("--only-scene", choices=cs.GOLDEN_SCENES + ("terrain",),
                    action="append",
                    help="with --library prepped: only these golden scenes "
                         "or the terrain scene")
    args = ap.parse_args()
    if args.library == "prepped":
        prepped_main(args)
        return
    groups = args.only or GROUPS
    launch = build()
    if "zoo" in groups:
        zoo = cs.zoo_scene(args.chains, device="cpu")
        for name, st in (
                ("zoo_initial", cs.zoo_initial_state(zoo, args.batch, 0)),
                ("zoo_limit_poses", cs.zoo_limit_state(zoo, args.batch, 0))):
            print(json.dumps({"scene": name, "chains": args.chains,
                              **compare(launch, zoo, st, cs.ZOO_DT)}),
                  flush=True)
    if "settle" in groups:
        settle = cs.settle_scene("cpu")
        pile = cs.pile_scene("cpu")
        for name, scene, st in (
                ("settle_initial", settle,
                 cs.settle_initial_state(settle, args.batch, 0)),
                ("settle_hull_poses", settle,
                 cs.settle_hull_poses(settle, 4 * args.batch, 0)),
                ("pile_poses", pile, cs.pile_poses(pile, 2 * args.batch, 0))):
            print(json.dumps({"scene": name, **compare(launch, scene, st,
                                                       cs.SETTLE_DT)}),
                  flush=True)
    if "shapes" in groups:
        settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                                   solver_mode="fused")
        for name in cs.SHAPES_SCENES:
            scene = cs.shapes_scene(name, "cpu")
            st = cs.shapes_initial_state(scene, args.batch, 0)
            print(json.dumps({"scene": f"{name}_initial",
                              **compare(launch, scene, st, cs.SHAPES_DT)}),
                  flush=True)
            for _ in range(args.shapes_steps):
                st, _info = physics_step(scene, st, settings, cs.SHAPES_DT)
            print(json.dumps({
                "scene": f"{name}_after_{args.shapes_steps}_steps",
                **compare(launch, scene, st, cs.SHAPES_DT)}), flush=True)
        pile = cs.shapes_pile_scene("cpu")
        print(json.dumps({"scene": "shapes_pile_poses", **compare(
            launch, pile, cs.shapes_pile_poses(pile, 8 * args.batch, 0),
            cs.SHAPES_DT)}), flush=True)
    if "loco" in groups:
        from dxk_tpu_torch.envs.loco_env import DT, LocoEnv
        env = LocoEnv(solver_mode="fused", device="cpu", enable_pokes=False)
        gen = torch.Generator().manual_seed(0)
        st, _obs = env.reset(args.batch)
        for _ in range(20):
            act = torch.rand((args.batch, 27), generator=gen) * 2 - 1
            st, _obs, _r, _d = env.step(st, act, gen)
        print(json.dumps({"scene": "loco_after_20_steps",
                          **compare(launch, env.scene, st.physics, DT)}),
              flush=True)


if __name__ == "__main__":
    main()
