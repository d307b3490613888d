"""Run csrc/fused_step.cu on the CPU and hold it against the plain version.

A machine without nvcc cannot build the fused-step kernel. This script
compiles the same source with g++ instead: a small header maps the CUDA
keywords away, every CUDA thread of a block becomes a std::thread,
__syncthreads() becomes a std::barrier of the block, each warp gets a
std::barrier of its 32 threads that __syncwarp, __ballot_sync,
__shfl_sync, __shfl_up_sync, __shfl_down_sync, __reduce_min_sync and
__reduce_max_sync (exchanging through a per-warp array) wait at, __popc
is the builtin, and the kernel's named barrier (bar.sync of one env's
team) becomes a std::barrier per id and block. So the kernel's
teams, shared-memory layout, live lists, scratch and per-type joint passes
run as written (blocks one after another). Built with -ffp-contract=off,
like the card's -fmad=false, and with the sphere and cylinder recipes (the
build the card launches for scenes with such rows; the other build is the
same code without them). Each comparison runs three launch geometries: the
wrapper's plan for the batch (at a few envs one env on eight warps) and
FORCED_PLANS (three one-warp envs a block, two two-warp envs a block, the
last block part empty), on a scratch filled with -7777. It prints, per
scene and geometry, the largest differences between the emulated kernel
and the plain version `_fused_core` (and how many floats differ in their
bits, zeros of either sign told apart): on the constraint zoo, on bench.py's
ragdoll settle (initial state and hull poses that send every hull recipe
down each of its branches), on the hull pile and the three piles of hulls
past the per-thread polytope buffers (a 64-vertex hull under a box or
under a cylinder, a 24-sided prism under a tetrahedron; their buffers
live in the hull scratch), on the golden mixed-shape drop
and sphere bounce (initial and after --shapes-steps steps), on the sphere
and cylinder check pile, on chip_smoke.py's 1,081-row box pile (initial and
after --shapes-steps steps) and on the locomotion scene.
sin/cos come from the C library, so scenes with the ragdoll (whose
cone-twist prep calls them) may differ by float rounding.

With --library prepped it builds the third library instead (every recipe,
-DDXK_PREPPED_JOINTS=1: joint rows prepared outside the kernel, averaged or
sequential solve, prep-passed heightfield rows) and holds it against the
plain version on the six golden scenes of tests/test_golden_trajectories.py,
in both modes it serves: "fused_seq" (sequential) and "fused" with
joint_prep_in_kernel=False (averaged), each on the initial state and after
--shapes-steps and --late-steps steps of the "fused" step (the states the
comparison reads; contacts are live by then); on chip_smoke.py's terrain
scene (initial, after --shapes-steps steps, terrain poses) in "fused_seq"
and "fused" with the joint prep outside and inside the kernel; on the
box pile in both modes; and on the three wide piles in both modes.

    python3 tools/emulate_fused_step_cpu.py [--chains 2] [--batch 5]
                                            [--shapes-steps 60]
                                            [--only zoo|settle|shapes|loco|bigpile ...]
    python3 tools/emulate_fused_step_cpu.py --library prepped [--batch 5]
                                            [--shapes-steps 60]
                                            [--late-steps 150]
                                            [--only-scene NAME|terrain|bigpile|wide ...]

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

GROUPS = ("zoo", "settle", "shapes", "loco", "bigpile")

SHIM = r"""
#pragma once
#include <barrier>
#include <memory>
#include <mutex>
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
// a warp: 32 of the block's threads with a barrier of their own, which
// __syncwarp and the warp intrinsics (all with the full mask) wait at
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bar;
inline unsigned g_xchg[8][32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
template <class T> T emu_exchange(T v, int src_lane) {
  unsigned w = threadIdx.x / 32, l = threadIdx.x % 32, u, r;
  static_assert(sizeof(T) == 4, "32-bit values only");
  __builtin_memcpy(&u, &v, 4);
  g_xchg[w][l] = u;
  __syncwarp();
  r = g_xchg[w][src_lane];
  __syncwarp();
  T out;
  __builtin_memcpy(&out, &r, 4);
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned w = threadIdx.x / 32, l = threadIdx.x % 32, bits = 0;
  g_xchg[w][l] = pred != 0;
  __syncwarp();
  for (int i = 0; i < 32; ++i) bits |= g_xchg[w][i] << i;
  __syncwarp();
  return bits;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d) {
  int l = threadIdx.x % 32;
  return emu_exchange(v, l >= (int)d ? l - (int)d : l);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned d) {
  int l = threadIdx.x % 32;
  return emu_exchange(v, l + (int)d < 32 ? l + (int)d : l);
}
// __reduce_min_sync / __reduce_max_sync: every lane's value, exchanged
template <class F> int emu_reduce(int v, F f) {
  unsigned w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_xchg[w][l] = (unsigned)v;
  __syncwarp();
  int r = (int)g_xchg[w][0];
  for (int i = 1; i < 32; ++i) r = f(r, (int)g_xchg[w][i]);
  __syncwarp();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  return emu_reduce(v, [](int a, int b) { return a < b ? a : b; });
}
inline int __reduce_max_sync(unsigned, int v) {
  return emu_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// named barriers (bar.sync id, n): one std::barrier of n threads per id and
// block, made by the first thread to arrive
inline std::mutex g_named_mu;
inline std::unique_ptr<std::barrier<>> g_named[16];
inline void emu_bar_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lk(g_named_mu);
    if (!g_named[id]) g_named[id] = std::make_unique<std::barrier<>>(n);
    b = g_named[id].get();
  }
  b->arrive_and_wait();
}
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
    g_warp_bar.clear();
    for (int w = 0; w < threads / 32; ++w)
      g_warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    for (auto& nb : g_named) nb.reset();
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=]() { threadIdx.x = t; k(args...); });
    for (auto& th : ts) th.join();
  }
}
"""

# the kernel's one named barrier, as the emulation runs it
NAMED_BARRIER = ('asm volatile("bar.sync %0, %1;" : : "r"(id + 1), '
                 '"r"(32 * warps) : "memory");')


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
    if src.count(NAMED_BARRIER) != 1:
        raise RuntimeError("csrc/fused_step.cu: its named barrier is not the "
                           "one line the emulation replaces")
    src = src.replace(NAMED_BARRIER, "emu_bar_sync(id + 1, 32 * warps);")
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
                   + ([p, i, i, p, i] if prepped else []) + [p] * 9
                   + [i, i, i, p])
    return fn


# launch geometries the emulation runs besides the wrapper's plan for its
# batch (which at a few envs is one env on eight warps): envs packed one warp
# each, the last block part empty, and two-warp teams behind named barriers
FORCED_PLANS = ((3, 1), (2, 2))


def plans(tab, batch):
    """The wrapper's launch plan for `batch` envs and FORCED_PLANS."""
    block_w, env_w = tab.shared_layout()
    out = [tab.launch_plan(batch)]
    for e, w in FORCED_PLANS:
        out.append(fs.LaunchPlan(
            envs=e, warps=w, threads=32 * e * w, blocks=-(-batch // e),
            smem_bytes=4 * (block_w + e * env_w), env_bytes=4 * env_w,
            block_bytes=4 * block_w))
    return out


def compare(launch, scene, state, dt, mode=None, prep_in_kernel=False):
    """Largest differences, emulated kernel vs plain version, one solve, for
    each launch geometry of `plans`: the averaged solve with joint prep in
    the kernel (`mode` None, the shapes library), or "fused_seq" / "fused"
    on prepared joint rows (the prepped library; "fused" with
    `prep_in_kernel` preps them in the kernel). A heightfield scene's
    terrain rows are passed in prepared."""
    tab = fs.fused_tables(scene, "cpu")
    dt32 = np.float32(dt)
    w = world_colliders(scene, state.pos, state.rot)
    b = integrate_forces(scene, state, float(dt32))
    ctl = controls_pack(scene, state.controls, dt32)
    passed = terrain_inputs(scene, w, b, dt32)
    inv_dt = float(np.float32(1.0) / dt32)
    B, P = b.v.shape[0], tab.num_rows
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
    vw, pimp, plive = fs._fused_core(
        tab, cs.ITERATIONS, 1.0, inv_dt, torch.cat([b.v, b.w], -1),
        b.inv_mass, b.inv_inertia, b.pos_cog, b.rot, ctl, w.a, w.b, w.rot,
        joint_tables=tables, sequential=mode == "fused_seq", passed=passed)

    def bits(x):
        return x.contiguous().view(torch.int32)

    out = dict(live_rows=int((plive != 0).sum()), plans={})
    for plan in plans(tab, B):
        v, wv = torch.empty_like(b.v), torch.empty_like(b.w)
        imp = torch.empty((B, P, 4))
        live = torch.empty((B, P), dtype=torch.uint8)
        # scratch filled with a value no result may show
        pts, rdelta = (torch.full(sh, -7777.0)
                       for sh in fs.scratch_shapes(tab, B))
        hull_shape = fs.hull_scratch_shape(tab, B, plan.warps)
        hull = (torch.full(hull_shape, -7777.0) if hull_shape is not None
                else None)
        err = launch(
            (ctypes.c_int * len(dims))(*dims), 1.0, inv_dt, *ins, *extra,
            tab.itab.data_ptr(), tab.ftab.data_ptr(), pts.data_ptr(),
            rdelta.data_ptr(), hull.data_ptr() if hull is not None else None,
            v.data_ptr(), wv.data_ptr(), imp.data_ptr(),
            live.data_ptr(), plan.envs, plan.warps, plan.smem_bytes, None)
        if err:
            raise RuntimeError(f"emulated launch returned {err}")
        out["plans"][f"E{plan.envs}W{plan.warps}"] = dict(
            err_v=float((v - vw[..., :3]).abs().max()),
            err_w=float((wv - vw[..., 3:]).abs().max()),
            err_imp=float((imp - pimp).abs().max()),
            # floats whose bits differ (a zero of the other sign counts)
            bits_differ=int((bits(v) != bits(vw[..., :3])).sum()
                            + (bits(wv) != bits(vw[..., 3:])).sum()
                            + (bits(imp) != bits(pimp)).sum()),
            live_mismatch=int((live != plive).sum()))
    out["bits_differ"] = sum(p["bits_differ"] for p in out["plans"].values())
    return out


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


def bigpile_main(launch, args, modes=(None,)):
    """chip_smoke.py's 1,081-row box pile, initial and after --shapes-steps
    steps, in each of `modes` (compare's `mode`)."""
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode="fused")
    scene = cs.bigpile_scene("cpu")
    st = cs.zoo_initial_state(scene, args.batch, 0)
    states = {"bigpile_initial": st}
    for _ in range(args.shapes_steps):
        st, _info = physics_step(scene, st, settings, cs.BIGPILE_DT)
    states[f"bigpile_after_{args.shapes_steps}_steps"] = st
    for name, st in states.items():
        for mode in modes:
            print(json.dumps({"scene": name, "mode": mode, **compare(
                launch, scene, st, cs.BIGPILE_DT, mode)}), flush=True)


def prepped_main(args):
    """The prepped library on the six golden scenes, both modes, on the
    terrain scene, the box pile and the wide piles."""
    launch = build("prepped")
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode="fused")
    for name in args.only_scene or cs.GOLDEN_SCENES + ("terrain", "bigpile",
                                                       "wide"):
        if name == "wide":
            for n in cs.WIDE_PILES:
                scene = cs.wide_pile_scene(n, "cpu")
                st = cs.pile_poses(scene, 4 * args.batch, 0)
                for mode in ("fused_seq", "fused"):
                    print(json.dumps({"scene": f"wide_{n}_poses",
                                      "mode": mode, **compare(
                                          launch, scene, st, cs.SETTLE_DT,
                                          mode)}), flush=True)
            continue
        if name == "terrain":
            terrain_main(launch, args)
            continue
        if name == "bigpile":
            bigpile_main(launch, args, ("fused_seq", "fused"))
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
    ap.add_argument("--only-scene",
                    choices=cs.GOLDEN_SCENES + ("terrain", "bigpile", "wide"),
                    action="append",
                    help="with --library prepped: only these golden scenes, "
                         "the terrain scene, the box pile or the wide piles")
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
        wides = [(f"wide_{n}_poses", cs.wide_pile_scene(n, "cpu"))
                 for n in cs.WIDE_PILES]
        for name, scene, st in [
                (n, w, cs.pile_poses(w, 4 * args.batch, 0))
                for n, w in wides] + [
                ("settle_initial", settle,
                 cs.settle_initial_state(settle, args.batch, 0)),
                ("settle_hull_poses", settle,
                 cs.settle_hull_poses(settle, 4 * args.batch, 0)),
                ("pile_poses", pile, cs.pile_poses(pile, 2 * args.batch, 0))]:
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
    if "bigpile" in groups:
        bigpile_main(launch, args)
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
