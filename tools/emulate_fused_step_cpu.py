"""Run csrc/fused_step.cu on the CPU and hold it against the plain version.

A machine without nvcc cannot build the fused-step kernel. This script
compiles the same source with g++ instead: a small header maps the CUDA
keywords away, every CUDA thread of a block becomes a std::thread, and
__syncthreads() becomes a std::barrier, so the kernel's shared-memory
layout, indexing and per-type joint passes run as written (blocks one after
another). Built with -ffp-contract=off, like the card's -fmad=false. It
prints, per scene, the largest differences between the emulated kernel and
the plain version `_fused_core`: on the constraint zoo, on bench.py's
ragdoll settle (initial state and hull poses that send every hull recipe
down each of its branches), on the hull pile and on the locomotion scene.
sin/cos come from the C library, so scenes with the ragdoll (whose
cone-twist prep calls them) may differ by float rounding.

    python3 tools/emulate_fused_step_cpu.py [--chains 2] [--batch 5]

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
from dxk_tpu_torch.physics import controls_pack  # noqa: E402

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
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
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


def build():
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
    lib = os.path.join(out, "libfused_step_emu.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-Wno-unknown-pragmas", "-I", out,
                    "-o", lib, os.path.join(out, "fused_step.cpp"),
                    "-lpthread"], check=True)
    dll = ctypes.CDLL(lib)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.dxk_fused_step_launch.restype = i
    dll.dxk_fused_step_launch.argtypes = ([ctypes.POINTER(i), fl, fl]
                                          + [p] * 16 + [i, i, p])
    return dll


def compare(dll, scene, state, dt):
    """Largest differences, emulated kernel vs plain version, one solve."""
    tab = fs.fused_tables(scene, "cpu")
    dt32 = np.float32(dt)
    w = world_colliders(scene, state.pos, state.rot)
    b = integrate_forces(scene, state, float(dt32))
    ctl = controls_pack(scene, state.controls, dt32)
    inv_dt = float(np.float32(1.0) / dt32)
    B, P = b.v.shape[0], tab.num_rows
    v, wv = torch.empty_like(b.v), torch.empty_like(b.w)
    imp = torch.empty((B, P, 4))
    live = torch.empty((B, P), dtype=torch.uint8)
    dims = tab.dims(B, cs.ITERATIONS)
    ins = [b.v, b.w, b.inv_mass, b.inv_inertia, b.pos_cog, b.rot, ctl, w.a,
           w.b, w.rot]
    ins = [x.contiguous() for x in ins]
    err = dll.dxk_fused_step_launch(
        (ctypes.c_int * len(dims))(*dims), 1.0, inv_dt,
        *[x.data_ptr() for x in ins], tab.itab.data_ptr(),
        tab.ftab.data_ptr(), v.data_ptr(), wv.data_ptr(), imp.data_ptr(),
        live.data_ptr(), tab.threads(), tab.shared_floats() * 4, None)
    if err:
        raise RuntimeError(f"emulated launch returned {err}")
    vw, pimp, plive = fs._fused_core(
        tab, cs.ITERATIONS, 1.0, inv_dt, torch.cat([b.v, b.w], -1),
        b.inv_mass, b.inv_inertia, b.pos_cog, b.rot, ctl, w.a, w.b, w.rot)
    return dict(err_v=float((v - vw[..., :3]).abs().max()),
                err_w=float((wv - vw[..., 3:]).abs().max()),
                err_imp=float((imp - pimp).abs().max()),
                live_mismatch=int((live != plive).sum()),
                live_rows=int((plive != 0).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--batch", type=int, default=5)
    args = ap.parse_args()
    dll = build()
    zoo = cs.zoo_scene(args.chains, device="cpu")
    for name, st in (
            ("zoo_initial", cs.zoo_initial_state(zoo, args.batch, 0)),
            ("zoo_limit_poses", cs.zoo_limit_state(zoo, args.batch, 0))):
        print(json.dumps({"scene": name, "chains": args.chains,
                          **compare(dll, zoo, st, cs.ZOO_DT)}), flush=True)
    settle = cs.settle_scene("cpu")
    pile = cs.pile_scene("cpu")
    for name, scene, st in (
            ("settle_initial", settle,
             cs.settle_initial_state(settle, args.batch, 0)),
            ("settle_hull_poses", settle,
             cs.settle_hull_poses(settle, 4 * args.batch, 0)),
            ("pile_poses", pile, cs.pile_poses(pile, 2 * args.batch, 0))):
        print(json.dumps({"scene": name, **compare(dll, scene, st,
                                                   cs.SETTLE_DT)}),
              flush=True)
    from dxk_tpu_torch.envs.loco_env import DT, LocoEnv
    env = LocoEnv(solver_mode="fused", device="cpu", enable_pokes=False)
    gen = torch.Generator().manual_seed(0)
    st, _obs = env.reset(args.batch)
    for _ in range(20):
        act = torch.rand((args.batch, 27), generator=gen) * 2 - 1
        st, _obs, _r, _d = env.step(st, act, gen)
    print(json.dumps({"scene": "loco_after_20_steps",
                      **compare(dll, env.scene, st.physics, DT)}), flush=True)


if __name__ == "__main__":
    main()
