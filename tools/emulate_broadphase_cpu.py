"""Run csrc/broadphase.cu on the CPU and hold its three kernels against their
plain versions, integer for integer.

A machine without nvcc cannot build the broadphase kernels. This script
compiles the same source with g++ through the CUDA shim of
tools/emulate_fused_step_cpu.py (every CUDA thread of a block a
std::thread, __syncthreads a barrier of the block, the warp intrinsics a
barrier of the warp), extended with what the broadphase kernels use: 2-D and
3-D grids (blocks run one after another, in a seeded random order),
static shared arrays (one copy, as blocks do not overlap), vector types,
__any_sync and the SM count the overlap matrix sizes its column chunks by. Shared memory starts filled with 0x5a and every
output with a sentinel, so a byte or slot a kernel fails to write shows.

Each case of chip_smoke.BROADPHASE_CASES (the cases chip_smoke.py holds
on the card) makes seeded random colliders (random boxes, a broad static
ground, colliders that share a body, statics at the first, a middle and the
last index, force fields and triggers, rows with more than K hits) and runs
the overlap matrix, the K-select and the sort-and-sweep kernel against
`aabb_overlap_matrix_plain`, `kselect_broadphase_plain` and
`sap_sweep_plain`. The overlap matrix runs under two SM counts: 1 (whole
rows staged where C <= 1536) and 132 (an H100: at small batches the columns
come in chunks of 256 to 1024). The cases cover C in {1, 31, 130, 600,
1025, 2100} (600 and 2100 past a column chunk of both kernels), B in {1,
3}, K in {1, 8, 20} (20: one warp walks a row, past what the K-select's and
the sweep's slices buffer), num_phases in {1, 4}, and a C of 1025 that is
half statics (the K-select's static list spans chunks). Then each case of
chip_smoke.SWEEP_CASES runs the sweep alone: input handed over unsorted,
NaN and +-inf coordinates and inverted boxes, windows 1 to 9 (past C),
rows whose window overflows, K 20 and 80.

    python3 tools/emulate_broadphase_cpu.py [--small]

--small runs the cases the test file runs (C up to 600; every sweep case
is that small). Prints one JSON line per case and exits non-zero on any
difference. Needs g++ with C++20; writes only under
<repo>/build/emulate_broadphase/.
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from emulate_fused_step_cpu import SHIM  # noqa: E402
from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk  # noqa: E402
from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks  # noqa: E402
from dxk_tpu_torch.ops.kernels import sap_broadphase as sp  # noqa: E402

# what the broadphase kernels use beyond the fused kernel's shim
SHIM_EXTRA = r"""
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <climits>
#include <cstring>
#include <random>
using std::max;
using std::min;
#undef __shared__
#define __shared__ static
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline int __float_as_int(float x) {
  int u;
  __builtin_memcpy(&u, &x, 4);
  return u;
}
inline float __int_as_float(int x) {
  float u;
  __builtin_memcpy(&u, &x, 4);
  return u;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int g_emu_sms = 132;
extern "C" void emu_set_sms(int n) { g_emu_sms = n; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = g_emu_sms;
  return 0;
}
template <class K, class... A>
void emu_launch3(dim3 grid, dim3 block, int smem_bytes, K k, A... args) {
  if (block.x > 256) throw 1;  // the shim's warp exchange holds 8 warps
  std::vector<float4> sm(smem_bytes / 16 + 2);
  blockDim.x = block.x;
  blockDim.y = blockDim.z = 1;
  // the blocks in a seeded random order, as a card gives no order: a
  // write past a block's range then survives as often as not
  std::vector<dim3> order;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) order.emplace_back(x, y, z);
  std::mt19937 rng(12345);
  std::shuffle(order.begin(), order.end(), rng);
  for (const dim3& blk : order) {
    std::memset(sm.data(), 0x5a, sm.size() * sizeof(float4));
    g_smem = reinterpret_cast<float*>(sm.data());
    blockIdx.x = blk.x;
    blockIdx.y = blk.y;
    blockIdx.z = blk.z;
    std::barrier<> bar(block.x);
    g_bar = &bar;
    g_warp_bar.clear();
    for (unsigned w = 0; w < block.x / 32; ++w)
      g_warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([=]() { threadIdx.x = t; k(args...); });
    for (auto& th : ts) th.join();
  }
}
"""

OUT_DIR = os.path.join(ROOT, "build", "emulate_broadphase")
SENTINEL = -7777


def build():
    """g++ build of csrc/broadphase.cu; returns the ctypes library."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = open(os.path.join(ROOT, "dxk_tpu_torch", "ops", "kernels", "csrc",
                            "broadphase.cu")).read()
    src, n = re.subn(r"(\w+)<<<([^,]*), ([^,]*), ([^,]*), [^>]*>>>\(",
                     r"emu_launch3(\2, \3, \4, \1, ", src)
    if n != 3:
        raise RuntimeError(f"csrc/broadphase.cu: expected 3 launches, "
                           f"found {n}")
    # the kernels' dynamic shared memory: the launch's buffer
    for extern, ptr in (("extern __shared__ float4 ov_smem[];",
                         "float4* ov_smem = (float4*)g_smem;"),
                        ("extern __shared__ int ks_hits[];",
                         "int* ks_hits = (int*)g_smem;"),
                        ("extern __shared__ int sap_smem[];",
                         "int* sap_smem = (int*)g_smem;")):
        if src.count(extern) != 1:
            raise RuntimeError(f"csrc/broadphase.cu: no single line "
                               f"'{extern}' to replace")
        src = src.replace(extern, ptr)
    with open(os.path.join(OUT_DIR, "cuda_runtime.h"), "w") as f:
        f.write(SHIM + SHIM_EXTRA)
    with open(os.path.join(OUT_DIR, "broadphase.cpp"), "w") as f:
        f.write(src)
    lib = os.path.join(OUT_DIR, "libbroadphase_emu.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-Wno-unknown-pragmas", "-I", OUT_DIR, "-o", lib,
                    os.path.join(OUT_DIR, "broadphase.cpp"), "-lpthread"],
                   check=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.dxk_overlap_matrix_launch.restype = i
    dll.dxk_overlap_matrix_launch.argtypes = [i, i, p, p, p, p]
    dll.dxk_kselect_launch.restype = i
    dll.dxk_kselect_launch.argtypes = [i, i, i, i] + [p] * 8 + [p]
    dll.dxk_sap_launch.restype = i
    dll.dxk_sap_launch.argtypes = [i, i, i, i, i] + [p] * 9 + [p]
    dll.emu_set_sms.argtypes = [i]
    return dll


def run_overlap(dll, mn, mx):
    B, C = mn.shape[:2]
    out = torch.full((B, C, C), 7, dtype=torch.int8)
    err = dll.dxk_overlap_matrix_launch(B, C, mn.data_ptr(), mx.data_ptr(),
                                        out.data_ptr(), None)
    if err:
        raise RuntimeError(f"emulated overlap launch returned {err}")
    return out


def run_kselect(dll, mn, mx, body, owner, ctype, nph, K):
    B, C = mn.shape[:2]
    idx = torch.full((B, C, K), SENTINEL, dtype=torch.int32)
    cls = torch.full((B, C, K), SENTINEL, dtype=torch.int32)
    cnt = torch.full((B, C), SENTINEL, dtype=torch.int32)
    err = dll.dxk_kselect_launch(
        B, C, K, nph, mn.data_ptr(), mx.data_ptr(), body.data_ptr(),
        owner.data_ptr(), ctype.data_ptr(), idx.data_ptr(), cls.data_ptr(),
        cnt.data_ptr(), None)
    if err:
        raise RuntimeError(f"emulated K-select launch returned {err}")
    return idx, cls, cnt


def run_sap(dll, mn_s, mx_s, body_s, owner_s, ctype_s, nph, K, window):
    B, C = mn_s.shape[:2]
    outs = [torch.full((B, C, K), SENTINEL, dtype=torch.int32),
            torch.full((B, C, K), SENTINEL, dtype=torch.int32),
            torch.full((B, C), SENTINEL, dtype=torch.int32),
            torch.full((B, C), SENTINEL, dtype=torch.int32)]
    err = dll.dxk_sap_launch(
        B, C, K, nph, window, mn_s.data_ptr(), mx_s.data_ptr(),
        body_s.data_ptr(), owner_s.data_ptr(), ctype_s.data_ptr(),
        *[o.data_ptr() for o in outs], None)
    if err:
        raise RuntimeError(f"emulated sweep launch returned {err}")
    return tuple(outs)


def differ(got, want):
    """Entries that differ, summed over the outputs."""
    return sum(int((g.long() != w.long()).sum()) for g, w in zip(got, want))


def check_case(dll, case, sms=(1, 132)):
    """All three kernels on one case of chip_smoke.BROADPHASE_CASES; returns
    a dict with the entries that differ per kernel (0 when they hold)."""
    seed, B, C, K, nph, statics, share, window = case
    mn, mx, body, owner, ctype = cs.broadphase_colliders(seed, B, C, statics,
                                                         share)
    out = dict(seed=seed, B=B, C=C, K=K, num_phases=nph, window=window,
               statics=int((owner == 1).sum()))
    want = bk.aabb_overlap_matrix_plain(mn, mx)
    for n in sms:
        dll.emu_set_sms(n)
        out[f"overlap_sms{n}"] = differ((run_overlap(dll, mn, mx),), (want,))
    got = run_kselect(dll, mn, mx, body, owner, ctype, nph, K)
    want = ks.kselect_broadphase_plain(mn, mx, body, owner, ctype, nph, K)
    out["kselect"] = differ(got, want)
    out["rows_over_k"] = int((want[2] > K).sum())
    out["hits"] = int(want[2].sum())
    broad = (0,) if int(owner[0]) == 1 else ()
    _order, *sargs = sp.sort_for_sweep(mn, mx, body, owner, ctype, broad)
    got = run_sap(dll, *sargs, nph, K, window)
    want = sp.sap_sweep_plain(*sargs, nph, K, window)
    out["sap"] = differ(got, want)
    return out


def check_sweep_case(dll, case):
    """The sort-and-sweep kernel alone on one case of chip_smoke.SWEEP_CASES
    (unsorted input, NaN and +-inf, windows past C); returns what the case
    exercises and the entries that differ (0 when it holds)."""
    sargs = cs.sweep_case_inputs(case)
    want = sp.sap_sweep_plain(*sargs)
    out = cs.sweep_case_summary(case, sargs, want[2], want[3])
    out["sap"] = differ(run_sap(dll, *sargs), want)
    return out


def failures(result):
    """Entries that differ in one check_case or check_sweep_case result."""
    return sum(v for k, v in result.items()
               if k.startswith(("overlap", "kselect", "sap")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="only the cases of the test file (C up to 600)")
    args = ap.parse_args()
    cases = cs.BROADPHASE_CASES[:cs.BROADPHASE_SMALL_CASES] if args.small \
        else cs.BROADPHASE_CASES
    dll = build()
    bad = 0
    for case in cases:
        r = check_case(dll, case)
        print(json.dumps(r), flush=True)
        bad += failures(r)
    for case in cs.SWEEP_CASES:
        r = check_sweep_case(dll, case)
        print(json.dumps(r), flush=True)
        bad += failures(r)
    if bad:
        raise SystemExit(f"{bad} entries differ from the plain versions")
    print(json.dumps({"ok": True,
                      "cases": len(cases) + len(cs.SWEEP_CASES)}))


if __name__ == "__main__":
    main()
