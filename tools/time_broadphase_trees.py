"""Time the three broadphase kernels of one or more source trees on the GPU,
each tree in a process of its own, so two versions of csrc/broadphase.cu
can be compared in one call on one card (run them in turns: parent,
change, change, parent).

Each TREE is a directory holding a `dxk_tpu_torch/` package (for example an
unpacked `git archive <commit> dxk_tpu_torch`). The inputs are made once,
by this checkout's package, and every tree's kernels get the same tensors:
chip_smoke.py's box stack (bench.py's 1k-box stack, 32 envs, C = 1025
colliders) rolled out --warm steps (default 60) on the reference step with
the table broadphase, its AABBs, the scene's body, owner and shape type
vectors, K and contact phases, and the sort-and-sweep's sorted inputs and
window; at B = 32 and at B = 1 (env 0). For each tree the script builds that
tree's csrc/broadphase.cu, holds each kernel's output against the tree's
plain version (chip_smoke.hold_kernels: equal integers, else it raises),
and times it: five runs of chip_smoke.time_ms over 50 back-to-back
launches (queued behind a spin of the card, CUDA events). One JSON line
per tree, kernel and batch: the five times in ms, their median, the card
and the tree's ptxas lines.

    python3 tools/time_broadphase_trees.py [--warm 60] TREE [TREE ...]
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS, REPS = 5, 50
INPUTS = os.path.join(ROOT, "build", "broadphase_tree_inputs.pt")


def make_inputs(warm):
    """The box stack's broadphase inputs after `warm` steps, saved to
    INPUTS (CPU tensors)."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    scenes = cs.box_scenes()
    settings = PhysicsSettings(num_rigid_solver_iterations=cs.ITERATIONS,
                               solver_mode="jacobi")
    st = cs.box_initial_state(scenes["table"], 0)
    for _ in range(warm):
        st, _info = physics_step(scenes["table"], st, settings, cs.BOX_DT)
    mn, mx = cs.aabbs(scenes["table"], st)
    ks_scene, sap_scene = scenes["kselect"], scenes["sap"]
    col = ks_scene.colliders
    _order, *sorted_in = sp.sort_for_sweep(
        mn, mx, col.body, col.owner_type, col.ctype, sap_scene.sap_broad)
    out = dict(mn=mn, mx=mx, body=col.body, owner=col.owner_type,
               ctype=col.ctype, sorted=sorted_in,
               nph=ks_scene.num_contact_phases, K=ks_scene.broadphase_k,
               window=sap_scene.sap_window, warm=warm)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({k: (v.cpu() if torch.is_tensor(v) else
                    [x.cpu() for x in v] if isinstance(v, list) else v)
                for k, v in out.items()}, INPUTS)


def time_tree(tree):
    sys.path.insert(0, tree)
    import torch
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    if not os.path.abspath(bk.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {bk.__file__}, not the tree's package")
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    bk.load_library(verbose=True)
    ptxas = [ln.strip() for ln in bk.BUILD_LOG.splitlines()
             if "Function properties" in ln or "Used" in ln
             or "spill" in ln]
    d = torch.load(INPUTS)
    full = {k: (v.cuda() if torch.is_tensor(v) else
                [x.cuda() for x in v] if isinstance(v, list) else v)
            for k, v in d.items()}
    for batch in (32, 1):
        mn, mx = full["mn"][:batch].contiguous(), full["mx"][:batch].contiguous()
        srt = [x[:batch].contiguous() for x in full["sorted"]]
        kargs = (mn, mx, full["body"], full["owner"], full["ctype"],
                 full["nph"], full["K"])
        sargs = (*srt, full["nph"], full["K"], full["window"])
        calls = {
            "aabb_overlap_matrix": dict(
                kernel=lambda: bk.aabb_overlap_matrix(mn, mx),
                plain=lambda: bk.aabb_overlap_matrix_plain(mn, mx)),
            "kselect_broadphase": dict(
                kernel=lambda: ks.kselect_broadphase(*kargs),
                plain=lambda: ks.kselect_broadphase_plain(*kargs)),
            "sap_broadphase": dict(
                kernel=lambda: sp.sap_sweep(*sargs),
                plain=lambda: sp.sap_sweep_plain(*sargs))}
        cs.hold_kernels(calls, f"{tree} B={batch}")
        for name, c in calls.items():
            for _ in range(3):
                c["kernel"]()
            times = [cs.time_ms(c["kernel"], REPS) for _ in range(RUNS)]
            print(json.dumps(dict(
                tree=tree, kernel=name, B=batch, C=int(mn.shape[1]),
                warm_steps=d["warm"], device=torch.cuda.get_device_name(0),
                ms=times, median=sorted(times)[RUNS // 2], ptxas=ptxas)),
                flush=True)


def main():
    args = sys.argv[1:]
    warm = 60
    if args[:1] == ["--warm"]:
        warm, args = int(args[1]), args[2:]
    if not args:
        raise SystemExit(__doc__)
    if len(args) == 2 and args[0] == "--one":
        time_tree(os.path.abspath(args[1]))
        return
    make_inputs(warm)
    for tree in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)


if __name__ == "__main__":
    main()
