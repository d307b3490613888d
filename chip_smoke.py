"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls,
after building the hand-written CUDA kernels from the sources in this
checkout and holding each against its plain PyTorch version on the card:
  - a batch of ragdoll locomotion environments stepped in lockstep by the
    trained walking policy (the fused step);
  - bench.py's constraint zoo (BASELINE config 2: 16 chains with one link
    per joint type, 256 and 4096 envs) on the fused step;
  - bench.py's ragdoll drop-and-settle with its convex-hull debris
    (BASELINE config 3, 256 and 4096 envs) on the fused step;
  - the golden mixed-shape drop (a hull, a cylinder and a capsule onto a
    box ramp) and sphere bounce of tests/test_golden_trajectories.py, 256
    and 4096 envs x 1000 steps, on the fused step;
  - the golden fidelity row: the six golden scenes at one env x 1000 steps
    on the sequential fused step ("fused_seq");
  - BASELINE config 4's heightfield terrain under config 3's ragdoll and
    four pieces of shape debris, 256 and 4096 envs, on the fused step with
    the terrain rows prepared outside the kernel and passed in;
  - bench.py's 1k-box stack (64 towers of 16 boxes, 32 envs) on the
    reference step under each of the three broadphases (table, K-select,
    sort-and-sweep).

    python3 chip_smoke.py                 # full run
    python3 chip_smoke.py --steps 120     # shorter serve phase

Phases, one JSON line each; any failure raises and the exit code is non-zero:
  device     a CUDA device is present; its name and power limit
  build      nvcc compiles csrc/fused_step.cu three times (without and with
             the sphere and cylinder recipes, and the prepped build: joint
             and contact rows prepared outside the kernel, the sequential
             solve) and csrc/broadphase.cu, all side by side
  kernels    fused-step kernel vs plain version on rolled-out states, times,
             bound
  serve      policy rollout and zero-action rollout, checks on the results
  zoo        fused-step kernel vs plain version on zoo states (initial, after
             60 steps, limit poses), live joint limits and motors by type,
             then 600 steps at each batch: launches, finiteness, anchor gaps,
             body-steps/s, the kernel's times and bound
  settle     fused-step kernel vs plain version on settle states (initial,
             after 60 steps, hull poses), on a three-hull pile and after each
             main-path run; live rows of the hull recipes and their branches;
             the pile stepped 120 steps; then 600 steps at each batch:
             launches, finiteness, the debris' height, body-steps/s, the
             kernel's times and bound
  shapes     fused-step kernel vs plain version on the two golden scenes
             (initial, after 60 and 150 steps, after each main-path run) and
             on a sphere and cylinder check pile; live rows of the nine
             sphere and cylinder recipes and their branches; then 1000 steps
             of each scene at each batch: launches, finiteness, the lowest
             point of any body, body-steps/s, the kernel's times and bound
  fidelity   the prepped kernel vs its plain version on the six golden
             scenes in both modes, then each scene 1000 fused_seq steps from
             its golden start: launches, deviation from tests/golden/,
             steps/s, the kernel's times at 4096 envs
  terrain    the prepped kernel with prep-passed terrain rows vs its plain
             version in both modes (initial, after 60 steps, terrain poses);
             live terrain rows by shape and window and live safety
             contacts; then 600 steps at each batch: launches, finiteness,
             no body's centre deep below the terrain, body-steps/s, host and
             device ms and launches per step, the kernel's times and bound,
             and the fused_seq kernel's times
  box_stack  the three broadphase kernels vs their plain versions (equal
             integers) on the initial and a rolled-out state, pair sets equal
             across the broadphases, then the box stack stepped in each
             broadphase: launches per step, overflow, agreement with the
             table broadphase, body-steps/s
The line before the last is the card's name and power limit; the line before
that lists every kernel (the fused step once per phase that runs it: loco,
zoo, settle, shapes, fidelity and terrain; then the three broadphase
kernels). The last line is {"ok": true, "device": {...}}.

Imports torch and the port only; nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

NUM_ENVS = 4096
RAGGED_ENVS = 1000
WARM_STEPS = 60          # rollout before the kernel comparison
ITERATIONS = 30
KERNEL_TOL = 1e-5
TOL_REASON = ("kernel and plain version run the same float32 operations "
              "(-fmad=false); they differ by the order of the per-body "
              "delta sums (fixed lists vs index_add_ atomics) and by libm "
              "sin/cos ulps, amplified over 30 solver iterations; impulses "
              "are held to the same tolerance relative to the largest one")

# H100 SXM data-sheet peaks: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float operations (add, sub, mul, div, sqrt; no compares, selects, min/max,
# abs or negations), counted by hand from csrc/fused_step.cu
FLOPS_CONTACT_POINT = 124        # friction + normal update of one live point
FLOPS_ROW_DELTA = 24             # 12 subtractions + 12 adds into body sums
FLOPS_BODY_APPLY = 3             # per body component and pass: scale, add
FLOPS_PREP_POINT = 183
POINT_FIELDS_PASSED = 28         # floats read per passed-in point
# per row of the recipes whose work does not depend on the data, by recipe id
# (fused_step.RECIPE_NAMES): capsule-capsule, capsule-box, box-box,
# sphere-sphere, sphere-capsule, sphere-cylinder, sphere-box, capsule-cylinder
FLOPS_NARROW = {0: 170, 1: 380, 2: 1600, 6: 35, 7: 60, 8: 110, 9: 125,
                11: 220}
# recipes whose work follows the hull sizes and this run's data (see
# recipe_flops): capsule-hull and sphere-hull per row and per distance-GJK
# iteration (plus 5 * V for the hull support), the deep branch per face
# plane; a polytope side's vertex transform, per face and vertex of the face
# scans, per edge pair and vertex of the edge scan, the clip per loop point
# and slot; cylinder-hull per row, per candidate axis and vertex, per descent
# round, per GJK iteration; cylinder-box and cylinder-cylinder per row and
# per round of their alternating projections
FLOPS_CAPSULE_HULL = dict(row=210, gjk_iteration=460, deep=45, deep_plane=7)
FLOPS_SPHERE_HULL = dict(row=130, gjk_iteration=460, deep=25, deep_plane=7)
FLOPS_CYLINDER_HULL = dict(row=60, vertex=33, axis=45, axis_vertex=5,
                           descent_round=60, descent_vertex=10,
                           gjk_iteration=480)
FLOPS_CYLINDER_BOX = dict(row=850, projection_round=30)
FLOPS_CYLINDER_CYLINDER = dict(row=400, projection_round=60)
FLOPS_POLYTOPE = dict(vertex=33, face=35, face_vertex=5, edge_pair=60,
                      edge_pair_vertex=5, clip_point_slot=25, reduce_slot=160)
# per joint type: (prep once a step, solve per iteration incl. the 24
# operations of its velocity deltas), all counted the same way
FLOPS_JOINT = {"distance": (143, 60 + 24), "ball": (266, 156 + 24),
               "fixed": (336, 258 + 24), "hinge": (600, 275 + 24),
               "cone_twist": (900, 257 + 24), "slider": (420, 323 + 24)}
# prep rows that hold a joint's limit and motor flags, by type
# (batched_solver.py layouts)
JOINT_FLAG_ROWS = {"hinge": {"limit": 40, "motor": 41},
                   "cone_twist": {"swing_limit": 45, "twist_limit": 48,
                                  "swing_motor": 52, "twist_motor": 56},
                   "slider": {"limit": 51, "motor": 55}}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def build_phase():
    """The CUDA sources, one nvcc each, started together: csrc/fused_step.cu
    three times (without and with the sphere and cylinder recipes, and the
    build that takes prepared joint rows and solves sequentially) and
    csrc/broadphase.cu."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs

    builds = {
        "fused_step": (lambda: fs.load_library(verbose=True),
                       lambda: fs.BUILD_LOGS["base"], fs.NVCC_FLAGS),
        "fused_step_shapes": (
            lambda: fs.load_library(verbose=True, shapes=True),
            lambda: fs.BUILD_LOGS["shapes"], fs.NVCC_FLAGS + fs.SHAPES_FLAGS),
        "fused_step_prepped": (
            lambda: fs.load_library(verbose=True, prepped=True),
            lambda: fs.BUILD_LOGS["prepped"],
            fs.NVCC_FLAGS + fs.PREPPED_FLAGS),
        "broadphase": (lambda: bk.load_library(verbose=True),
                       lambda: bk.BUILD_LOG, bk.NVCC_FLAGS)}

    def timed(name):
        t0 = time.perf_counter()
        builds[name][0]()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds)))
    out = {}
    for name, (_load, log, flags) in builds.items():
        # each kernel's registers, and any stack frame or spill at all
        ptxas = [ln.strip() for ln in log().splitlines()
                 if "entry function" in ln or "Used" in ln
                 or ("spill" in ln and "0 bytes stack frame, 0 bytes spill "
                     "stores, 0 bytes spill loads" not in ln)]
        out[name] = dict(seconds=round(secs[name], 2), flags=" ".join(flags),
                         ptxas=ptxas)
    emit("build", **out)


def load_policy(env):
    from dxk_tpu_torch.models.policy import ActorCritic
    from dxk_tpu_torch.utils.convert import policy_state_dict_from_npz
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dxk_tpu_torch", "assets", "walk_r5_policy.npz")
    net = ActorCritic(action_dim=27, obs_dim=env.obs_size)
    net.load_state_dict(policy_state_dict_from_npz(path))
    return net.to(env.device).eval()


def kernel_inputs(scene, state, dt, prep_in_kernel=True):
    """What physics_step hands the fused step for `state`, with the joint
    rows prepared in the kernel (the controls pack) or outside it (the
    packed tables of ops/solver.py's preps), and the prepared heightfield
    rows of a scene with terrain (else None)."""
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import joint_inputs, terrain_inputs
    dt32 = np.float32(dt)
    wcol = world_colliders(scene, state.pos, state.rot)
    bodies = integrate_forces(scene, state, float(dt32))
    joints = joint_inputs(scene, bodies, state.controls, dt32,
                          prep_in_kernel)
    return (bodies, wcol, joints, float(np.float32(1.0) / dt32),
            terrain_inputs(scene, wcol, bodies, dt32))


def time_ms(fn, reps):
    """Device time per call of `fn` over `reps` back-to-back calls. The
    card first spins for ~25 ms, so that the host has queued the calls
    before the start event runs: a kernel shorter than its wrapper's host
    cost is then timed on the device, not at the host's launch rate."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def polytope_flops(nv_a, nf_a, ne_a, nv_b, nf_b, ne_b, lm):
    """Operations of one box-hull or hull-hull row (csrc/fused_step.cu,
    polytope), counted by hand: both sides' vertices, the two face scans,
    the edge scan and a face-case clip of the incident loop on 2 lm slots."""
    f, nv = FLOPS_POLYTOPE, nv_a + nv_b
    return (f["vertex"] * nv + (nf_a + nf_b) * (f["face"] + f["face_vertex"] * nv)
            + ne_a * ne_b * (f["edge_pair"] + f["edge_pair_vertex"] * nv)
            + lm * 2 * lm * f["clip_point_slot"] + 2 * lm * f["reduce_slot"])


def recipe_flops(tab, branches, batch):
    """Operations of the rows of `batch` envs whose work follows the hull
    sizes and this run's data (fused_step.recipe_branches: GJK iterations,
    deep rows, projection rounds)."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    V, F, FU, LM, EU = tab.hull_dims
    rows = {}
    for m in tab.metas:
        if m["native"]:
            name = fs.RECIPE_NAMES[fs.CM_RECIPES[m["key"]]]
            rows[name] = rows.get(name, 0) + m["pg"]
    flops = 0
    for name, c, deep in (("capsule_hull", FLOPS_CAPSULE_HULL, "overlap"),
                          ("sphere_hull", FLOPS_SPHERE_HULL, "inside")):
        b = branches.get(name, {})
        flops += (batch * rows.get(name, 0) * c["row"]
                  + b.get("gjk_iterations", 0) * (c["gjk_iteration"] + 5 * V)
                  + b.get(deep, 0) * (c["deep"] + F * c["deep_plane"]))
    c = FLOPS_CYLINDER_HULL
    axes = FU + 1 + EU + V
    flops += batch * rows.get("cylinder_hull", 0) * (
        c["row"] + V * c["vertex"] + axes * (c["axis"] + V * c["axis_vertex"])
        + 8 * (c["descent_round"] + V * c["descent_vertex"]))
    flops += branches.get("cylinder_hull", {}).get("gjk_iterations", 0) * (
        c["gjk_iteration"] + 5 * V)
    for name, c in (("cylinder_box", FLOPS_CYLINDER_BOX),
                    ("cylinder_cylinder", FLOPS_CYLINDER_CYLINDER)):
        flops += (batch * rows.get(name, 0) * c["row"]
                  + branches.get(name, {}).get("projection_rounds", 0)
                  * c["projection_round"])
    flops += batch * rows.get("box_hull", 0) * polytope_flops(
        8, 6, 3, V, FU, EU, max(4, LM))
    flops += batch * rows.get("hull_hull", 0) * polytope_flops(
        V, FU, EU, V, FU, EU, LM)
    return flops


def bound_ms(tab, live, batch, data_work=0, prepped=False, sequential=False):
    """Least time the card could take for this call: the larger of compulsory
    bytes over the memory rate and counted operations over the float32 peak.
    The operation count follows this run's data: live pair rows and live
    manifold points only; `data_work` is the count of the rows whose work
    follows the data (recipe_flops). `prepped`: the joint rows are read
    from device memory instead of prepared in the kernel; `sequential`: the
    sequential solve, which has no velocity deltas to sum and apply. A
    scene's prep-passed contact points (heightfield rows) are read from
    device memory, and their prep is not the kernel's work."""
    nb, C, P = tab.num_bodies, tab.num_colliders, tab.num_rows
    floats_in = nb * (3 + 3 + 9 + 3 + 4) + C * 10 + (
        tab.joint_row_floats if prepped else tab.ctl_rows + 1) \
        + POINT_FIELDS_PASSED * tab.passed_points
    floats_out = nb * 6 + P * 4
    nbytes = batch * (4 * (floats_in + floats_out) + P) \
        + 4 * (tab.itab.numel() + tab.ftab.numel() + nb)
    lv = live.to(torch.int32)
    live_rows = int((lv != 0).sum())
    live_points = int(sum(((lv >> k) & 1).sum() for k in range(4)))
    n_passed = tab.passed_points // 4
    passed_points = int(sum(((lv[:, P - n_passed:] >> k) & 1).sum()
                            for k in range(4))) if n_passed else 0
    types = tab.itab[tab.ioffs[0]:tab.ioffs[0] + 8 * P].view(P, 8)[:, 0].tolist()
    narrow = sum(FLOPS_NARROW.get(t, 0) for t in types)
    counts = tab.joint_counts
    per_env_once = narrow + (0 if prepped else sum(
        n * FLOPS_JOINT[t][0] for t, n in counts.items()))
    passes = sum(n > 0 for n in counts.values()) + tab.num_phases
    if sequential:
        per_env_iter = sum(n * (FLOPS_JOINT[t][1] - FLOPS_ROW_DELTA)
                           for t, n in counts.items())
    else:
        per_env_iter = (sum(n * FLOPS_JOINT[t][1] for t, n in counts.items())
                        + passes * nb * 6 * FLOPS_BODY_APPLY)
    flops = (batch * (per_env_once + ITERATIONS * per_env_iter) + data_work
             + live_points * (FLOPS_PREP_POINT
                              + ITERATIONS * FLOPS_CONTACT_POINT)
             - passed_points * FLOPS_PREP_POINT
             + (0 if sequential else live_rows * ITERATIONS * FLOPS_ROW_DELTA))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            dict(bytes=nbytes, flops=flops, live_rows=live_rows,
                 live_points=live_points, live_passed_points=passed_points,
                 bytes_ms=t_bytes, ops_ms=t_ops))


def joint_flags(tab, bodies, ctl, inv_dt):
    """Joints whose limit or motor is on, by type, from the plain
    version's prep rows."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    inv_dt = torch.tensor(inv_dt, dtype=torch.float32, device=ctl.device)
    out = {}
    for jt in tab.joint_types:
        if jt.name not in JOINT_FLAG_ROWS:
            continue
        rows = fs._joint_rows(tab, jt, bodies.rot, bodies.pos_cog,
                              bodies.inv_inertia, bodies.inv_mass, ctl, inv_dt)
        out[jt.name] = {k: int((rows[r] > 0.5).sum())
                        for k, r in JOINT_FLAG_ROWS[jt.name].items()}
    return out


def compare_kernel(scene, state, batch, dt):
    """Kernel vs plain version on the card for the first `batch` envs of
    `state`: max abs differences after the solve and after one full step,
    live pair rows by recipe and live joint limits and motors by type."""
    from dxk_tpu_torch.ops.integrator import integrate_velocities
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    sub = state.replace(**{
        k: getattr(state, k)[:batch].contiguous()
        for k in ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                  "torque_acc")},
        controls=type(state.controls)(**{
            k: v[:batch].contiguous()
            for k, v in vars(state.controls).items()}))
    bodies, wcol, ctl, inv_dt, passed = kernel_inputs(scene, sub, dt)
    tab = fs.fused_tables(scene, state.pos.device)
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0)

    def run_kernel():
        return solver(bodies, wcol, ctl, inv_dt, passed)

    def run_plain():
        vw0 = torch.cat([bodies.v, bodies.w], dim=-1)
        return fs._fused_core(tab, ITERATIONS, 1.0, inv_dt, vw0,
                              bodies.inv_mass, bodies.inv_inertia,
                              bodies.pos_cog, bodies.rot, ctl, wcol.a, wcol.b,
                              wcol.rot, passed=passed)

    kv, kw, kimp, klive = run_kernel()
    torch.cuda.synchronize()
    pvw, pimp, plive = run_plain()
    torch.cuda.synchronize()
    err_v = float((kv - pvw[..., :3]).abs().max())
    err_w = float((kw - pvw[..., 3:]).abs().max())
    err_imp = float((kimp - pimp).abs().max())
    imp_scale = max(1.0, float(pimp.abs().max()))
    mask_mismatch = int((klive != plive).sum())
    # live pair rows of each contact recipe: a recipe with none would be held
    # against the plain version only through its hit/miss decision
    P = tab.num_rows
    types = tab.itab[tab.ioffs[0]:tab.ioffs[0] + fs.ROW_INTS * P].view(
        P, fs.ROW_INTS)[:, 0].to(klive.device)
    rows_live = (klive != 0).sum(dim=0)
    live_by_recipe = {name: int(rows_live[types == t].sum())
                      for t, name in fs.RECIPE_NAMES.items()
                      if bool((types == t).any())}
    dt = float(np.float32(dt))
    ks = integrate_velocities(scene, bodies.replace(v=kv, w=kw), sub, dt)
    ps = integrate_velocities(
        scene, bodies.replace(v=pvw[..., :3].contiguous(),
                                  w=pvw[..., 3:].contiguous()), sub, dt)
    err_pos = float((ks.pos - ps.pos).abs().max())
    err_rot = float((ks.rot - ps.rot).abs().max())
    finite = bool(torch.isfinite(kv).all() and torch.isfinite(kw).all()
                  and torch.isfinite(kimp).all())
    moved = float(torch.maximum((kv - bodies.v).abs().max(),
                                (kw - bodies.w).abs().max()))
    out = dict(batch=batch, solve_moved_velocities_by=moved, err_v=err_v,
               err_w=err_w, err_pos=err_pos, err_rot=err_rot, err_imp=err_imp,
               imp_scale=imp_scale,
               v_scale=max(1.0, float(pvw[..., :3].abs().max())),
               w_scale=max(1.0, float(pvw[..., 3:].abs().max())),
               mask_mismatch=mask_mismatch,
               finite=finite, live_rows_by_recipe=live_by_recipe,
               live_rows_per_env=float((klive != 0).sum()) / batch,
               joints_on=joint_flags(tab, bodies, ctl, inv_dt))
    if any(m["key"] in fs.BRANCH_RECIPES for m in tab.metas):
        out["branches"] = fs.recipe_branches(tab, wcol.a, wcol.b, wcol.rot)
    return out, run_kernel, run_plain, tab, klive


def hold_fused(c, relative=False):
    """Raise unless the fused kernel agreed with its plain version. With
    `relative`, velocities are held, like impulses, relative to the largest
    one (see SETTLE_TOL_REASON)."""
    vs, ws = (c["v_scale"], c["w_scale"]) if relative else (1.0, 1.0)
    worst = max(c["err_v"] / vs, c["err_w"] / ws, c["err_pos"], c["err_rot"],
                c["err_imp"] / c["imp_scale"])
    if not c["finite"] or c["mask_mismatch"] or not worst <= KERNEL_TOL:
        raise RuntimeError(f"fused_step kernel disagrees with its plain "
                           f"version: {c}")


def rollout(env, net, steps, seed):
    """`steps` env steps of all envs from reset; the policy acts, or zero
    actions when `net` is None. Returns the statistics of
    examples/eval_locomotion.py computed on the device."""
    from dxk_tpu_torch.models.policy import policy_apply
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    B = NUM_ENVS
    st, obs = env.reset(B)
    reset_pos = st.physics.pos[0].clone()
    alive = torch.ones(B, dtype=torch.bool, device=env.device)
    survived = torch.zeros(B, device=env.device)
    ret = torch.zeros(B, device=env.device)
    vx_sum = torch.zeros((), device=env.device)
    vx_n = torch.zeros((), device=env.device)
    # checks are accumulated on the device and read once after the loop, so
    # the timed loop has no host synchronisation of its own
    n_done = torch.zeros((), dtype=torch.int64, device=env.device)
    bad = torch.zeros((), dtype=torch.bool, device=env.device)
    off_reset = torch.zeros((), device=env.device)
    rmin = torch.full((), float("inf"), device=env.device)
    rmax = torch.full((), float("-inf"), device=env.device)
    zero_act = torch.zeros((B, 27), device=env.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        act = policy_apply(net, obs) if net is not None else zero_act
        st, obs, rew, done = env.step(st, act, gen)
        alive = alive & ~done
        survived += alive
        ret += rew * alive
        if t >= 120:                      # steady state: after the 2 s ramp
            vx = st.physics.lin_vel[:, env.torso_id, 0]
            vx_sum += (vx * alive).sum()
            vx_n += alive.sum()
        bad |= ~(torch.isfinite(obs).all() & torch.isfinite(rew).all())
        rmin = torch.minimum(rmin, rew.min())
        rmax = torch.maximum(rmax, rew.max())
        n_done += done.sum()
        dev = ((st.physics.pos - reset_pos).abs().amax(dim=(1, 2))
               + st.steps.abs())
        off_reset = torch.maximum(off_reset, torch.where(done, dev, 0.0).max())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rmin, rmax, n_done = float(rmin), float(rmax), int(n_done)
    if bool(bad):
        raise RuntimeError("non-finite observation or reward in the rollout")
    if float(off_reset) != 0.0:
        raise RuntimeError("an env whose done fired did not come back at the "
                           "reset pose")
    if not (0.0 <= rmin and rmax <= 4.0):
        raise RuntimeError(f"reward out of [0, 4]: min {rmin} max {rmax}")
    return dict(
        steps=steps, seconds=secs, env_steps_per_s=B * steps / secs,
        mean_survival_s=float(survived.mean()) / 60.0,
        survival_full_horizon_pct=100.0 * float(alive.float().mean()),
        mean_episode_return=float(ret.mean()),
        mean_forward_vx_steady=(float(vx_sum / vx_n) if float(vx_n) > 0
                                else 0.0),
        dones=n_done, reward_min=rmin, reward_max=rmax)


# ---------------------------------------------------------------------------
# the 1k-box stack on the reference step

DEVICE = "cuda"
BOX_TOWERS, BOX_PER_TOWER = 64, 16        # bench.py _box_towers(1024)
BOX_BATCH = 32                            # bench.py's on-chip box_batch
BOX_STEPS = 120
BOX_WARM = 60
BOX_DT = 1.0 / 120.0
BOX_MODES = ("table", "kselect", "sap")
BOX_PATH_TOL = 1e-4
BOX_PATH_TOL_REASON = ("the JAX package's own bound between broadphases "
                       "(tests/test_sap_broadphase.py, test_pallas_"
                       "broadphase.py): the pair sets are equal, the pair "
                       "rows are ordered differently, so per-body sums may "
                       "round differently")
# per-pair work of the broadphase kernels, for bound_ms: six float compares
# for the AABB test of every pair the placement rule admits; for every pair
# that overlaps, the class id (about 16 integer operations)
OPS_AABB_TEST = 6
OPS_CLASS = 16


def box_towers(builder):
    """bench.py's box stack: towers of unit boxes 1.001 apart, 3 m apart on
    a square grid, on a 200 x 2 x 200 ground box."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (200, 1, 200))
    side = int(np.ceil(np.sqrt(BOX_TOWERS)))
    for t in range(BOX_TOWERS):
        x, z = (t % side) * 3.0, (t // side) * 3.0
        for i in range(BOX_PER_TOWER):
            body = b.add_body(position=(x, 0.5 + 1.001 * i, z))
            b.add_box_collider(body, (0, 0, 0), (0.5, 0.5, 0.5))
    return b


def box_scenes():
    from dxk_tpu_torch.scene import SceneBuilder
    return {m: box_towers(SceneBuilder).finalize(
        max_narrow_pairs_per_group=512, contact_phases=4, broadphase=m,
        broadphase_k=8, device=DEVICE) for m in BOX_MODES}


def box_initial_state(scene, seed):
    """BOX_BATCH envs of the stack, each box moved by a seeded jitter of
    0.5 mm (std) in x and z, so the envs differ."""
    st = scene.initial_state(BOX_BATCH)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    jit = torch.randn((BOX_BATCH, scene.num_bodies - 1, 2), device=DEVICE,
                      generator=gen) * 5e-4
    pos = st.pos.clone()
    pos[:, 1:scene.num_bodies, 0] += jit[..., 0]
    pos[:, 1:scene.num_bodies, 2] += jit[..., 1]
    return st.replace(pos=pos)


def aabbs(scene, state):
    from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
    w = world_colliders(scene, state.pos, state.rot)
    mn, mx = collider_aabbs(scene, w)
    return mn.contiguous(), mx.contiguous()


def broadphase_calls(scenes, mn, mx):
    """For each broadphase kernel: (kernel call, plain call, library call or
    None, the bound's bytes and operations) on the main path's inputs."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    B, C = mn.shape[0], mn.shape[1]
    ks_scene, sap_scene = scenes["kselect"], scenes["sap"]
    col = ks_scene.colliders
    nph, K = ks_scene.num_contact_phases, ks_scene.broadphase_k
    order, mn_s, mx_s, body_s, owner_s, ctype_s = sp.sort_for_sweep(
        mn, mx, col.body, col.owner_type, col.ctype, sap_scene.sap_broad)
    W = sap_scene.sap_window
    kargs = (mn, mx, col.body, col.owner_type, col.ctype, nph, K)
    sargs = (mn_s, mx_s, body_s, owner_s, ctype_s, nph, K, W)

    # pairs the placement rules admit (data independent) and pairs that
    # overlap (this run's data), for the operation counts
    ov = bk.aabb_overlap_matrix_plain(mn, mx).bool()
    owner = col.owner_type
    rb = owner == 0
    st = owner == 1
    same = col.body[:, None] == col.body[None, :]
    ii = torch.arange(C, device=mn.device)
    upper = ii[None, :] > ii[:, None]
    k_admit = ((rb[:, None] & rb[None, :] & upper & ~same)
               | (rb[:, None] & st[None, :]))
    k_pairs = int(k_admit.sum()) * B
    k_hits = int((ov & k_admit).sum())
    s_idx, s_cls, s_cnt, _ = sp.sap_sweep_plain(*sargs)
    i0 = (ii // 128) * 128
    s_pairs = int(torch.clamp(torch.clamp(i0 + W * 128, max=C) - ii - 1,
                              min=0).sum()) * B
    s_hits = int(s_cnt.sum())
    f32 = 4
    return {
        "aabb_overlap_matrix": dict(
            kernel=lambda: bk.aabb_overlap_matrix(mn, mx),
            plain=lambda: bk.aabb_overlap_matrix_plain(mn, mx),
            bytes=B * C * 6 * f32 + B * C * C,
            ops=B * C * C * OPS_AABB_TEST,
            source="dxk_tpu_torch/ops/kernels/csrc/broadphase.cu",
            replaces="dxk_tpu/ops/pallas/broadphase_kernel.py:62"),
        "kselect_broadphase": dict(
            kernel=lambda: ks.kselect_broadphase(*kargs),
            plain=lambda: ks.kselect_broadphase_plain(*kargs),
            bytes=B * C * 6 * f32 + 3 * C * f32 + B * C * (2 * K + 1) * f32,
            ops=k_pairs * OPS_AABB_TEST + k_hits * OPS_CLASS,
            source="dxk_tpu_torch/ops/kernels/csrc/broadphase.cu",
            replaces="dxk_tpu/ops/pallas/kselect_broadphase.py:146"),
        "sap_broadphase": dict(
            kernel=lambda: sp.sap_sweep(*sargs),
            plain=lambda: sp.sap_sweep_plain(*sargs),
            bytes=B * C * (6 + 3) * f32 + B * C * (2 * K + 2) * f32,
            ops=s_pairs * OPS_AABB_TEST + s_hits * OPS_CLASS,
            source="dxk_tpu_torch/ops/kernels/csrc/broadphase.cu",
            replaces="dxk_tpu/ops/pallas/sap_broadphase.py:202"),
    }


def hold_kernels(calls, where):
    """Each kernel's outputs equal its plain version's, integer for
    integer; raises on any difference."""
    out = {}
    for name, c in calls.items():
        got = c["kernel"]()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        want = c["plain"]()
        want = want if isinstance(want, tuple) else (want,)
        diff = [int((g.long() - w.long()).abs().max()) if g.numel() else 0
                for g, w in zip(got, want)]
        shapes_ok = all(g.shape == w.shape and g.dtype == w.dtype
                        for g, w in zip(got, want))
        if not shapes_ok or any(diff):
            raise RuntimeError(f"{name} kernel disagrees with its plain "
                               f"version on the {where} state: max abs "
                               f"differences {diff}")
        out[name] = max(diff)
    return out


def pair_keys(scene, mn, mx):
    """The candidate pairs the broadphase of `scene` hands the narrowphase,
    as sorted keys (phase, a, b) per env, unused slots last."""
    from dxk_tpu_torch.ops.broadphase import (aabb_overlap_mask,
                                              compact_pairs, is_dense,
                                              kselect_group_pairs)
    from dxk_tpu_torch.ops.kernels.broadphase_kernel import (
        aabb_overlap_matrix)
    C = mn.shape[1]
    keys = []
    if scene.broadphase_k > 0:
        sel = kselect_group_pairs(scene, mn, mx)[0]
        items = [(g.phase, *sel[gi][:2]) for gi, g in
                 enumerate(scene.pair_groups)]
    else:
        matrix = (aabb_overlap_matrix(mn, mx)
                  if any(is_dense(g.pairs.shape[0], C)
                         for g in scene.pair_groups) else None)
        items = []
        for g in scene.pair_groups:
            mask = aabb_overlap_mask(mn, mx, g.pairs, matrix)
            pairs, mask, _ = compact_pairs(g.pairs, mask, g.max_narrow)
            items.append((g.phase, pairs, mask))
    for phase, pairs, mask in items:
        k = (phase * C + pairs[..., 0].long()) * C + pairs[..., 1].long()
        keys.append(torch.where(mask, k, torch.iinfo(torch.int64).max))
    return torch.sort(torch.cat(keys, dim=1), dim=1).values


def box_stack_phase(seed):
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    counters = {"aabb_overlap_matrix": bk, "kselect_broadphase": ks,
                "sap_broadphase": sp, "fused_step": fs}
    path_kernel = {"table": "aabb_overlap_matrix",
                   "kselect": "kselect_broadphase", "sap": "sap_broadphase"}
    scenes = box_scenes()
    C = scenes["table"].colliders.ctype.shape[0]
    dense = [int(g.pairs.shape[0]) for g in scenes["table"].pair_groups
             if g.pairs.shape[0] * 8 >= C * C]
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="jacobi")
    state0 = box_initial_state(scenes["table"], seed)

    # ---- kernels and pair sets on the initial and a rolled-out state
    st = state0
    for _ in range(BOX_WARM):
        st, _info = physics_step(scenes["table"], st, settings, BOX_DT)
    checks = {}
    for where, state in (("initial", state0), (f"after_{BOX_WARM}_steps", st)):
        mn, mx = aabbs(scenes["table"], state)
        calls = broadphase_calls(scenes, mn, mx)
        errs = hold_kernels(calls, where)
        hits = calls["kselect_broadphase"]["kernel"]()[2].sum(dim=1)
        keys = {m: pair_keys(scenes[m], mn, mx) for m in BOX_MODES}
        live = int((keys["table"] != torch.iinfo(torch.int64).max).sum())
        same = {m: bool(torch.equal(keys[m], keys["table"]))
                for m in ("kselect", "sap")}
        checks[where] = dict(max_abs_err=errs, pair_sets_equal=same,
                             candidate_pairs=live,
                             live_overlaps_per_env=hits.tolist())
        if not all(same.values()):
            raise RuntimeError(f"pair sets differ between broadphases on the "
                               f"{where} state: {same}")
        if live == 0:
            raise RuntimeError(f"no candidate pair on the {where} state")

    # ---- timing of the kernels at the main path's shapes (rolled-out state)
    timing = {}
    for name, c in calls.items():
        for _ in range(3):
            c["kernel"]()
        ms = time_ms(c["kernel"], 50)
        plain_ms = time_ms(c["plain"], 3)
        t_bytes = c["bytes"] / PEAK_BYTES * 1e3
        t_ops = c["ops"] / PEAK_FLOPS * 1e3
        timing[name] = dict(ms=ms, plain_ms=plain_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes > t_ops
                            else "operations",
                            bytes=c["bytes"], ops=c["ops"], bytes_ms=t_bytes,
                            ops_ms=t_ops, source=c["source"],
                            replaces=c["replaces"])

    # ---- the main path: each broadphase, counts from zero just before it
    runs, final = {}, {}
    for mode in BOX_MODES:
        scene = scenes[mode]
        st = state0
        worst_ovf = torch.zeros((), dtype=torch.int32, device=DEVICE)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        contacts = torch.zeros((), dtype=torch.int64, device=DEVICE)
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BOX_STEPS):
            st, info = physics_step(scene, st, settings, BOX_DT)
            worst_ovf = torch.maximum(worst_ovf, info.broadphase_overflow.max())
            finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.lin_vel).all()
            contacts += info.num_contacts.sum()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        final[mode] = st
        drift = (st.pos - state0.pos)[:, 1:scene.num_bodies]
        runs[mode] = dict(
            steps=BOX_STEPS, seconds=secs,
            body_steps_per_s=BOX_BATCH * (scene.num_bodies - 1) * BOX_STEPS
            / secs,
            ms_per_step=secs / BOX_STEPS * 1e3, launches=launches,
            broadphase_overflow_max=int(worst_ovf), finite=bool(finite),
            contacts_per_env_step=int(contacts) / (BOX_BATCH * BOX_STEPS),
            max_xz_drift=float(drift[..., [0, 2]].abs().max()),
            max_y_drop=float((-drift[..., 1]).max()))
        want = {n: (BOX_STEPS if n == path_kernel[mode] else 0)
                for n in counters}
        if launches != want:
            raise RuntimeError(f"box stack ({mode}): kernel launches "
                               f"{launches}, expected {want}")
        if int(worst_ovf) != 0 or not bool(finite):
            raise RuntimeError(f"box stack ({mode}): overflow {int(worst_ovf)}"
                               f", finite {bool(finite)}")
    for mode in ("kselect", "sap"):
        err = float((final[mode].pos - final["table"].pos).abs().max())
        runs[mode]["max_abs_pos_diff_vs_table"] = err
        if not err <= BOX_PATH_TOL:
            raise RuntimeError(f"box stack: {mode} positions differ from the "
                               f"table broadphase by {err} after "
                               f"{BOX_STEPS} steps")
    emit("box_stack", envs=BOX_BATCH, boxes=scenes["table"].num_bodies - 1,
         colliders=C, iterations=ITERATIONS, dense_table_pairs=dense,
         path_tolerance=BOX_PATH_TOL, path_tolerance_reason=BOX_PATH_TOL_REASON,
         checks=checks, kernels=timing, runs=runs)
    return [{
        "name": name, "route": "cuda", "source": t["source"],
        "replaces": t["replaces"],
        "launches": runs[mode]["launches"][name],
        "max_abs_err": max(checks[w]["max_abs_err"][name] for w in checks),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}
        for mode, name in path_kernel.items()
        for t in (timing[name],)]


# ---------------------------------------------------------------------------
# the constraint zoo (BASELINE config 2) on the fused step

ZOO_CHAINS = 16                           # bench.py's width
ZOO_BATCHES = (256, 4096)                 # bench.py's on-chip zoo_batch; 4096
ZOO_RAGGED = 1000
ZOO_STEPS = 600
ZOO_WARM = 60
ZOO_DT = 1.0 / 120.0
ZOO_JOINTS = ("distance", "ball", "fixed", "hinge", "cone_twist", "slider")
# bench.py:303-313: position-drive the hinges, velocity-drive the sliders
ZOO_MOTORS = dict(hinge_motor_type=1, hinge_target=0.5, hinge_max_torque=50.0,
                  slider_motor_type=0, slider_target=0.2,
                  slider_max_force=80.0)


def zoo_builder(builder, n_chains=ZOO_CHAINS):
    """bench.py:261-300 (bench_constraint_zoo), copied: `n_chains` chains
    of six capsule links, one per joint type, with limits, each hanging
    from a kinematic anchor. `builder` is a SceneBuilder class; the result
    is finalized by the caller with candidate_margin=3.0."""
    b = builder()
    for ci in range(n_chains):
        x = ci * 4.0
        top = b.add_body(position=(x, 8, 0), kinematic=True)
        prev, y = top, 8.0
        for kind in ZOO_JOINTS:
            y -= 1.0
            link = b.add_body(position=(x, y, 0))
            b.add_capsule_collider(link, (0, -0.3, 0), (0, 0.3, 0), 0.12)
            anchor = (x, y + 0.5, 0)
            if kind == "distance":
                b.add_distance_constraint(prev, link, (x, y + 0.8, 0), anchor)
            elif kind == "ball":
                b.add_ball_constraint(prev, link, anchor)
            elif kind == "fixed":
                b.add_fixed_constraint(prev, link, anchor)
            elif kind == "hinge":
                b.add_hinge_constraint(prev, link, anchor, (1, 0, 0),
                                       min_limit=-1.0, max_limit=1.0)
            elif kind == "cone_twist":
                b.add_cone_twist_constraint(prev, link, anchor, (0, -1, 0),
                                            swing_limit=0.8, twist_limit=0.5)
            else:
                b.add_slider_constraint(prev, link, anchor, (0, 1, 0),
                                        min_limit=-0.4, max_limit=0.4)
            prev = link
    return b


def zoo_scene(n_chains=ZOO_CHAINS, device=DEVICE):
    """The zoo as bench.py finalizes it (candidate_margin=3.0 keeps the
    192 intra-chain capsule pairs of the 4,560), with bench's motors."""
    from dxk_tpu_torch.scene import SceneBuilder
    scene = zoo_builder(SceneBuilder, n_chains).finalize(
        candidate_margin=3.0, device=device)
    c = scene.default_controls
    motors = {k: torch.full_like(getattr(c, k), v)
              for k, v in ZOO_MOTORS.items()}
    return scene.replace(default_controls=c.replace(**motors))


def _axis_quat(axis, angle):
    """float64 quaternion (x, y, z, w) turning by `angle` about `axis`."""
    axis = torch.tensor(axis, dtype=torch.float64)
    axis = axis / axis.norm()
    return torch.cat([axis * np.sin(angle / 2),
                      torch.tensor([np.cos(angle / 2)], dtype=torch.float64)])


def _turn(pos, rot, env, bodies, pivot, axis, angle):
    """Rigidly turn `bodies` of env `env` about `pivot` (in place)."""
    from dxk_tpu_torch.core.maths import quat_mul, quat_rotate
    piv = torch.tensor(pivot, dtype=torch.float64)
    qb = _axis_quat(axis, angle).expand(len(bodies), 4)
    pos[env, bodies] = piv + quat_rotate(qb, pos[env, bodies] - piv)
    rot[env, bodies] = quat_mul(qb, rot[env, bodies])


def zoo_limit_state(scene, batch, seed):
    """`batch` envs of the zoo posed so that every limit of every chain is
    violated somewhere: env e (mod 5) moves the slider link 0.46 m up its
    axis, turns the hinge link and the links below it by +-1.15 rad about
    the hinge axis (limit 1 rad), swings or twists the cone-twist link and
    the slider link by 0.9 / 0.6 rad (limits 0.8 / 0.5) and moves the slider
    0.46 m down. Each move is a rigid motion about the joint's anchor, so
    the other joints stay closed. Velocities get the seeded 0.01 m/s noise
    of zoo_initial_state."""
    st = zoo_initial_state(scene, batch, seed)
    pos = st.pos.double().cpu()
    rot = st.rot.double().cpu()
    n_chains = scene.num_bodies // 7
    for e in range(batch):
        for ci in range(n_chains):
            x, base = ci * 4.0, ci * 7
            hinge_sub = [base + 4, base + 5, base + 6]
            cone_sub = [base + 5, base + 6]
            kind = e % 5
            if kind == 0:
                pos[e, base + 6, 1] += 0.46
            elif kind in (1, 2):
                _turn(pos, rot, e, hinge_sub, (x, 4.5, 0.0), (1.0, 0.0, 0.0),
                      1.15 if kind == 1 else -1.15)
            elif kind == 3:
                _turn(pos, rot, e, cone_sub, (x, 3.5, 0.0), (0.0, 0.0, 1.0),
                      0.9)
            else:
                _turn(pos, rot, e, cone_sub, (x, 3.5, 0.0), (0.0, 1.0, 0.0),
                      0.6)
                pos[e, base + 6, 1] -= 0.46
    return st.replace(pos=pos.float().to(st.pos.device),
                      rot=rot.float().to(st.rot.device))


def zoo_initial_state(scene, batch, seed):
    """`batch` envs of the zoo at rest, each with a seeded normal
    perturbation of 0.01 m/s on every body's linear velocity (as
    tests/test_fused_solver.py:46-52 does), so that the envs differ."""
    st = scene.initial_state(batch)
    gen = torch.Generator(device=st.pos.device)
    gen.manual_seed(seed)
    noise = torch.randn(st.lin_vel.shape, generator=gen,
                        device=st.pos.device) * 0.01
    return st.replace(lin_vel=st.lin_vel + noise)


def anchor_gap(scene, state, name):
    """Largest distance between the two world anchors of a joint type."""
    from dxk_tpu_torch.core.maths import quat_rotate
    j = getattr(scene, name)
    a, b = j.body_a.long(), j.body_b.long()
    ga = state.pos[:, a] + quat_rotate(state.rot[:, a],
                                       j.local_anchor_a.expand_as(
                                           state.pos[:, a]))
    gb = state.pos[:, b] + quat_rotate(state.rot[:, b],
                                       j.local_anchor_b.expand_as(
                                           state.pos[:, b]))
    return float((ga - gb).norm(dim=-1).max())


def zoo_phase(seed):
    """The constraint zoo on the fused step: kernel vs plain version on the
    card, every joint path live, then the main path at each batch."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene = zoo_scene()
    tab = fs.fused_tables(scene, DEVICE)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")
    n_bodies = scene.num_bodies

    # ---- kernel vs plain version: bench's batch and a ragged one, on the
    # initial state and after ZOO_WARM steps; and on the limit poses
    checks = {}
    for batch in (ZOO_BATCHES[0], ZOO_RAGGED):
        st0 = zoo_initial_state(scene, batch, seed)
        st = st0
        for _ in range(ZOO_WARM):
            st, _info = physics_step(scene, st, settings, ZOO_DT)
        checks[f"B{batch}_initial"] = compare_kernel(scene, st0, batch,
                                                     ZOO_DT)[0]
        checks[f"B{batch}_after_{ZOO_WARM}_steps"] = compare_kernel(
            scene, st, batch, ZOO_DT)[0]
    checks["limit_poses"] = compare_kernel(
        scene, zoo_limit_state(scene, ZOO_BATCHES[0], seed), ZOO_BATCHES[0],
        ZOO_DT)[0]
    joints_on = {}
    for c in checks.values():
        for t, flags in c["joints_on"].items():
            for k, n in flags.items():
                key = f"{t}.{k}"
                joints_on[key] = joints_on.get(key, 0) + n

    # ---- the main path at each batch, counts from zero just before it
    runs, timing = {}, {}
    for batch in ZOO_BATCHES:
        st = zoo_initial_state(scene, batch, seed + 1)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_STEPS):
            st, _info = physics_step(scene, st, settings, ZOO_DT)
            finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        runs[batch] = dict(
            steps=ZOO_STEPS, seconds=secs,
            body_steps_per_s=n_bodies * batch * ZOO_STEPS / secs,
            ms_per_step=secs / ZOO_STEPS * 1e3, launches=launches,
            finite=bool(finite),
            max_anchor_gap_m={n: anchor_gap(scene, st, n)
                              for n in ("ball", "fixed")})
        # the kernel at this batch on the rolled-out state
        cmp, run_kernel, run_plain, _tab, live = compare_kernel(
            scene, st, batch, ZOO_DT)
        hold_fused(cmp)
        for _ in range(3):
            run_kernel()
        b_ms, b_by, b_detail = bound_ms(tab, live, batch)
        timing[batch] = dict(ms=time_ms(run_kernel, 20),
                             plain_ms=time_ms(run_plain, 2), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail,
                             err_v=cmp["err_v"], err_w=cmp["err_w"])
    emit("zoo", chains=ZOO_CHAINS, bodies=n_bodies,
         colliders=tab.num_colliders, pair_rows=tab.num_rows,
         joints=tab.joint_counts, iterations=ITERATIONS, dt=ZOO_DT,
         threads=tab.threads(), smem_bytes=tab.shared_floats() * 4,
         shared_floats=tab.shared_floats(), tolerance=KERNEL_TOL,
         checks=checks, joints_on=joints_on, runs=runs, kernel=timing)
    for where, c in checks.items():
        hold_fused(c)
    never = [k for k in ("hinge.motor", "slider.motor", "hinge.limit",
                         "cone_twist.swing_limit", "cone_twist.twist_limit",
                         "slider.limit") if joints_on.get(k, 0) == 0]
    if never:
        raise RuntimeError(f"zoo: joint paths never live in the compared "
                           f"states: {never}")
    for batch, r in runs.items():
        want = {n: (ZOO_STEPS if n == "fused_step" else 0) for n in counters}
        if r["launches"] != want or not r["finite"]:
            raise RuntimeError(f"zoo B={batch}: launches {r['launches']} "
                               f"(expected {want}), finite {r['finite']}")
    big = ZOO_BATCHES[-1]
    return {
        "name": "fused_step_zoo", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_pos"],
                               c["err_rot"], c["err_imp"])
                           for c in checks.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None}


# ---------------------------------------------------------------------------
# the ragdoll drop-and-settle (BASELINE config 3) on the fused step

SETTLE_BATCHES = (256, 4096)              # bench.py's on-chip 4 * aux_batch; 4096
SETTLE_RAGGED = 1000
SETTLE_STEPS = 600
SETTLE_WARM = 60
SETTLE_DT = 1.0 / 120.0
SETTLE_BODIES = 15                        # bench.py counts 15 per env
DEBRIS_HALF = 0.12                        # the hull debris: a 0.24 m cube
PILE_STEPS = 120
SETTLE_TOL_REASON = (
    "velocities held relative to the largest one: the limp ragdoll's toes "
    "keep bouncing on the ground at up to hundreds of rad/s in some of the "
    "4096 envs, in the plain version as in the kernel (and in the JAX "
    "package, which the plain version follows step for step on the CPU), "
    "and on the card the plain version sums per-body deltas with "
    "index_add_ atomics in no fixed order, so the two differ by float "
    "rounding of such values")


def settle_builder(builder, add_ragdoll):
    """bench.py:333-345 (bench_ragdoll_settle), copied: the ragdoll dropped
    from a hip height of 1.6 m onto a 40 x 8 x 40 ground box, beside a
    convex-hull debris cube of 0.24 m. `builder` is a SceneBuilder class and
    `add_ragdoll` its package's ragdoll; the result is finalized by the
    caller with no arguments (uncapped static tables)."""
    b = builder()
    ground = b.add_static(position=(0, -4.0, 0))
    b.add_box_collider(ground, (0, 0, 0), (20, 4, 20), friction=1.0)
    add_ragdoll(b, initial_hip_position=(0.0, 1.6, 0.0))
    h = DEBRIS_HALF
    cube = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                     for z in (-h, h)])
    hid = b.add_hull_geometry_from_mesh(cube)
    debris = b.add_body(position=(0.45, 1.2, 0.1))
    b.add_hull_collider(debris, hid, friction=0.8)
    return b


def settle_scene(device=DEVICE):
    from dxk_tpu_torch.models.ragdoll import add_ragdoll
    from dxk_tpu_torch.scene import SceneBuilder
    return settle_builder(SceneBuilder, add_ragdoll).finalize(device=device)


def settle_initial_state(scene, batch, seed):
    """`batch` envs of the drop, each with a seeded normal perturbation of
    0.01 m/s on every body's linear velocity, so that the envs differ."""
    return zoo_initial_state(scene, batch, seed)


def settle_hull_poses(scene, batch, seed):
    """`batch` envs of the settle scene with the debris (the last body) put
    where the hull recipes branch: env e (mod 4) sets it face-down,
    edge-down or vertex-down into the ground by 0-8 mm with a seeded
    yaw and tilt of up to 3 degrees, or centred 0-0.2 m from the middle of
    a seeded capsule of the ragdoll (the segment deep inside the hull or
    near its faces). The ragdoll keeps its initial pose; velocities get the
    seeded noise of settle_initial_state."""
    from dxk_tpu_torch.core.maths import quat_mul, quat_rotate
    st = settle_initial_state(scene, batch, seed)
    rng = np.random.default_rng(seed)
    pos = st.pos.double().cpu()
    rot = st.rot.double().cpu()
    deb = scene.num_bodies - 1
    col = scene.colliders.to("cpu")
    caps = (col.ctype == 1).nonzero()[:, 0].tolist()
    h = DEBRIS_HALF
    down = {0: (_axis_quat((0, 1, 0), 0.0), h),
            1: (_axis_quat((1, 0, 0), np.pi / 4), h * np.sqrt(2.0)),
            2: (quat_mul(_axis_quat((1, 0, 0), np.arctan(np.sqrt(0.5))),
                         _axis_quat((0, 0, 1), np.pi / 4)), h * np.sqrt(3.0))}
    for e in range(batch):
        kind = e % 4
        yaw = _axis_quat((0, 1, 0), rng.uniform(0, 2 * np.pi))
        tilt = _axis_quat(rng.normal(size=3), np.radians(rng.uniform(0, 3)))
        if kind < 3:
            q0, lowest = down[kind]
            rot[e, deb] = quat_mul(tilt, quat_mul(yaw, q0))
            pos[e, deb] = torch.tensor(
                (rng.uniform(-2, 2), lowest - rng.uniform(0, 0.008),
                 rng.uniform(-2, 2)), dtype=torch.float64)
        else:
            c = caps[rng.integers(len(caps))]
            body = int(col.body[c])
            ends = [pos[e, body] + quat_rotate(rot[e, body], x[c].double())
                    for x in (col.a, col.b)]
            d = torch.from_numpy(rng.normal(size=3))
            rot[e, deb] = quat_mul(tilt, yaw)
            pos[e, deb] = ((ends[0] + ends[1]) / 2
                           + d / d.norm() * rng.uniform(0, 0.2))
    return st.replace(pos=pos.float().to(st.pos.device),
                      rot=rot.float().to(st.rot.device))


def pile_builder(builder):
    """A check scene for the polytope recipes: three convex hulls stacked on
    a ground box (40 x 2 x 40, top at y = 0): the 0.24 m debris cube, a
    hull of 16 seeded points and a tetrahedron, each resting a few
    millimetres into the one below. Gives box-hull and hull-hull rows."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (20, 1, 20))
    h = DEBRIS_HALF
    cube = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                     for z in (-h, h)])
    rng = np.random.default_rng(16)
    blob = rng.normal(size=(16, 3)) * 0.08
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 0.1
    y = 0.0
    for pts in (cube, blob, tet):
        hid = b.add_hull_geometry_from_mesh(pts)
        y += -pts[:, 1].min() - 0.003
        body = b.add_body(position=(0.0, y, 0.0))
        b.add_hull_collider(body, hid)
        y += pts[:, 1].max()
    return b


def pile_scene(device=DEVICE):
    from dxk_tpu_torch.scene import SceneBuilder
    return pile_builder(SceneBuilder).finalize(device=device)


def pile_poses(scene, batch, seed):
    """`batch` envs of the pile: each hull turned by a seeded random
    rotation (odd envs) or by up to 5 degrees (even envs), then set down
    with its lowest vertex 0-6 mm below the highest vertex of the hull
    under it (the ground's top for the first), so that each pair below
    touches."""
    from dxk_tpu_torch.core.maths import quat_rotate
    st = scene.initial_state(batch)
    rng = np.random.default_rng(seed)
    pos = st.pos.double().cpu()
    rot = st.rot.double().cpu()
    hv = scene.hulls.vertices.double().cpu()
    hm = scene.hulls.vertex_mask.cpu()
    for e in range(batch):
        top = torch.tensor((rng.uniform(-0.03, 0.03), 0.0,
                            rng.uniform(-0.03, 0.03)), dtype=torch.float64)
        for k in range(3):
            ang = rng.uniform(0, 2 * np.pi) if e % 2 else np.radians(
                rng.uniform(0, 5))
            q = _axis_quat(rng.normal(size=3), ang)
            verts = hv[k][hm[k]]
            v = quat_rotate(q.expand(len(verts), 4), verts)
            rot[e, k + 1] = q                    # body 0 owns the ground
            pos[e, k + 1] = top - v[v[:, 1].argmin()] - torch.tensor(
                (0.0, rng.uniform(0, 0.006), 0.0), dtype=torch.float64)
            top = pos[e, k + 1] + v[v[:, 1].argmax()]
    return st.replace(pos=pos.float().to(st.pos.device),
                      rot=rot.float().to(st.rot.device))


def debris_height(scene, state):
    """Height above the ground's top (y = 0) of the debris hull's lowest
    vertex in each env."""
    from dxk_tpu_torch.core.maths import quat_rotate
    from dxk_tpu_torch.ops.shapes import world_colliders
    col = int((scene.colliders.ctype == 4).nonzero()[0, 0])
    hv = scene.hulls.vertices[int(scene.colliders.hull_id[col])]
    w = world_colliders(scene, state.pos, state.rot)
    rot = w.rot[:, col][:, None].expand(-1, hv.shape[0], 4)
    world = w.a[:, col][:, None] + quat_rotate(rot, hv.expand(
        rot.shape[0], -1, -1))
    return world[..., 1].amin(dim=1)


def settle_phase(seed):
    """bench.py's ragdoll settle with its hull debris on the fused step:
    kernel vs plain version on the card (settle states, hull poses, the
    hull pile), every hull recipe and branch live, then the main path at
    each batch."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene = settle_scene()
    tab = fs.fused_tables(scene, DEVICE)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")

    # ---- kernel vs plain version: bench's batch and a ragged one, on the
    # initial state and after SETTLE_WARM steps; the hull poses; the pile
    checks = {}
    for batch in (SETTLE_BATCHES[0], SETTLE_RAGGED):
        st0 = settle_initial_state(scene, batch, seed)
        st = st0
        for _ in range(SETTLE_WARM):
            st, _info = physics_step(scene, st, settings, SETTLE_DT)
        checks[f"B{batch}_initial"] = compare_kernel(scene, st0, batch,
                                                     SETTLE_DT)[0]
        checks[f"B{batch}_after_{SETTLE_WARM}_steps"] = compare_kernel(
            scene, st, batch, SETTLE_DT)[0]
    checks["hull_poses"] = compare_kernel(
        scene, settle_hull_poses(scene, SETTLE_BATCHES[0], seed),
        SETTLE_BATCHES[0], SETTLE_DT)[0]
    pile = pile_scene()
    pile_st = pile_poses(pile, SETTLE_BATCHES[0], seed)
    checks["pile_poses"] = compare_kernel(pile, pile_st, SETTLE_BATCHES[0],
                                          SETTLE_DT)[0]
    live, branches = {}, {}
    for c in checks.values():
        for r, n in c["live_rows_by_recipe"].items():
            live[r] = live.get(r, 0) + n
        for r, br in c.get("branches", {}).items():
            for k, n in br.items():
                if k != "gjk_iterations":
                    key = "sat" if r in ("box_hull", "hull_hull") else r
                    branches.setdefault(key, {})
                    branches[key][k] = branches[key].get(k, 0) + n

    # ---- the pile stepped PILE_STEPS steps: state finite
    st = pile_st
    pile_finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    for _ in range(PILE_STEPS):
        st, _info = physics_step(pile, st, settings, SETTLE_DT)
        pile_finite &= torch.isfinite(st.pos).all() & torch.isfinite(
            st.lin_vel).all() & torch.isfinite(st.ang_vel).all()

    # ---- the main path at each batch, counts from zero just before it
    runs, timing = {}, {}
    for batch in SETTLE_BATCHES:
        st = settle_initial_state(scene, batch, seed + 1)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SETTLE_STEPS):
            st, _info = physics_step(scene, st, settings, SETTLE_DT)
            finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        h = debris_height(scene, st)
        runs[batch] = dict(
            steps=SETTLE_STEPS, seconds=secs,
            body_steps_per_s=SETTLE_BODIES * batch * SETTLE_STEPS / secs,
            ms_per_step=secs / SETTLE_STEPS * 1e3, launches=launches,
            finite=bool(finite),
            debris_lowest_vertex_height_m=dict(
                min=float(h.min()), mean=float(h.mean()), max=float(h.max())),
            torso_height_m_mean=float(st.pos[:, 2, 1].mean()))
        # the kernel at this batch on the settled state (held below)
        cmp, run_kernel, run_plain, _tab, klive = compare_kernel(
            scene, st, batch, SETTLE_DT)
        checks[f"B{batch}_after_{SETTLE_STEPS}_steps"] = cmp
        for _ in range(3):
            run_kernel()
        work = recipe_flops(tab, cmp["branches"], batch)
        b_ms, b_by, b_detail = bound_ms(tab, klive, batch, work)
        timing[batch] = dict(ms=time_ms(run_kernel, 20),
                             plain_ms=time_ms(run_plain, 2), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail,
                             recipe_flops=work, err_v=cmp["err_v"],
                             err_w=cmp["err_w"],
                             live_rows_by_recipe=cmp["live_rows_by_recipe"],
                             branches=cmp["branches"])
    emit("settle", bodies=scene.num_bodies, body_steps_counted=SETTLE_BODIES,
         colliders=tab.num_colliders, pair_rows=tab.num_rows,
         joints=tab.joint_counts, hull_dims=dict(zip(
             ("V", "F", "FU", "LM", "EU"), tab.hull_dims)),
         iterations=ITERATIONS, dt=SETTLE_DT, threads=tab.threads(),
         smem_bytes=tab.shared_floats() * 4, tolerance=KERNEL_TOL,
         tolerance_reason=SETTLE_TOL_REASON,
         checks=checks, live_rows_by_recipe=live, branches=branches,
         pile=dict(steps=PILE_STEPS, finite=bool(pile_finite),
                   pair_rows=fs.fused_tables(pile, DEVICE).num_rows,
                   hull_dims=fs.fused_tables(pile, DEVICE).hull_dims),
         runs=runs, kernel=timing)
    for c in checks.values():
        hold_fused(c, relative=True)
    dead = [r for r in ("capsule_hull", "box_hull", "hull_hull")
            if live.get(r, 0) == 0]
    dead += [f"{r}.{k}" for r, ks_ in (("capsule_hull", ("separated",
                                                          "overlap")),
                                       ("sat", ("face_a", "face_b", "edge")))
             for k in ks_ if branches.get(r, {}).get(k, 0) == 0]
    if dead:
        raise RuntimeError(f"settle: hull recipes or branches never live in "
                           f"the compared states: {dead}")
    if not bool(pile_finite):
        raise RuntimeError("settle: the hull pile went non-finite")
    for batch, r in runs.items():
        want = {n: (SETTLE_STEPS if n == "fused_step" else 0)
                for n in counters}
        if r["launches"] != want or not r["finite"]:
            raise RuntimeError(f"settle B={batch}: launches {r['launches']} "
                               f"(expected {want}), finite {r['finite']}")
    big = SETTLE_BATCHES[-1]
    return {
        "name": "fused_step_settle", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_pos"],
                               c["err_rot"], c["err_imp"])
                           for c in checks.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None}


# ---------------------------------------------------------------------------
# the golden mixed-shape drop and sphere bounce on the fused step

SHAPES_SCENES = ("mixed_shape_drop", "sphere_bounce")
SHAPES_BATCHES = (256, 4096)              # bench.py's on-chip aux batch; loco's
SHAPES_RAGGED = 1000
SHAPES_STEPS = 1000                       # the golden horizon
SHAPES_WARM = (60, 150)                   # compared states; at 150 bodies touch
SHAPES_DT = 1.0 / 120.0
SHAPES_BODIES = {"mixed_shape_drop": 3, "sphere_bounce": 1}   # dynamic bodies
SHAPES_SINK_TOL = 0.01                    # no body's lowest point deeper (m)
SHAPES_EVERY = 25                         # steps between lowest-point reads
# scenes held to SHAPES_SINK_TOL; every scene is held to keep every dynamic
# body's centre above the ground (nothing falls through it)
SHAPES_SINK_GATED = ("sphere_bounce",)
SHAPES_SINK_REASON = (
    "mixed_shape_drop is held only to keep every body's centre above the "
    "ground, and its bodies' depth below the ground is printed: in about 1 % "
    "of the envs the cylinder comes to rest on the ramp's low edge 4-5 cm "
    "into the ground with no live cylinder-box row, and the JAX package's "
    "fused step does the same from such a state, bit for bit "
    "(tools/replay_shapes_state_cpu.py replays `deepest_env_state` on the "
    "CPU), so the depth is the recipe's, not the port's")
SHAPES_TOL_REASON = (
    "velocities held relative to the largest one, as in the settle phase: "
    "the plain version sums per-body deltas with index_add_ atomics in no "
    "fixed order on the card, and a bounce or a tumbling body amplifies "
    "that rounding over 1000 steps")
# the hull of the golden mixed-shape drop (tests/test_golden_trajectories.py)
GOLDEN_HULL = np.array([[0.4, 0, 0], [-0.3, 0.25, 0.1], [0, -0.2, 0.35],
                        [-0.1, -0.15, -0.3], [0.1, 0.3, -0.2]])
# the recipes this phase adds to the kernel, each required live somewhere
SHAPES_RECIPES = ("sphere_sphere", "sphere_capsule", "sphere_cylinder",
                  "sphere_box", "sphere_hull", "capsule_cylinder",
                  "cylinder_cylinder", "cylinder_box", "cylinder_hull")
SHAPES_BRANCHES = {"cylinder_box": ("ring", "tube", "single"),
                   "cylinder_cylinder": ("ring", "tube", "single"),
                   "sphere_hull": ("outside", "inside"),
                   "cylinder_hull": ("gate_separated", "gate_overlap")}


GOLDEN_SCENES = ("sphere_bounce", "box_stack", "double_pendulum",
                 "constraint_zoo", "ragdoll_settle", "mixed_shape_drop")


def golden_builder(builder, name, add_ragdoll=None):
    """The golden scenes of tests/test_golden_trajectories.py:33-114,
    copied: sphere_bounce (a sphere dropped from 2 m onto a ground box,
    restitution 0.3), box_stack (three boxes), double_pendulum (two capsule
    links on ball joints under a kinematic anchor), constraint_zoo (a chain
    of one link per joint type, with limits), ragdoll_settle (the ragdoll
    dropped from a hip height of 1.5 m; `add_ragdoll` is the package's own)
    and mixed_shape_drop (a convex hull, a cylinder and a capsule dropped
    onto a tilted box ramp on a ground box). `builder` is a SceneBuilder
    class; the result is finalized by the caller with no arguments."""
    b = builder()
    if name == "ragdoll_settle":
        g = b.add_static(position=(0, -4.0, 0))
        b.add_box_collider(g, (0, 0, 0), (20, 4, 20), friction=1.0)
        add_ragdoll(b, initial_hip_position=(0.0, 1.5, 0.0))
        return b
    if name == "double_pendulum":
        anchor = b.add_body(position=(0, 3, 0), kinematic=True)
        l1 = b.add_body(position=(0.5, 3, 0))
        b.add_capsule_collider(l1, (-0.2, 0, 0), (0.2, 0, 0), 0.05)
        l2 = b.add_body(position=(1.2, 3, 0))
        b.add_capsule_collider(l2, (-0.2, 0, 0), (0.2, 0, 0), 0.05)
        b.add_ball_constraint(anchor, l1, (0, 3, 0))
        b.add_ball_constraint(l1, l2, (0.8, 3, 0))
        return b
    if name == "constraint_zoo":
        top = b.add_body(position=(0, 8, 0), kinematic=True)
        prev, y = top, 8.0
        for kind in ("distance", "ball", "fixed", "hinge", "cone_twist",
                     "slider"):
            y -= 1.0
            link = b.add_body(position=(0.05, y, -0.02))
            b.add_capsule_collider(link, (0, -0.3, 0), (0, 0.3, 0), 0.12)
            anchor = (0, y + 0.5, 0)
            if kind == "distance":
                b.add_distance_constraint(prev, link, (0, y + 0.8, 0),
                                          anchor)
            elif kind == "ball":
                b.add_ball_constraint(prev, link, anchor)
            elif kind == "fixed":
                b.add_fixed_constraint(prev, link, anchor)
            elif kind == "hinge":
                b.add_hinge_constraint(prev, link, anchor, (1, 0, 0),
                                       min_limit=-1.0, max_limit=1.0)
            elif kind == "cone_twist":
                b.add_cone_twist_constraint(prev, link, anchor, (0, -1, 0),
                                            swing_limit=0.8, twist_limit=0.5)
            else:
                b.add_slider_constraint(prev, link, anchor, (0, 1, 0),
                                        min_limit=-0.4, max_limit=0.4)
            prev = link
        return b
    g = b.add_static()
    if name == "sphere_bounce":
        b.add_box_collider(g, (0, -1, 0), (20, 1, 20), restitution=0.3)
        s = b.add_body(position=(0.1, 2.0, -0.05))
        b.add_sphere_collider(s, (0, 0, 0), 0.5, restitution=0.3)
        return b
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    if name == "box_stack":
        for i in range(3):
            bd = b.add_body(position=(0.02 * i, 0.5 + 1.001 * i, -0.01 * i))
            b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
        return b
    b.add_box_collider(g, (0, 0.3, 0), (2.0, 0.3, 2.0),
                       rotation=(0.13, 0, 0, 0.9915))
    hid = b.add_hull_geometry_from_mesh(GOLDEN_HULL)
    h = b.add_body(position=(0.3, 2.2, 0.1))
    b.add_hull_collider(h, hid)
    cy = b.add_body(position=(-0.5, 3.0, -0.3))
    b.add_cylinder_collider(cy, (0, -0.25, 0), (0, 0.25, 0), 0.3)
    ca = b.add_body(position=(0.2, 4.0, 0.4))
    b.add_capsule_collider(ca, (0, -0.2, 0), (0, 0.2, 0), 0.25)
    return b


def shapes_scene(name, device=DEVICE):
    from dxk_tpu_torch.models.ragdoll import add_ragdoll
    from dxk_tpu_torch.scene import SceneBuilder
    return golden_builder(SceneBuilder, name, add_ragdoll).finalize(
        device=device)


def shapes_initial_state(scene, batch, seed):
    """`batch` envs at the golden start, each with the seeded 0.01 m/s
    velocity noise of the zoo and settle phases, so that the envs differ."""
    return zoo_initial_state(scene, batch, seed)


def shapes_pile_builder(builder):
    """A check scene for the sphere and cylinder recipes that neither golden
    scene runs: two spheres (r 0.2, 0.15), a capsule (half length 0.2, r
    0.12), two cylinders (half length 0.25, r 0.3; 0.2, 0.22) and the golden
    hull on a ground box (top at y = 0); every pair of them has a row.
    shapes_pile_poses puts them where the recipes branch."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (20, 1, 20))
    s1 = b.add_body(position=(-1.5, 0.2, 0.0))
    b.add_sphere_collider(s1, (0, 0, 0), 0.2)
    s2 = b.add_body(position=(-1.0, 0.15, 0.0))
    b.add_sphere_collider(s2, (0, 0, 0), 0.15)
    c = b.add_body(position=(-0.5, 0.32, 0.0))
    b.add_capsule_collider(c, (0, -0.2, 0), (0, 0.2, 0), 0.12)
    y1 = b.add_body(position=(0.2, 0.25, 0.0))
    b.add_cylinder_collider(y1, (0, -0.25, 0), (0, 0.25, 0), 0.3)
    y2 = b.add_body(position=(1.0, 0.2, 0.0))
    b.add_cylinder_collider(y2, (0, -0.2, 0), (0, 0.2, 0), 0.22)
    h = b.add_body(position=(1.8, 0.2, 0.0))
    b.add_hull_collider(h, b.add_hull_geometry_from_mesh(GOLDEN_HULL))
    return b


def shapes_pile_scene(device=DEVICE):
    from dxk_tpu_torch.scene import SceneBuilder
    return shapes_pile_builder(SceneBuilder).finalize(device=device)


def _np_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def _np_qmul(a, b):
    """Hamilton product of (x, y, z, w) quaternions: a then b applied as
    a * b (b first)."""
    av, aw, bv, bw = a[:3], a[3], b[:3], b[3]
    return np.concatenate([aw * bv + bw * av + np.cross(av, bv),
                           [aw * bw - av @ bv]])


def _np_qrot(q, v):
    qv, w = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def shapes_pile_poses(scene, batch, seed):
    """`batch` envs of the check pile (bodies 1-6: spheres S1, S2, capsule
    C, cylinders Y1, Y2, hull H), each touching by 0-5 mm where it touches.
    Env e (mod 4):
      0  a jumble: every body at a seeded rotation within 0.3 m of a point
         0.1-0.45 m above the ground, S2 within 5 cm of the hull's origin
         (tilted single-point cylinder contacts, crossing cylinders, spheres
         against everything, sphere-hull inside);
      1  upright: Y1 on the ground, Y2 stacked on it (cap rings with the
         ground and cap to cap), S1 beside Y1 on the ground (sphere-cylinder
         side, sphere-box), S2 on S1, C lying against S1, H against Y1's
         side (cylinder-hull);
      2  lying: Y1 on the ground, Y2 beside it parallel (lying tubes with the
         ground and tube to tube), S1 on Y1, C on Y2 parallel (two-point
         capsule-cylinder), S2 inside H;
      3  tilted: Y1 tilted 15-35 degrees on its rim (single point), Y2 upright
         with S2 on its cap and C across it (capsule-cylinder, not parallel),
         S1 on H's top vertex (sphere-hull outside).
    Velocities get the seeded noise of shapes_initial_state."""
    st = shapes_initial_state(scene, batch, seed)
    rng = np.random.default_rng(seed)
    pos = st.pos.double().cpu().numpy()
    rot = st.rot.double().cpu().numpy()
    S1, S2, C, Y1, Y2, H = 1, 2, 3, 4, 5, 6
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    rx90 = _np_quat((1, 0, 0), np.pi / 2)          # local y axis -> world z
    rz90 = _np_quat((0, 0, 1), np.pi / 2)          # local y axis -> world -x

    def pen():
        return rng.uniform(0.0, 0.005)

    def u(lo, hi, n=None):
        return rng.uniform(lo, hi, n)

    top_h = GOLDEN_HULL[GOLDEN_HULL[:, 1].argmax()]
    for e in range(batch):
        kind = e % 4
        base = np.array([u(-1, 1), 0.0, u(-1, 1)])
        psi = u(0, 2 * np.pi)
        yaw = _np_quat((0, 1, 0), psi)
        side = _np_qrot(yaw, np.array([1.0, 0.0, 0.0]))
        P, Q = {}, {}
        if kind == 0:
            for k in (S1, C, Y1, Y2, H):
                P[k] = base + np.array([u(-0.3, 0.3), u(0.1, 0.45),
                                        u(-0.3, 0.3)])
                q = rng.normal(size=4)
                Q[k] = q / np.linalg.norm(q)
            P[S2] = P[H] + u(-0.05, 0.05, 3)
            Q[S2] = ident
        elif kind == 1:
            P[Y1] = base + np.array([0.0, 0.25 - pen(), 0.0])
            P[Y2] = base + np.array([u(-0.05, 0.05), 0.7 - pen(),
                                     u(-0.05, 0.05)])
            Q[Y1] = Q[Y2] = yaw
            P[S1] = base + side * (0.5 - pen()) + np.array([0, 0.2 - pen(), 0])
            P[S2] = P[S1] + np.array([u(-0.02, 0.02), 0.35 - pen(),
                                      u(-0.02, 0.02)])
            Q[S1] = Q[S2] = ident
            gap = 0.32 - pen()
            cy = 0.12 - pen()
            P[C] = P[S1] + side * np.sqrt(gap ** 2 - (P[S1][1] - cy) ** 2)
            P[C][1] = cy
            Q[C] = _np_qmul(yaw, rx90)       # axis along the ground, across
            # the hull's +x vertex (local (0.4, 0, 0)) into Y1's side
            Q[H] = _np_quat((0, 1, 0), psi + np.pi)
            P[H] = base - side * (0.7 - pen()) + np.array([0, 0.2 - pen(), 0])
        elif kind == 2:
            q = _np_qmul(yaw, rx90)
            axis = _np_qrot(q, np.array([0.0, 1.0, 0.0]))
            P[Y1] = base + np.array([0.0, 0.3 - pen(), 0.0])
            P[Y2] = (base + side * np.sqrt((0.52 - pen()) ** 2 - 0.08 ** 2)
                     + axis * u(-0.05, 0.05))
            P[Y2][1] = 0.22 - pen()
            P[S1] = P[Y1] + np.array([0, 0.5 - pen(), 0]) + axis * u(-0.15,
                                                                       0.15)
            P[C] = P[Y2] + np.array([0, 0.34 - pen(), 0])
            Q[Y1] = Q[Y2] = Q[C] = q
            Q[S1] = Q[S2] = ident
            P[H] = base - side * 1.2 + np.array([0, 0.2 - pen(), 0])
            Q[H] = yaw
            P[S2] = P[H] + u(-0.03, 0.03, 3)
        else:
            th = np.radians(u(15, 35))
            Q[Y1] = _np_qmul(yaw, _np_quat((1, 0, 0), th))
            P[Y1] = base + np.array([0, 0.25 * np.cos(th) + 0.3 * np.sin(th)
                                     - pen(), 0])
            P[Y2] = base + side * 1.5 + np.array([0, 0.2 - pen(), 0])
            Q[Y2] = ident
            P[S2] = P[Y2] + np.array([u(-0.1, 0.1), 0.35 - pen(),
                                      u(-0.1, 0.1)])
            P[C] = P[Y2] + np.array([0, 0.32 - pen(), 0])
            Q[C] = _np_qmul(_np_quat((0, 1, 0), u(0, 2 * np.pi)), rz90)
            P[H] = base - side * 1.5 + np.array([0, 0.2 - pen(), 0])
            Q[H] = yaw
            P[S1] = (P[H] + _np_qrot(yaw, top_h)
                     + np.array([u(-0.05, 0.05), 0.2 - pen(), u(-0.05, 0.05)]))
            Q[S1] = Q[S2] = ident
        for k in P:
            pos[e, k] = P[k]
            rot[e, k] = Q[k]
    return st.replace(pos=torch.from_numpy(pos).float().to(st.pos.device),
                      rot=torch.from_numpy(rot).float().to(st.rot.device))


def lowest_point(scene, state):
    """Per env, the lowest world point (m, the ground's top is y = 0) of any
    dynamic body's collider, from the colliders' tight AABBs, and the lowest
    centre of a dynamic body."""
    from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
    mn, _mx = collider_aabbs(scene, world_colliders(scene, state.pos,
                                                    state.rot))
    dyn = scene.colliders.body < scene.num_bodies
    bodies = scene.colliders.body[dyn].long()
    return mn[:, dyn, 1].amin(dim=1), state.pos[:, bodies, 1].amin(dim=1)


def shapes_phase(seed):
    """The golden mixed-shape drop and sphere bounce on the fused step:
    kernel vs plain version on the card (both scenes, the check pile), every
    sphere and cylinder recipe and branch live, then the main path at each
    batch."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scenes = {n: shapes_scene(n) for n in SHAPES_SCENES}
    pile = shapes_pile_scene()
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")

    # ---- kernel vs plain version: bench's batch and a ragged one, on the
    # initial state and after each of SHAPES_WARM steps; the check pile
    checks = {}
    for name, scene in scenes.items():
        for batch in (SHAPES_BATCHES[0], SHAPES_RAGGED):
            st = shapes_initial_state(scene, batch, seed)
            checks[f"{name}.B{batch}_initial"] = compare_kernel(
                scene, st, batch, SHAPES_DT)[0]
            for t in range(1, SHAPES_WARM[-1] + 1):
                st, _info = physics_step(scene, st, settings, SHAPES_DT)
                if t in SHAPES_WARM:
                    checks[f"{name}.B{batch}_after_{t}_steps"] = \
                        compare_kernel(scene, st, batch, SHAPES_DT)[0]
    checks["pile_poses"] = compare_kernel(
        pile, shapes_pile_poses(pile, SHAPES_BATCHES[0], seed),
        SHAPES_BATCHES[0], SHAPES_DT)[0]

    # ---- the main path: each scene at each batch, counts from zero just
    # before it
    runs, timing = {}, {}
    for name, scene in scenes.items():
        tab = fs.fused_tables(scene, DEVICE)
        for batch in SHAPES_BATCHES:
            st = shapes_initial_state(scene, batch, seed + 1)
            finite = torch.ones((), dtype=torch.bool, device=DEVICE)
            lowest = torch.full((), float("inf"), device=DEVICE)
            centre = torch.full((), float("inf"), device=DEVICE)
            for mod in counters.values():
                mod.reset_launch_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(SHAPES_STEPS):
                st, _info = physics_step(scene, st, settings, SHAPES_DT)
                finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                    st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
                if t % SHAPES_EVERY == SHAPES_EVERY - 1:
                    low, cen = lowest_point(scene, st)
                    lowest = torch.minimum(lowest, low.min())
                    centre = torch.minimum(centre, cen.min())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {n: mod.launch_count() for n, mod in counters.items()}
            low_end = lowest_point(scene, st)[0]
            deep = int(low_end.argmin())
            key = f"{name}.B{batch}"
            runs[key] = dict(
                steps=SHAPES_STEPS, seconds=secs,
                body_steps_per_s=SHAPES_BODIES[name] * batch * SHAPES_STEPS
                / secs,
                ms_per_step=secs / SHAPES_STEPS * 1e3, launches=launches,
                finite=bool(finite),
                lowest_point_m=dict(
                    every_25_steps=float(lowest), end_min=float(low_end.min()),
                    end_mean=float(low_end.mean()),
                    end_share_deeper_than_tol=float(
                        (low_end < -SHAPES_SINK_TOL).float().mean())),
                lowest_centre_m_every_25_steps=float(centre),
                deepest_env_state=dict(env=deep, **{
                    k: getattr(st, k)[deep].tolist()
                    for k in ("pos", "rot", "lin_vel", "ang_vel")}))
            # the kernel at this batch on the end state (held below)
            cmp, run_kernel, run_plain, _tab, klive = compare_kernel(
                scene, st, batch, SHAPES_DT)
            checks[f"{key}_after_{SHAPES_STEPS}_steps"] = cmp
            for _ in range(3):
                run_kernel()
            work = recipe_flops(tab, cmp.get("branches", {}), batch)
            b_ms, b_by, b_detail = bound_ms(tab, klive, batch, work)
            timing[key] = dict(ms=time_ms(run_kernel, 20),
                               plain_ms=time_ms(run_plain, 2), bound_ms=b_ms,
                               bound_by=b_by, bound_detail=b_detail,
                               recipe_flops=work,
                               live_rows_by_recipe=cmp["live_rows_by_recipe"])
    live, branches = {}, {}
    for c in checks.values():
        for r, n in c["live_rows_by_recipe"].items():
            live[r] = live.get(r, 0) + n
        for r, br in c.get("branches", {}).items():
            for k, n in br.items():
                branches.setdefault(r, {})
                branches[r][k] = branches[r].get(k, 0) + n
    ptab = fs.fused_tables(pile, DEVICE)
    emit("shapes", scenes={
        n: dict(bodies=s.num_bodies, dynamic_bodies=SHAPES_BODIES[n],
                colliders=fs.fused_tables(s, DEVICE).num_colliders,
                pair_rows=fs.fused_tables(s, DEVICE).num_rows,
                threads=fs.fused_tables(s, DEVICE).threads(),
                smem_bytes=fs.fused_tables(s, DEVICE).shared_floats() * 4)
        for n, s in scenes.items()},
         pile=dict(pair_rows=ptab.num_rows, threads=ptab.threads(),
                   smem_bytes=ptab.shared_floats() * 4),
         iterations=ITERATIONS, dt=SHAPES_DT, tolerance=KERNEL_TOL,
         tolerance_reason=SHAPES_TOL_REASON, sink_tolerance=SHAPES_SINK_TOL,
         sink_gated=SHAPES_SINK_GATED, sink_reason=SHAPES_SINK_REASON,
         checks=checks,
         live_rows_by_recipe=live, branches=branches, runs=runs,
         kernel=timing)
    for c in checks.values():
        hold_fused(c, relative=True)
    dead = [r for r in SHAPES_RECIPES if live.get(r, 0) == 0]
    dead += [f"{r}.{k}" for r, ks_ in SHAPES_BRANCHES.items() for k in ks_
             if branches.get(r, {}).get(k, 0) == 0]
    if dead:
        raise RuntimeError(f"shapes: recipes or branches never live in the "
                           f"compared states: {dead}")
    for key, r in runs.items():
        want = {n: (SHAPES_STEPS if n == "fused_step" else 0)
                for n in counters}
        if r["launches"] != want or not r["finite"]:
            raise RuntimeError(f"shapes {key}: launches {r['launches']} "
                               f"(expected {want}), finite {r['finite']}")
        if not r["lowest_centre_m_every_25_steps"] > 0.0:
            raise RuntimeError(f"shapes {key}: a body's centre went below "
                               f"the ground")
        low = r["lowest_point_m"]["every_25_steps"]
        if key.split(".")[0] in SHAPES_SINK_GATED and not low >= \
                -SHAPES_SINK_TOL:
            raise RuntimeError(f"shapes {key}: a body sank {-low} m into "
                               f"the ground")
    big = f"mixed_shape_drop.B{SHAPES_BATCHES[-1]}"
    return {
        "name": "fused_step_shapes", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_pos"],
                               c["err_rot"], c["err_imp"])
                           for c in checks.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None}


# ---------------------------------------------------------------------------
# the golden fidelity row on fused_seq (bench.py's bench_fidelity_seq)

FIDELITY_STEPS = 1000                     # tests/test_golden_trajectories.py
FIDELITY_EVERY = 25                       # GOLDEN_STEPS, GOLDEN_EVERY
FIDELITY_DT = 1.0 / 120.0
FIDELITY_TOL = 1e-3                       # BASELINE: 1e-3 over 1k steps
# scenes gated only on their first checkpoints, and why
FIDELITY_SHORT = {"box_stack": 1, "ragdoll_settle": 2, "mixed_shape_drop": 10}
FIDELITY_SHORT_REASON = (
    "the goldens are the JAX package's scan path on the CPU, and its fused_seq "
    "path (what the port reproduces: stepped on the CPU from the same state, "
    "the JAX package's fused_seq and the port's plain version agree step for "
    "step on box_stack from the start and on the mixed drop from steps 140 "
    "and 300, tools/fused_seq_vs_jax_cpu.py, PERF.md) leaves them where "
    "bodies tumble: box_stack's impacts grow a 1e-11 difference of the two "
    "paths on step 1 to 7e-4 by step 25 (JAX fused_seq: 6.2e-4 from the "
    "golden at step 25, 1.34e-3 at 50), the ragdoll settles chaotically "
    "(0.288 on a TPU, docs/FIDELITY.md), and in the "
    "mixed drop the capsule starts to tumble at step ~300 and the cylinder "
    "rolls off the ramp's edge at ~780 (held over 250 steps, the horizon of "
    "bench.py's bench_fidelity_seq for it and of the JAX package's TPU "
    "record, 6.5e-5); ROADMAP standing note 2. The whole horizon's deviation "
    "is printed")
FIDELITY_KERNEL_TOL = 1e-6
FIDELITY_KERNEL_TOL_REASON = (
    "absolute on velocities, impulses and live masks: the plain version "
    "solves in the kernel's order with no index_add_, so the two run the same "
    "float32 operations in the same order (0.0 expected)")
FIDELITY_CHECK_BATCHES = (1, 256)
FIDELITY_RAGGED = {"ragdoll_settle": 1000, "constraint_zoo": 1000}
FIDELITY_WARM = 60
# later compared states of the scenes whose bodies land after 60 steps
FIDELITY_LATE = {"sphere_bounce": 150, "mixed_shape_drop": 150}
FIDELITY_TIMED = ("ragdoll_settle", "constraint_zoo")
FIDELITY_TIMED_BATCH = 4096
FIDELITY_LIBRARY_REASON = ("no single PyTorch call computes the fused step "
                           "or a sequential constraint solve")


def _envs(inputs, lo, hi):
    """Envs lo:hi of kernel_inputs' batched tensors."""
    import dataclasses
    from types import SimpleNamespace
    bodies, wcol, joints, inv_dt, passed = inputs
    sl = slice(lo, hi)
    b = bodies.replace(**{k: getattr(bodies, k)[sl] for k in (
        "rot", "pos_cog", "inv_inertia", "v", "w")})
    w = SimpleNamespace(a=wcol.a[sl], b=wcol.b[sl], rot=wcol.rot[sl])
    j = joints[sl] if isinstance(joints, torch.Tensor) \
        else tuple(t[sl] for t in joints)
    if passed is not None:
        passed = dataclasses.replace(passed, **{
            f.name: getattr(passed, f.name)[sl]
            for f in dataclasses.fields(passed) if f.name != "phase_sizes"})
    return b, w, j, inv_dt, passed


def hold_modes(scene, states, dt, sequential, prep_in_kernel=False):
    """Kernel vs plain version for each of `states` ({name: state}), one
    plain call over all of them put side by side (its cost is the number
    of its eager launches, not the batch), one kernel launch per state at
    that state's batch. Returns {name: check}."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    names = list(states)
    cat = states[names[0]].replace(**{
        k: torch.cat([getattr(states[n], k) for n in names])
        for k in ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                  "torque_acc")}, controls=type(states[names[0]].controls)(**{
            k: torch.cat([getattr(states[n].controls, k) for n in names])
            for k in vars(states[names[0]].controls)}))
    inputs = kernel_inputs(scene, cat, dt, prep_in_kernel)
    bodies, wcol, joints, inv_dt, passed = inputs
    tab = fs.fused_tables(scene, DEVICE)
    tables = None if prep_in_kernel else joints
    pvw, pimp, plive = fs._fused_core(
        tab, ITERATIONS, 1.0, inv_dt, torch.cat([bodies.v, bodies.w], -1),
        bodies.inv_mass, bodies.inv_inertia, bodies.pos_cog, bodies.rot,
        joints if prep_in_kernel else None, wcol.a, wcol.b, wcol.rot,
        joint_tables=tables, sequential=sequential, passed=passed)
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0,
                                       sequential=sequential,
                                       joint_prep_in_kernel=prep_in_kernel)
    out, lo = {}, 0
    for n in names:
        hi = lo + states[n].pos.shape[0]
        kv, kw, kimp, klive = solver(*_envs(inputs, lo, hi))
        torch.cuda.synchronize()
        out[n] = dict(
            batch=hi - lo,
            err_v=float((kv - pvw[lo:hi, :, :3]).abs().max()),
            err_w=float((kw - pvw[lo:hi, :, 3:]).abs().max()),
            err_imp=float((kimp - pimp[lo:hi]).abs().max()),
            mask_mismatch=int((klive != plive[lo:hi]).sum()),
            live_rows=int((klive != 0).sum()),
            moved_velocities_by=float(torch.maximum(
                (kv - bodies.v[lo:hi]).abs().max(),
                (kw - bodies.w[lo:hi]).abs().max())),
            v_scale=max(1.0, float(pvw[lo:hi, :, :3].abs().max())),
            w_scale=max(1.0, float(pvw[lo:hi, :, 3:].abs().max())),
            imp_scale=max(1.0, float(pimp[lo:hi].abs().max())),
            finite=bool(torch.isfinite(kv).all() and torch.isfinite(kw).all()
                        and torch.isfinite(kimp).all()))
        lo = hi
    return out


def golden_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden", f"{name}.npy")


def fidelity_phase(seed, loco):
    """The golden fidelity row on fused_seq: the prepped library held
    against its plain version on the six golden scenes in both of its modes
    (and "fused" with joint rows prepared outside the kernel on the zoo
    chain and on `loco` = (scene, state) of the loco env), then each golden
    scene 1000 steps at one env through physics_step, held against
    tests/golden/<name>.npy, then the kernel's times."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    scenes = {n: shapes_scene(n) for n in GOLDEN_SCENES}
    seq = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                          solver_mode="fused_seq")

    # ---- kernel vs plain version: one env at the golden start and B=256
    # (and a ragged 1000) with velocity noise, initial and after 60 steps
    # (and 150, where bodies land later)
    checks = {}
    for name, scene in scenes.items():
        start = {"B1": scene.initial_state(1)}
        for b in FIDELITY_CHECK_BATCHES[1:] + (
                (FIDELITY_RAGGED[name],) if name in FIDELITY_RAGGED else ()):
            start[f"B{b}"] = shapes_initial_state(scene, b, seed)
        states = {f"{k}_initial": v for k, v in start.items()}
        warm = {FIDELITY_WARM, FIDELITY_LATE.get(name, FIDELITY_WARM)}
        for k, st in start.items():
            for t in range(1, max(warm) + 1):
                st, _info = physics_step(scene, st, seq, FIDELITY_DT)
                if t in warm:
                    states[f"{k}_after_{t}_steps"] = st
        for k, c in hold_modes(scene, states, FIDELITY_DT, True).items():
            checks[f"{name}.fused_seq.{k}"] = c
        if name == "constraint_zoo":
            for k, c in hold_modes(scene, states, FIDELITY_DT,
                                   False).items():
                checks[f"{name}.fused_prepped.{k}"] = c
    loco_scene, loco_state = loco
    n = FIDELITY_RAGGED["ragdoll_settle"]
    sub = loco_state.replace(**{
        k: getattr(loco_state, k)[:n].contiguous() for k in (
            "pos", "rot", "lin_vel", "ang_vel", "force_acc", "torque_acc")},
        controls=type(loco_state.controls)(**{
            k: v[:n].contiguous() for k, v in vars(loco_state.controls).items()}))
    for k, c in hold_modes(loco_scene, {f"B{n}": sub}, FIDELITY_DT,
                           False).items():
        checks[f"loco.fused_prepped.{k}"] = c

    # ---- the fidelity row: each golden scene, 1000 steps at one env,
    # counts from zero just before it
    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    rows, total_steps, total_secs = {}, 0, 0.0
    for name, scene in scenes.items():
        st = scene.initial_state(1)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        marks = []
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(FIDELITY_STEPS):
            st, _info = physics_step(scene, st, seq, FIDELITY_DT)
            finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.rot).all() & torch.isfinite(st.lin_vel).all()
            if t % FIDELITY_EVERY == FIDELITY_EVERY - 1:
                marks.append(torch.cat([st.pos[0].reshape(-1),
                                        st.rot[0].reshape(-1)]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: mod.launch_count() for k, mod in counters.items()}
        launches["fused_step.prepped"] = fs.launch_count("prepped")
        traj = torch.stack(marks).double().cpu().numpy()
        golden = np.load(golden_path(name))[:len(traj)]
        if traj.shape != golden.shape:
            raise RuntimeError(f"fidelity {name}: trajectory of shape "
                               f"{traj.shape}, golden {golden.shape}")
        dev = np.abs(traj - golden).max(axis=1)
        gated = FIDELITY_SHORT.get(name, len(dev))
        rows[name] = dict(
            steps=FIDELITY_STEPS, seconds=secs,
            steps_per_s=FIDELITY_STEPS / secs, launches=launches,
            finite=bool(finite), checkpoints=len(dev),
            gated_checkpoints=gated, max_dev_gated=float(dev[:gated].max()),
            max_dev_all=float(dev.max()),
            dev_every_25_steps=[float(x) for x in dev])
        total_steps += FIDELITY_STEPS
        total_secs += secs

    # ---- the kernel at 4096 envs on two scenes after 60 steps
    timing = {}
    for name in FIDELITY_TIMED:
        scene = scenes[name]
        st = shapes_initial_state(scene, FIDELITY_TIMED_BATCH, seed + 1)
        for _ in range(FIDELITY_WARM):
            st, _info = physics_step(scene, st, seq, FIDELITY_DT)
        inputs = kernel_inputs(scene, st, FIDELITY_DT, False)
        bodies, wcol, joints, inv_dt, _passed = inputs
        tab = fs.fused_tables(scene, DEVICE)
        t = {}
        for iters in (0, ITERATIONS):
            solver = fs.make_fused_step_solver(
                scene, iters, 1.0, sequential=True, joint_prep_in_kernel=False)
            for _ in range(3):
                out = solver(bodies, wcol, joints, inv_dt)
            t[f"ms_{iters}_iterations"] = time_ms(
                lambda: solver(bodies, wcol, joints, inv_dt), 20)
        klive = out[3]

        def run_plain():
            return fs._fused_core(
                tab, ITERATIONS, 1.0, inv_dt,
                torch.cat([bodies.v, bodies.w], -1), bodies.inv_mass,
                bodies.inv_inertia, bodies.pos_cog, bodies.rot, None, wcol.a,
                wcol.b, wcol.rot, joint_tables=joints, sequential=True)
        work = recipe_flops(tab, fs.recipe_branches(tab, wcol.a, wcol.b,
                                                    wcol.rot)
                            if any(m["key"] in fs.BRANCH_RECIPES
                                   for m in tab.metas) else {},
                            FIDELITY_TIMED_BATCH)
        b_ms, b_by, b_detail = bound_ms(tab, klive, FIDELITY_TIMED_BATCH,
                                        work, prepped=True, sequential=True)
        timing[name] = dict(
            batch=FIDELITY_TIMED_BATCH, ms=t[f"ms_{ITERATIONS}_iterations"],
            **t, plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
            bound_by=b_by, bound_detail=b_detail, library_ms=None,
            library_reason=FIDELITY_LIBRARY_REASON,
            live_rows_per_env=float((klive != 0).sum()) / FIDELITY_TIMED_BATCH)

    emit("fidelity", scenes={
        n: dict(bodies=s.num_bodies,
                pair_rows=fs.fused_tables(s, DEVICE).num_rows,
                joints=fs.fused_tables(s, DEVICE).joint_counts,
                threads=fs.fused_tables(s, DEVICE).threads(),
                smem_bytes=fs.fused_tables(s, DEVICE).shared_floats() * 4)
        for n, s in scenes.items()},
         iterations=ITERATIONS, dt=FIDELITY_DT, tolerance=FIDELITY_TOL,
         short_gated=FIDELITY_SHORT, short_reason=FIDELITY_SHORT_REASON,
         kernel_tolerance=FIDELITY_KERNEL_TOL,
         kernel_tolerance_reason=FIDELITY_KERNEL_TOL_REASON, checks=checks,
         rows=rows, row_steps_per_s=total_steps / total_secs, kernel=timing)

    bad = [k for k, c in checks.items()
           if not (c["finite"] and c["mask_mismatch"] == 0
                   and max(c["err_v"], c["err_w"], c["err_imp"])
                   <= FIDELITY_KERNEL_TOL)]
    if bad:
        raise RuntimeError(f"fidelity: the prepped kernel disagrees with its "
                           f"plain version in {bad}")
    if not any(c["live_rows"] for k, c in checks.items()
               if ".fused_seq." in k):
        raise RuntimeError("fidelity: no live contact row in the compared "
                           "states")
    for name, r in rows.items():
        want = {k: (FIDELITY_STEPS if k in ("fused_step",
                                            "fused_step.prepped") else 0)
                for k in r["launches"]}
        if r["launches"] != want or not r["finite"]:
            raise RuntimeError(f"fidelity {name}: launches {r['launches']} "
                               f"(expected {want}), finite {r['finite']}")
        if not r["max_dev_gated"] < FIDELITY_TOL:
            raise RuntimeError(
                f"fidelity {name}: {r['max_dev_gated']} from the golden "
                f"trajectory over its first {r['gated_checkpoints']} "
                f"checkpoints (gate {FIDELITY_TOL})")
    big = timing["ragdoll_settle"]
    return {
        "name": "fused_step_prepped", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": sum(r["launches"]["fused_step.prepped"]
                        for r in rows.values()),
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_imp"])
                           for c in checks.values()),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}


# ---------------------------------------------------------------------------
# heightfield terrain under a ragdoll and shape debris on the fused step

TERRAIN_DT = 1.0 / 120.0
TERRAIN_NODES = 33                        # bench.py:372-376 (config 4)
TERRAIN_CELL = 1.0
TERRAIN_CORNER = (-16.0, 0.0, -16.0)
# shape debris, clear of the ragdoll, each dropped into a basin of the terrain
# (its lowest point 0.5 m above the basin's floor at -0.4 m): (kind, size,
# centre x, z); window K 2, 4, 2 and 8 on the 1 m cells
TERRAIN_DEBRIS = (("sphere", 0.2, 7.56, 3.63), ("box", 0.35, -8.15, -12.07),
                  ("cylinder", (0.25, 0.2), 7.56, -12.07),
                  ("sphere", 1.6, -8.15, 3.63))


def terrain_heights():
    """bench.py:372-376, copied: 33 x 33 nodes, H = 0.4 sin(0.4 i) cos(0.4 j)
    at row i, column j (rows run along z, columns along x)."""
    xs, zs = np.meshgrid(np.arange(TERRAIN_NODES), np.arange(TERRAIN_NODES),
                         indexing="ij")
    return (0.4 * np.sin(xs * 0.4) * np.cos(zs * 0.4)).astype(np.float32)


def terrain_builder(builder, add_ragdoll=None):
    """BASELINE config 4's terrain (bench.py:372-376: cell 1.0, friction 1.0,
    window 8) with no ground box under config 3's ragdoll (bench.py:340,
    hip at (0, 1.6, 0)) and four pieces of shape debris (TERRAIN_DEBRIS): a
    0.2 m sphere, a box of half extent 0.35 m, a cylinder of radius 0.25 m
    and half length 0.2 m lying on its side, and a 1.6 m sphere. Without
    `add_ragdoll`, the debris alone. `builder` is a SceneBuilder class and
    `add_ragdoll` its package's ragdoll; the result is finalized by the
    caller with no arguments (uncapped static tables)."""
    b = builder()
    b.set_heightfield(terrain_heights(), cell_size=TERRAIN_CELL,
                      min_corner=TERRAIN_CORNER, friction=1.0, window=8)
    if add_ragdoll is not None:
        add_ragdoll(b, initial_hip_position=(0.0, 1.6, 0.0))
    for kind, size, x, z in TERRAIN_DEBRIS:
        low = -0.4 + 0.5
        if kind == "sphere":
            body = b.add_body(position=(x, low + size, z))
            b.add_sphere_collider(body, (0, 0, 0), size)
        elif kind == "box":
            body = b.add_body(position=(x, low + size, z))
            b.add_box_collider(body, (0, 0, 0), (size, size, size))
        else:
            r, half = size
            body = b.add_body(position=(x, low + r, z))
            b.add_cylinder_collider(body, (-half, 0, 0), (half, 0, 0), r)
    return b


def terrain_scene(device=DEVICE):
    from dxk_tpu_torch.models.ragdoll import add_ragdoll
    from dxk_tpu_torch.scene import SceneBuilder
    return terrain_builder(SceneBuilder, add_ragdoll).finalize(device=device)


def terrain_initial_state(scene, batch, seed):
    """`batch` envs of the drop with the seeded 0.01 m/s velocity noise of
    zoo_initial_state."""
    return zoo_initial_state(scene, batch, seed)


def terrain_lowest(scene, w):
    """Each collider's lowest support point (B, C, 3) by its shape type, as
    the terrain's safety contact finds it (ops/heightmap.py); hulls get the
    collider's position."""
    from dxk_tpu_torch.ops.heightmap import lowest_support
    out = w.a.clone()
    for code, tag in ((0, "sphere"), (1, "capsule"), (2, "cylinder"),
                      (3, "box")):
        m = w.ctype == code
        if bool(m.any()):
            out[:, m] = lowest_support(tag, w.a[:, m], w.b[:, m],
                                       w.r[m].expand(w.a.shape[0], -1),
                                       w.rot[:, m])
    return out


def terrain_poses(scene, batch, seed):
    """`batch` envs of the terrain scene set down into the terrain: the
    ragdoll as one rigid piece (moved by up to 4 m across the terrain, its
    initial pose kept), each piece of debris on its own (moved by up to 1 m
    and tilted by up to 40 degrees), each lowered until its lowest support
    point is a seeded 0-3 cm below the terrain there (about one piece in
    four 0-1 cm above it instead), which makes the safety contact live.
    Velocities get the seeded noise of terrain_initial_state."""
    from dxk_tpu_torch.core.maths import quat_mul
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.shapes import world_colliders
    st = terrain_initial_state(scene, batch, seed)
    rng = np.random.default_rng(seed)
    dev = st.pos.device
    pos, rot = st.pos.clone(), st.rot.clone()
    joined = sorted({int(x) for n in ("hinge", "cone_twist")
                     if getattr(scene, n) is not None
                     for x in torch.cat([getattr(scene, n).body_a,
                                         getattr(scene, n).body_b]).tolist()
                     if x < scene.num_bodies})
    pieces = ([joined] if joined else []) + [
        [n] for n in range(scene.num_bodies) if n not in joined]
    for piece in pieces:
        reach = 4.0 if len(piece) > 1 else 1.0
        shift = torch.from_numpy(rng.uniform(-reach, reach, (batch, 1, 3))
                                 * np.array([1.0, 0.0, 1.0])).float().to(dev)
        pos[:, piece] += shift
        if len(piece) == 1:
            axis = rng.normal(size=(batch, 3))
            ang = np.radians(rng.uniform(0, 40, batch))
            q = torch.from_numpy(np.concatenate(
                [axis / np.linalg.norm(axis, axis=-1, keepdims=True)
                 * np.sin(ang / 2)[:, None], np.cos(ang / 2)[:, None]],
                -1)).float().to(dev)
            rot[:, piece[0]] = quat_mul(q, rot[:, piece[0]])
    w = world_colliders(scene, pos, rot)
    low = terrain_lowest(scene, w)
    body = scene.colliders.body.long()
    for piece in pieces:
        cols = [c for c in range(body.shape[0]) if int(body[c]) in piece]
        gap = low[:, cols, 1] - height_at(scene.heightfield,
                                          low[:, cols, 0], low[:, cols, 2])
        depth = torch.from_numpy(np.where(rng.uniform(size=batch) < 0.25,
                                          -rng.uniform(0, 0.01, batch),
                                          rng.uniform(0, 0.03, batch))
                                 ).float().to(dev)
        pos[:, piece, 1] -= (gap.amin(dim=1) + depth)[:, None]
    return st.replace(pos=pos, rot=rot)


TERRAIN_BATCHES = (256, 4096)             # bench.py's on-chip batch; 4096
TERRAIN_RAGGED = 1000
TERRAIN_STEPS = 600
TERRAIN_WARM = 60
TERRAIN_PROFILED = 3                      # steps under torch.profiler
TERRAIN_TAGS = ("sphere", "capsule", "box", "cylinder")
TERRAIN_WINDOWS = (2, 4, 8)
TERRAIN_TOL_REASON = (
    "velocities and impulses held relative to the largest one (at least 1): "
    "the 1.6 m debris sphere weighs 17 t, so its terrain impulses reach ~1e3, "
    "where a float32 ulp is 1e-4, and in the averaged solve the plain version "
    "sums per-body deltas with index_add_ atomics in no fixed order on the "
    "card; live masks exactly")
TERRAIN_SINK_TOL = 0.25                   # m below the terrain, any centre
TERRAIN_SINK_REASON = (
    "no dynamic body's centre deeper than 0.25 m below the terrain height at "
    "its (x, z) at any 25th step: a body through the terrain falls 0.25 m in "
    "27 steps. Centres do dip below the surface: the ragdoll's limbs and "
    "torso sink into it on impact and come back (the reference's soft "
    "contact, Baumgarte factor 0.1, and capsule-triangle normals that point "
    "down once the axis is below the surface), up to 0.128 m at 4096 envs on "
    "an H100; the JAX package does the same: tools/replay_shapes_state_cpu.py "
    "--run terrain.B4096 steps both packages from a state with the toes' "
    "centre 4.8 cm below the terrain to positions 2.4e-7 apart, the toes "
    "still 1.9 cm below after 3 steps (PERF.md)")


def terrain_counts(scene, inputs, live):
    """Live terrain rows by shape tag and by window K (heightfield_plan's
    buckets) and live safety-contact points, from the live bits `live`
    (B, P) of a solve on kernel_inputs `inputs`: a safety contact is the
    slot-3 point of a collider whose lowest support point lies below the
    terrain there."""
    from dxk_tpu_torch.ops.heightmap import height_at, heightfield_plan
    _bodies, wcol, *_rest = inputs
    C = scene.colliders.ctype.shape[0]
    rows = live[:, -C:].to(torch.int32)
    by_tag, by_k = {}, {}
    for tag, K, idx in heightfield_plan(scene)["groups"]:
        n = int((rows[:, torch.from_numpy(idx).to(rows.device)] != 0).sum())
        by_tag[tag] = by_tag.get(tag, 0) + n
        by_k[K] = by_k.get(K, 0) + n
    low = terrain_lowest(scene, wcol)
    below = low[..., 1] < height_at(scene.heightfield, low[..., 0],
                                    low[..., 2])
    safety = int((below & ((rows >> 3) & 1).bool()).sum())
    return by_tag, by_k, safety


def profile_steps(step, n):
    """Device busy ms, device kernel launches and fused-step kernel ms per
    call of `step` over `n` calls under torch.profiler, and the top device
    kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side events only: an operator's row repeats the time of
        # the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    return dict(
        device_busy_ms_per_step=sum(r[1] for r in rows) / 1e3 / n,
        fused_kernel_ms_per_step=sum(
            r[1] for r in rows if "fused_step_kernel" in r[0]) / 1e3 / n,
        device_launches_per_step=sum(r[2] for r in rows) / n,
        top_device_kernels=[{"name": r[0][:80], "ms_per_step": r[1] / 1e3 / n,
                             "calls_per_step": r[2] / n} for r in rows[:8]])


def terrain_phase(seed):
    """BASELINE config 4's heightfield terrain under config 3's ragdoll and
    shape debris on the fused step, its terrain rows prepared outside the
    kernel and passed in (the prepped library): kernel vs plain version in
    both solve modes, every terrain tag, window and the safety contact live,
    then the main path at each batch."""
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    t_phase = time.perf_counter()
    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene = terrain_scene()
    tab = fs.fused_tables(scene, DEVICE)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")

    def gaps(st):
        """Each dynamic body's centre height over the terrain there."""
        p = st.pos[:, :scene.num_bodies]
        return p[..., 1] - height_at(scene.heightfield, p[..., 0], p[..., 2])

    # ---- kernel vs plain version, both modes: bench's batch and a ragged
    # one, initial and after TERRAIN_WARM steps, and the terrain poses
    states = {}
    for batch in (TERRAIN_BATCHES[0], TERRAIN_RAGGED):
        st = terrain_initial_state(scene, batch, seed)
        states[f"B{batch}_initial"] = st
        for _ in range(TERRAIN_WARM):
            st, _info = physics_step(scene, st, settings, TERRAIN_DT)
        states[f"B{batch}_after_{TERRAIN_WARM}_steps"] = st
    states["terrain_poses"] = terrain_poses(scene, TERRAIN_BATCHES[0], seed)
    checks = {
        "fused": hold_modes(scene, states, TERRAIN_DT, False,
                            prep_in_kernel=True),
        "fused_seq": hold_modes(scene, states, TERRAIN_DT, True)}
    by_tag, by_k, safety = {}, {}, 0
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0)
    for st in states.values():
        inputs = kernel_inputs(scene, st, TERRAIN_DT)
        t, k, n = terrain_counts(scene, inputs, solver(*inputs)[3])
        for key, v in t.items():
            by_tag[key] = by_tag.get(key, 0) + v
        for key, v in k.items():
            by_k[key] = by_k.get(key, 0) + v
        safety += n

    # ---- the main path at each batch, counts from zero just before it
    runs, timing = {}, {}
    for batch in TERRAIN_BATCHES:
        st = terrain_initial_state(scene, batch, seed + 1)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        above = torch.full((scene.num_bodies,), float("inf"), device=DEVICE)
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TERRAIN_STEPS):
            st, _info = physics_step(scene, st, settings, TERRAIN_DT)
            finite &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
            if i % 25 == 24:
                above = torch.minimum(above, gaps(st).amin(dim=0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        launches["fused_step.prepped"] = fs.launch_count("prepped")
        holder = [st]

        def step():
            holder[0] = physics_step(scene, holder[0], settings,
                                     TERRAIN_DT)[0]
        prof = profile_steps(step, TERRAIN_PROFILED)
        # the env whose body centre ends deepest below the terrain, for a
        # replay on the CPU (tools/replay_shapes_state_cpu.py --run
        # terrain.B<batch>)
        end = gaps(st)
        env, body = divmod(int(end.argmin()), scene.num_bodies)
        deepest = dict(env=env, body=body, centre_over_terrain_m=float(
            end[env, body]), **{k: getattr(st, k)[env].tolist() for k in (
                "pos", "rot", "lin_vel", "ang_vel")})
        runs[batch] = dict(
            steps=TERRAIN_STEPS, seconds=secs,
            body_steps_per_s=scene.num_bodies * batch * TERRAIN_STEPS / secs,
            ms_per_step=secs / TERRAIN_STEPS * 1e3, launches=launches,
            finite=bool(finite),
            min_centre_over_terrain_m=[float(x) for x in above],
            end_centres_below_terrain=int((end < 0).sum()),
            deepest_env_state=deepest,
            **{k: v for k, v in prof.items() if k != "top_device_kernels"},
            device_idle_share=1.0 - prof["device_busy_ms_per_step"]
            / (secs / TERRAIN_STEPS * 1e3))
        # the kernel at this batch on the state after the run
        inputs = kernel_inputs(scene, st, TERRAIN_DT)
        bodies, wcol, ctl, inv_dt, passed = inputs
        for _ in range(3):
            out = solver(*inputs)
        klive = out[3]

        def run_plain():
            return fs._fused_core(
                tab, ITERATIONS, 1.0, inv_dt,
                torch.cat([bodies.v, bodies.w], -1), bodies.inv_mass,
                bodies.inv_inertia, bodies.pos_cog, bodies.rot, ctl, wcol.a,
                wcol.b, wcol.rot, passed=passed)
        work = recipe_flops(tab, fs.recipe_branches(tab, wcol.a, wcol.b,
                                                    wcol.rot), batch)
        b_ms, b_by, b_detail = bound_ms(tab, klive, batch, work,
                                        prepped=False)
        timing[batch] = dict(ms=time_ms(lambda: solver(*inputs), 20),
                             plain_ms=time_ms(run_plain, 2), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail,
                             recipe_flops=work,
                             live_terrain_rows=int(
                                 (klive[:, -tab.num_colliders:] != 0).sum()))

    # ---- one fused_seq kernel call at the largest batch, on its state after
    # the run, at 0 and at 30 iterations (joint rows prepared outside)
    big = TERRAIN_BATCHES[-1]
    seq_inputs = kernel_inputs(scene, st, TERRAIN_DT, False)
    seq = {}
    for iters in (0, ITERATIONS):
        sol = fs.make_fused_step_solver(scene, iters, 1.0, sequential=True,
                                        joint_prep_in_kernel=False)
        for _ in range(3):
            out = sol(*seq_inputs)
        seq[f"ms_{iters}_iterations"] = time_ms(lambda: sol(*seq_inputs), 5)
    seq["bound_ms"], seq["bound_by"], _d = bound_ms(
        tab, out[3], big, recipe_flops(tab, fs.recipe_branches(
            tab, seq_inputs[1].a, seq_inputs[1].b, seq_inputs[1].rot), big),
        prepped=True, sequential=True)
    seconds = time.perf_counter() - t_phase
    emit("terrain", bodies=scene.num_bodies, colliders=tab.num_colliders,
         pair_rows=tab.num_rows - tab.num_colliders,
         terrain_rows=tab.num_colliders, joints=tab.joint_counts,
         heightfield=dict(nodes=list(scene.heightfield.size),
                          cell=scene.heightfield.cell_size,
                          window=scene.heightfield.window),
         iterations=ITERATIONS, dt=TERRAIN_DT, threads=tab.threads(),
         smem_bytes=tab.shared_floats() * 4, tolerance=KERNEL_TOL,
         tolerance_reason=TERRAIN_TOL_REASON, checks=checks,
         live_terrain_rows_by_tag=by_tag,
         live_terrain_rows_by_window={str(k): v for k, v in by_k.items()},
         live_safety_points=safety, sink_tol=TERRAIN_SINK_TOL,
         sink_reason=TERRAIN_SINK_REASON,
         runs=runs, kernel=timing, kernel_fused_seq=seq, seconds=seconds)
    for mode, cs_ in checks.items():
        for name, c in cs_.items():
            worst = max(c["err_v"] / c["v_scale"], c["err_w"] / c["w_scale"],
                        c["err_imp"] / c["imp_scale"])
            if (not c["finite"] or c["mask_mismatch"]
                    or not worst <= KERNEL_TOL):
                raise RuntimeError(f"terrain {mode} {name}: the kernel "
                                   f"disagrees with its plain version: {c}")
    dead = ([t for t in TERRAIN_TAGS if by_tag.get(t, 0) == 0]
            + [f"K{k}" for k in TERRAIN_WINDOWS if by_k.get(k, 0) == 0]
            + ([] if safety else ["safety"]))
    if dead:
        raise RuntimeError(f"terrain: never live in the compared states: "
                           f"{dead}")
    for batch, r in runs.items():
        want = {n: (TERRAIN_STEPS if n == "fused_step" else 0)
                for n in counters}
        want["fused_step.prepped"] = TERRAIN_STEPS
        if r["launches"] != want or not r["finite"]:
            raise RuntimeError(f"terrain B={batch}: launches {r['launches']} "
                               f"(expected {want}), finite {r['finite']}")
        if not min(r["min_centre_over_terrain_m"]) > -TERRAIN_SINK_TOL:
            raise RuntimeError(f"terrain B={batch}: a body's centre went "
                               f"{TERRAIN_SINK_TOL} m below the terrain: {r}")
    return {
        "name": "fused_step_terrain", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step.prepped"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_imp"])
                           for cs_ in checks.values() for c in cs_.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600,
                    help="env steps of each serve rollout (at least 120)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.steps < 120:
        raise SystemExit("--steps must be at least 120")

    # the port first: without it nothing is printed at all
    from dxk_tpu_torch.envs.loco_env import LocoEnv
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    smi = device_phase()
    build_phase()

    torch.manual_seed(args.seed)
    env = LocoEnv(solver_mode="fused", solver_iterations=ITERATIONS,
                  torso_velocity_target=(1.0, 0.0, 0.0), device="cuda")
    net = load_policy(env)

    # ---- kernels: states after a rollout, so contacts of all three pair
    # groups and joint limits are live
    from dxk_tpu_torch.models.policy import policy_apply
    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed + 1)
    st, obs = env.reset(NUM_ENVS)
    for _ in range(WARM_STEPS):
        st, obs, _r, _d = env.step(st, policy_apply(net, obs), gen)
    torch.cuda.synchronize()
    state = st.physics
    from dxk_tpu_torch.envs.loco_env import DT
    cmp_full, run_kernel, run_plain, tab, live = compare_kernel(
        env.scene, state, NUM_ENVS, DT)
    cmp_ragged = compare_kernel(env.scene, state, RAGGED_ENVS, DT)[0]
    # the same scene with each pair group in a contact phase of its own, so
    # that the kernel's sequential phase slices run too
    phased = env.scene.replace(pair_groups=tuple(
        g.replace(phase=i) for i, g in enumerate(env.scene.pair_groups)))
    cmp_phased = compare_kernel(phased, state, RAGGED_ENVS, DT)[0]
    for _ in range(3):
        run_kernel()
    kernel_ms = time_ms(run_kernel, 20)
    plain_ms = time_ms(run_plain, 2)
    kernel_ms2 = time_ms(run_kernel, 20)
    b_ms, b_by, b_detail = bound_ms(tab, live, NUM_ENVS)
    emit("kernels", tolerance=KERNEL_TOL, tolerance_reason=TOL_REASON,
         full=cmp_full, ragged=cmp_ragged, phased=cmp_phased,
         kernel_ms=kernel_ms,
         kernel_ms_again=kernel_ms2, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, bound_detail=b_detail,
         threads=tab.threads(), smem_bytes=tab.shared_floats() * 4)
    for c in (cmp_full, cmp_ragged, cmp_phased):
        hold_fused(c)
        if min(c["live_rows_by_recipe"].values()) == 0:
            raise RuntimeError(f"a contact recipe has no live row in the "
                               f"compared states: {c}")

    # ---- serve: the main path, launches counted from zero
    fs.reset_launch_count()
    pol = rollout(env, net, args.steps, args.seed + 2)
    launches = fs.launch_count()
    zero = rollout(env, None, args.steps, args.seed + 2)
    emit("serve", envs=NUM_ENVS, iterations=ITERATIONS, pokes=True,
         obs_size=env.obs_size, policy=pol, zero_action=zero,
         kernel_launches=launches,
         launches_per_env_step=launches / args.steps)
    if launches != args.steps:
        raise RuntimeError(f"main path launched the kernel {launches} times "
                           f"in {args.steps} env steps")
    if not pol["mean_survival_s"] >= zero["mean_survival_s"]:
        raise RuntimeError("the trained policy survives no longer than zero "
                           "actions in the port's simulator")

    # ---- the constraint zoo on the fused step
    zoo_kernel = zoo_phase(args.seed + 4)

    # ---- the ragdoll settle with its hull debris on the fused step
    settle_kernel = settle_phase(args.seed + 5)

    # ---- the golden mixed-shape drop and sphere bounce on the fused step
    shapes_kernel = shapes_phase(args.seed + 6)

    # ---- the golden fidelity row on fused_seq
    fidelity_kernel = fidelity_phase(args.seed + 7, (env.scene, state))

    # ---- heightfield terrain under a ragdoll and shape debris
    terrain_kernel = terrain_phase(args.seed + 8)

    # ---- the box stack on the reference step, each broadphase
    box_kernels = box_stack_phase(args.seed + 3)

    print(json.dumps({"kernels": [{
        "name": "fused_step", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": launches, "max_abs_err": max(
            cmp_full[k] for k in ("err_v", "err_w", "err_pos", "err_rot",
                                  "err_imp")),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}, zoo_kernel, settle_kernel,
        shapes_kernel, fidelity_kernel, terrain_kernel]
        + box_kernels}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
