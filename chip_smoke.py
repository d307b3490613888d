"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls,
after building the hand-written CUDA kernels from the sources in this
checkout and holding each against its plain PyTorch version on the card:
  - a batch of ragdoll locomotion environments stepped in lockstep by the
    trained walking policy (the fused step);
  - BASELINE config 5's trainer: on-device PPO of 4096 ragdoll envs
    through the training entry point (dxk_tpu_torch.train.train_locomotion,
    64-step rollouts on the fused step, then PPO's updates);
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
  - the same scene with config 4's 12 x 12 cloth and a second, thick one
    that falls on the ragdoll and the terrain (config 4 without its
    vehicle), 128 and 4096 envs, "colored" cloth with two-way coupling;
  - BASELINE config 4 whole (bench.py:354-396): the gear-driven vehicle
    and the 12 x 12 sheet on the terrain, pruned by orbit_margin=0.5, the
    motor driven, 128 and 4096 envs; then a trigger volume and an owned
    force field;
  - a 1,081-row pile of 46 boxes, 256 and 1000 envs, on the fused step;
  - bench.py's 1k-box stack (64 towers of 16 boxes, 32 envs) on the
    reference step under each of the three broadphases (table, K-select,
    sort-and-sweep);
  - the same stack on BASELINE config 1's default path: islandize makes
    its 64 towers 64 island envs a world, and the fused step steps the
    32 worlds' 2,048 island envs in one launch; then the engine services
    (the gym adapter, validate, editor picking) on the card;
  - the JAX package's entry() configuration, the ragdoll locomotion env
    on the reference step in "scan" (sequential impulses, 10 iterations,
    capped narrowphase tables), 4096 envs;
  - the demo scene (dxk_tpu_torch.examples.demo_scene: terrain from
    Perlin noise, falling spheres, a trigger, a ball-joint chain, fire,
    smoke and debris particles, collision sounds, the debug ray-caster) at
    one env as the example runs it and at 1024 envs for a frame; the
    ray-caster on the hull, cylinder and sphere scenes;
  - GJK + EPA on every pairing of the five shapes and skeletal animation
    of 4096 instances.

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
  train      train_locomotion.main on 4096 envs, 64-step rollouts, 30
             solver iterations, 3 iterations into a temporary checkpoint
             directory, then --resume for one more: env-steps/s over
             iterations 2-3, rollout and update seconds, fused-kernel
             launches (exactly iterations x 64, no broadphase launch) and
             Adam updates (exactly epochs x minibatches) an iteration, every
             iteration's metrics; finite metrics and parameters, parameters
             moved, TF32 off, the checkpoint restored bit for bit, --resume
             from its step and parameters; one minibatch update of the
             trained state on the card against the same code on the CPU
             (loss within 1e-5 relative, parameters within 1e-6,
             TRAIN_TOL_REASON); the kernel vs its plain version on the
             trained policy's last state, and its times
  zoo        fused-step kernel vs plain version on zoo states (initial, after
             60 steps, limit poses), live joint limits and motors by type,
             then 600 steps at each batch: launches, finiteness, anchor gaps,
             body-steps/s, the kernel's times and bound
  settle     fused-step kernel vs plain version on settle states (initial,
             after 60 steps, hull poses), on a three-hull pile, on three
             piles of hulls past the kernel's per-thread polytope buffers
             (a 64-vertex hull under a box or under a cylinder, a 24-sided
             prism under a tetrahedron: their buffers in the hull scratch;
             at 256 envs on fresh poses and after 120 steps and at 4096 on
             fresh poses, in the averaged and the sequential solve, one
             plain call over the three; the kernel's times at 256 and 4096)
             and after each main-path run; live
             rows of the hull recipes and their branches; the piles stepped
             120 steps; then 600 steps at each batch: launches,
             finiteness, the debris' height, body-steps/s, the kernel's
             times and bound; a ray poke of the settled 256 envs (a quarter
             of the rays at the hull debris) on the card against the CPU
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
             contacts; then 300 steps at each batch: launches, finiteness,
             no body's centre deep below the terrain, body-steps/s, host and
             device ms and launches per step, the kernel's times and bound,
             and the fused_seq kernel's times
  cloth      the prepped kernel vs its plain version on the cloth scene
             (128 and a ragged 1000 envs, initial and after 60 steps); the
             cloth step on the card against the CPU over 5 steps at 8 envs,
             "colored" and "scan"; the particle SDF and push-out against the
             CPU on seeded particles around a sphere, capsule, cylinder, box
             and hull and over the terrain; the cloth substep's launches in
             each mode; then 60 warm steps and 300 (128 envs) or 150 (4096)
             steps of the main path: launches, finiteness, pinned rows
             bit-unchanged, median stretch, particle hits by kind (ragdoll,
             debris, terrain), depth inside the shells, env-, body- and
             particle-steps/s, host and device ms and launches a step, peak
             memory, the kernel's times and bound
  config4    the prepped kernel vs its plain version on config 4 (128 and
             a ragged 1000 envs, initial and after 60 steps; 256 posed
             envs in which all five contact recipes and the terrain rows
             are live; the 4096 run's last state); 180 steps at 4096 envs
             and 240 at 128 of the main path: launches, tests/test_vehicle.py's
             drop-and-drive gates at step 180 (finite, spread and floor in
             every env; the motor gear's spin in env 0, the undisturbed
             drop, and in a share of the others), the sheet
             finite, pinned and unstretched, env-, body- and
             particle-steps/s, host and device ms and launches a step, peak
             memory, the kernel's times and bound; the unpruned scene
             (2,591 rows) on the kernel beside the pruned one over 240
             steps; the cloth step on the card against the CPU; a trigger
             and an owned force field: trigger masks and field forces on
             the card against the CPU, enter and leave events
  bigpile    the fused-step kernel vs plain version on a 1,081-row box pile
             (46 boxes on a ground box, all pairs; more shared memory than
             a block holds in the one-env-per-block layout) at 256 and a
             ragged 1000 envs, initial and after 60 steps; the kernel's
             times and launch plans
  broadphase_cases
             the three broadphase kernels vs their plain versions (equal
             integers) on seeded random colliders: C from 1 to 5000 (ragged
             tiles, column chunks), B 1, 3 and 32, K 1, 8 and 20, 1 and 4
             contact phases, statics first, in the middle and last, half
             statics, rows with more than K hits (BROADPHASE_CASES, also run
             under g++ by tools/emulate_broadphase_cpu.py); the sweep alone
             on unsorted input, NaN, +-inf and inverted boxes, windows 1 to
             9 (past C), overflowing rows, K 20 and 80, and K 300 past
             the sweep's shared tile with rows of more hits (SWEEP_CASES)
  box_stack  the three broadphase kernels vs their plain versions (equal
             integers) on the initial and a rolled-out state, pair sets equal
             across the broadphases, then the box stack stepped in each
             broadphase: launches per step, overflow, agreement with the
             table broadphase, body-steps/s
  islands    the box stack finalized as bench.py's fused_islands takes it
             (contact_phases=2, candidate_margin=0.25) and islandized: the
             fused-step kernel vs its plain version on the 2,048 island
             envs (initial, after 60 steps); one world's full scene and its
             islands, scattered back, after 3 "colored" steps (1e-5 on
             positions, 1e-4 on velocities); 600 fused steps of all island
             envs: launches, finiteness, the towers standing over the
             first 120 (top box down less than 0.15 m, no box more than
             0.25 m sideways; ISLAND_STAND_REASON) and their 600-step values,
             body-steps/s, host ms, device launches and idle share a step,
             the kernel's times and bound; then VecLocoEnv(16 envs) steps,
             validate's stage of a NaN position on the fused step, and
             SceneSession.pick_nearest_body, all on the card
  scan       the entry() configuration (LocoEnv(solver_mode="scan",
             solver_iterations=10, max_narrow_pairs=32), 4096 envs, zero
             actions, pokes on) stepped after warm steps: env-steps/s,
             synchronised ms an env step, the overlap-matrix kernel's
             launches (one an env step, nothing else launched), live rows
             per bucket, dropped pairs, finiteness, the kernel against its
             plain version on these AABBs and its times at this shape, and
             8 envs' last step redone on the CPU (SCAN_CPU_REASON); two steps
             each of "jacobi" and "colored" and the joints' anchor gaps;
             step 1 of "scan" against the prepped kernel's "fused_seq" on the
             mixed scene of the JAX package's fused_seq test
             (SCAN_FMA_REASON); the goldens sphere_bounce and
             double_pendulum over 1000 steps and box_stack over 50 on "scan"
             at one env (box_stack gated over 25, SCAN_GOLDEN_REASON)
  demo       the noise's hash and the demo's terrain on the card against
             the CPU (NOISE_REASON); the twin of examples/demo_scene.py at
             one env, its terrain computed on the card (six frames of 60
             "scan" steps, fire / smoke / debris pools of 256, begin
             events, sound triggers, a 160 x 120 frame each): its
             per-frame fields and parts' seconds, finite, the spheres'
             heights within the bounds of the JAX example's run, a begin
             event, debris alive after the burst, each frame's hit share
             in (0, 1), the first frame on the card against the CPU
             (DEMO_CPU_REASON); a crafted sphere-on-sphere impact whose
             begin event is audible, card against CPU (DEMO_SOUND_REASON);
             the twin's state after three frames as 1024 envs (env 0
             undisturbed, the others with 0.01 m/s of velocity noise)
             through two frames of demo_scene.run_frame after a warm one:
             ms and launches a step, device idle share, particle-steps/s,
             events and sounds host ms, rays/s and ms a render, peak
             memory, begins in the first frame, debris alive after the
             second; at the twin's and the batch's shapes the
             overlap-matrix kernel against its plain version, its launches
             and times; the ray-caster at 256 envs on the settle scene, the
             golden mixed drop and the sphere bounce (every collider type
             hit, 4 envs against the CPU); each part alone, in this process
  content    GJK + EPA on 65,536 seeded pairs of each of the 15 pairings of
             sphere, capsule, cylinder, box and hull: ms, hit share, a
             slice against the CPU (CONTENT_REASON), the analytic
             recipes' agreement (CONTENT_STATS_REASON); 4096 animation
             instances of a 24-joint clip updated, composed and skinned
             (1024 points, 4 weights), timed, 8 against the CPU
The line before the last is the card's name and power limit; the line before
that lists every kernel (the fused step once per phase that runs it: loco,
train, zoo, settle, shapes, fidelity, terrain, cloth, config4 and islands, each
with the launch plan
of its timed batch, envs per block and warps per env; then the three
broadphase kernels, the overlap matrix with the launches of the box stack's
table path, of the scan phase's entry configuration and of the demo's
twin and batch). The last line is
{"ok": true, "device": {...}}.

Imports torch and the port only; nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
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


T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


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


def plans_by_batch(tab, batches):
    """The fused kernel's launch plan for each batch: envs per block (E),
    warps per env (W), threads and blocks of the grid, shared bytes."""
    return {str(b): vars(tab.launch_plan(b)) for b in batches}


def plan_fields(tab, batch):
    """The launch plan's (E, W) for the `kernels` line."""
    plan = tab.launch_plan(batch)
    return {"envs_per_block": plan.envs, "warps_per_env": plan.warps}


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
    live_by_recipe = live_rows_by_recipe(tab, klive)
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


def live_rows_by_recipe(tab, klive):
    """Live pair rows of each contact recipe in `klive` (B, P): a recipe
    with none would be held against the plain version only through its
    hit/miss decision."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    P = tab.num_rows
    types = tab.itab[tab.ioffs[0]:tab.ioffs[0] + fs.ROW_INTS * P].view(
        P, fs.ROW_INTS)[:, 0].to(klive.device)
    rows_live = (klive != 0).sum(dim=0)
    return {name: int(rows_live[types == t].sum())
            for t, name in fs.RECIPE_NAMES.items()
            if bool((types == t).any())}


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
# on-device PPO of BASELINE config 5 through the training entry point

TRAIN_ENVS = 4096
TRAIN_UNROLL = 64
TRAIN_ITERS = 3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-6
TRAIN_TOL_REASON = (
    "one minibatch update (loss, gradient, global-norm clip, Adam) of the "
    "trained policy run by the same code on the card and, copied, on the "
    "CPU: both in float32 without TF32, so they differ by the order of "
    "float sums (cuBLAS and the CPU's products, the loss's means over "
    "4096 samples: ~1e-7 relative on the loss); Adam's step is "
    "about the learning rate, 3e-4, and with 1920 steps of history in its "
    "moments a rounding difference in a gradient moves it by far less than "
    "1e-6")


def train_update_check(ts, config, seed):
    """One minibatch update of the trained state on the card and, with the
    parameters, Adam's state and the batch copied, on the CPU: the loss and
    the parameters after the step, and their differences. Works on copies;
    `ts` is left as it is."""
    import copy
    from dxk_tpu_torch.train import ppo
    rng = np.random.default_rng(seed)
    obs = ts.obs[:config.num_envs]
    n = obs.shape[0]
    with torch.no_grad():
        mean, log_std, value = ts.net(obs)
        action = mean + torch.from_numpy(rng.normal(
            size=tuple(mean.shape)).astype(np.float32)).to(obs.device) \
            * torch.exp(log_std)
        old_lp = ppo.gaussian_log_prob(mean, log_std, action)
    extra = [torch.from_numpy(rng.normal(size=n).astype(np.float32))
             for _ in range(3)]
    batch = (obs, action, old_lp + 0.05 * extra[0].to(obs.device), value,
             extra[1].to(obs.device), value + extra[2].to(obs.device))
    out = {}
    for where in ("cuda", "cpu"):
        net = copy.deepcopy(ts.net).to(where)
        opt = ppo.AdamState(ts.opt_state.count,
                            [m.detach().to(where).clone()
                             for m in ts.opt_state.mu],
                            [v.detach().to(where).clone()
                             for v in ts.opt_state.nu])
        loss, _opt = ppo.update_minibatch(
            net, opt, tuple(x.to(where) for x in batch), config)
        out[where] = (float(loss), {k: v.detach().cpu() for k, v in
                                    net.state_dict().items()})
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    moved = max(float((pg[k] - ts.net.state_dict()[k].cpu()).abs().max())
                for k in pg)
    return dict(batch=n, adam_count=ts.opt_state.count, loss_cuda=lg,
                loss_cpu=lc, loss_rel_diff=abs(lg - lc) / max(abs(lc),
                                                              1e-30),
                param_max_abs_diff=max(float((pg[k] - pc[k]).abs().max())
                                       for k in pg),
                step_moved_params_by=moved)


def train_phase(seed):
    """BASELINE config 5's trainer through its entry point:
    train_locomotion.main on 4096 envs (64-step rollouts, 30 solver
    iterations, the fused step), TRAIN_ITERS iterations into a temporary
    checkpoint directory, then --resume for one more. Holds the launches of
    the fused kernel (iters x unroll, none of the broadphase kernels) and
    Adam's updates (epochs x minibatches), finite metrics and parameters,
    parameters moved, TF32 off, the checkpoint restored bit for bit and
    resumed from its step and parameters, and one minibatch update on the
    card against the same on the CPU; then times the kernel on the trained
    policy's last state against its plain version."""
    import tempfile
    from dxk_tpu_torch.envs.loco_env import DT, LocoEnv
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.train import train_locomotion
    from dxk_tpu_torch.utils.checkpoint import Checkpointer

    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    with tempfile.TemporaryDirectory() as tmp:
        def argv(iters):
            return ["--num-envs", str(TRAIN_ENVS), "--unroll",
                    str(TRAIN_UNROLL), "--iters", str(iters),
                    "--solver-iterations", str(ITERATIONS),
                    "--ckpt-dir", os.path.join(tmp, "ckpt"),
                    "--csv", os.path.join(tmp, "train.csv")]
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = train_locomotion.main(argv(TRAIN_ITERS))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        ts, config = run["train_state"], run["config"]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
        params = {k: v.detach().cpu().clone()
                  for k, v in ts.net.state_dict().items()}
        ckpt = Checkpointer(os.path.join(tmp, "ckpt"))
        saved_step = ckpt.latest_step
        restored = ckpt.restore()
        bit_equal = (set(restored) == set(params) and all(
            torch.equal(restored[k], params[k]) for k in params))
        update = train_update_check(ts, config, seed)
        resumed = train_locomotion.main(argv(1) + ["--resume"])
        resumed_equal = all(torch.equal(resumed["initial_params"][k].cpu(),
                                        params[k]) for k in params)
    moved = max(float((params[k] - run["initial_params"][k].cpu())
                      .abs().max()) for k in params)
    finite = (all(bool(torch.isfinite(v).all()) for v in params.values())
              and all(np.isfinite(m[k]) for m in run["metrics"]
                      for k in ("loss", "reward_mean", "reward_per_step",
                                "episode_done_rate", "value_mean")))
    its = run["metrics"]
    steady = its[1:]
    per_iter = TRAIN_ENVS * TRAIN_UNROLL
    out = dict(
        envs=TRAIN_ENVS, unroll=TRAIN_UNROLL, iterations=TRAIN_ITERS,
        solver_iterations=ITERATIONS, epochs=config.num_epochs,
        minibatches=config.num_minibatches,
        minibatch_size=per_iter // config.num_minibatches,
        seconds=secs,
        env_steps_per_s_iters_2_3=per_iter * len(steady)
        / sum(m["seconds"] for m in steady),
        rollout_s=[m["rollout_s"] for m in its],
        update_s=[m["update_s"] for m in its],
        iteration_s=[m["seconds"] for m in its],
        fused_launches_per_iteration=[m["fused_launches"] for m in its],
        adam_updates_per_iteration=[m["adam_updates"] for m in its],
        launches=launches, metrics=its, params_moved_by=moved,
        finite=finite, allow_tf32=tf32[0], matmul_precision=tf32[1],
        checkpoint=dict(saved_step=saved_step, bit_equal=bit_equal),
        resume=dict(start=resumed["start"],
                    final_step=resumed["final_step"],
                    params_equal_saved=resumed_equal,
                    metrics=resumed["metrics"]),
        update_check=dict(**update, loss_rtol=TRAIN_LOSS_RTOL,
                          param_atol=TRAIN_PARAM_ATOL,
                          tolerance_reason=TRAIN_TOL_REASON))

    # the kernel on the trained policy's last state, against its plain
    # version, and its time there
    env = LocoEnv(solver_mode="fused", solver_iterations=ITERATIONS,
                  device=DEVICE)
    cmp, run_kernel, run_plain, tab, live = compare_kernel(
        env.scene, ts.env_state.physics, TRAIN_ENVS, DT)
    for _ in range(3):
        run_kernel()
    b_ms, b_by, b_detail = bound_ms(tab, live, TRAIN_ENVS)
    out["kernel"] = dict(ms=time_ms(run_kernel, 20),
                         plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
                         bound_by=b_by, bound_detail=b_detail,
                         err_v=cmp["err_v"], err_w=cmp["err_w"],
                         live_rows_by_recipe=cmp["live_rows_by_recipe"])
    emit("train", **out)

    hold_fused(cmp)
    want = {n: (TRAIN_ITERS * TRAIN_UNROLL if n == "fused_step" else 0)
            for n in counters}
    bad = []
    if launches != want or any(m["fused_launches"] != TRAIN_UNROLL
                               for m in its):
        bad.append(f"launches {launches} (expected {want})")
    if any(m["adam_updates"] != config.num_epochs * config.num_minibatches
           for m in its):
        bad.append("Adam updates an iteration differ from epochs x "
                   "minibatches")
    if not finite or not moved > 0.0:
        bad.append(f"finite {finite}, parameters moved by {moved}")
    if tf32[0] is not False:
        bad.append("TF32 is on for float32 matrix products")
    if saved_step != TRAIN_ITERS or not bit_equal:
        bad.append(f"checkpoint step {saved_step}, bit-equal {bit_equal}")
    if (resumed["start"] != TRAIN_ITERS or not resumed_equal
            or resumed["final_step"] != TRAIN_ITERS + 1):
        bad.append(f"resume from step {resumed['start']}, parameters "
                   f"equal {resumed_equal}")
    if not (update["loss_rel_diff"] <= TRAIN_LOSS_RTOL
            and update["param_max_abs_diff"] <= TRAIN_PARAM_ATOL
            and update["step_moved_params_by"] > 0.0):
        bad.append(f"card vs CPU update: {update}")
    if bad:
        raise RuntimeError(f"train: {bad}")
    return {
        "name": "fused_step_train", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": launches["fused_step"],
        "max_abs_err": max(cmp[k] for k in ("err_v", "err_w", "err_pos",
                                            "err_rot", "err_imp")),
        "ms": out["kernel"]["ms"], "plain_ms": out["kernel"]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **plan_fields(tab, TRAIN_ENVS)}


# ---------------------------------------------------------------------------
# the 1k-box stack on the reference step

DEVICE = "cuda"
BOX_TOWERS, BOX_PER_TOWER = 64, 16        # bench.py _box_towers(1024)
BOX_BATCH = 32                            # bench.py's on-chip box_batch
BOX_STEPS = 15
BOX_WARM = 15
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


def overlap_matrix_check(scene, state, what):
    """The overlap-matrix kernel against its plain version on the AABBs of
    `state` (call it after the main path's launch count was read: these
    launches are not the path's), then its time, the plain version's and
    the bound at this (B, C). Raises on any difference."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    mn, mx = aabbs(scene, state)
    B, C = mn.shape[:2]
    got = bk.aabb_overlap_matrix(mn, mx)
    torch.cuda.synchronize()
    err = int((got.long() - bk.aabb_overlap_matrix_plain(
        mn, mx).long()).abs().max())
    if err != 0:
        raise RuntimeError(f"{what}: the overlap-matrix kernel differs from "
                           f"its plain version by {err}")
    for _ in range(3):
        bk.aabb_overlap_matrix(mn, mx)
    m_ms = time_ms(lambda: bk.aabb_overlap_matrix(mn, mx), 50)
    m_plain = time_ms(lambda: bk.aabb_overlap_matrix_plain(mn, mx), 3)
    t_bytes = (B * C * 6 * 4 + B * C * C) / PEAK_BYTES * 1e3
    t_ops = B * C * C * OPS_AABB_TEST / PEAK_FLOPS * 1e3
    return dict(ms=m_ms, plain_ms=m_plain, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                B=B, C=C, max_abs_err=err)


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
    # the sweep tests a row's columns up to its exact stop, and none for a
    # row that pairs with nothing
    pairs_with = (owner_s == 0) | (owner_s == 1)
    s_pairs = int((torch.clamp(sp.sweep_stops(mn_s, mx_s, W) - ii - 1, min=0)
                   * pairs_with).sum())
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


# edge cases of the broadphase kernels, run on the card here and under g++ by
# tools/emulate_broadphase_cpu.py: (seed, B, C, K, num_phases, statics,
# static share, sweep window); a None in statics is index C // 2, a negative
# one counts from the end. C = 1 and 31 give ragged tiles and row starts, 600
# and 2100 more columns than a K-select chunk, 2100 more than the overlap
# matrix stages whole; K = 20 is past what the K-select's slices buffer (one
# warp walks a row); the eleventh case is half statics (the K-select's static
# list spans chunks).
BROADPHASE_CASES = (
    (1, 1, 1, 1, 1, (0,), 0.0, 2),
    (2, 3, 1, 8, 4, (), 0.0, 2),                 # one rigid collider
    (3, 3, 31, 8, 4, (0, None, -1), 0.05, 2),
    (4, 1, 31, 1, 1, (0, None, -1), 0.05, 2),
    (5, 3, 130, 1, 4, (0, None, -1), 0.05, 2),
    (6, 1, 130, 8, 1, (None, -1), 0.05, 2),      # no ground
    (7, 1, 600, 8, 4, (0, None, -1), 0.05, 2),
    (14, 3, 130, 20, 4, (0, None, -1), 0.05, 2),  # K past the slices
    (8, 3, 1025, 8, 4, (0, None, -1), 0.05, 2),
    (9, 1, 1025, 1, 1, (0, None, -1), 0.05, 2),
    (10, 1, 1025, 8, 4, (0,), 0.5, 2),
    (11, 1, 2100, 8, 4, (0, None, -1), 0.02, 2),
)
BROADPHASE_SMALL_CASES = 8          # the first cases, the CPU test's share
# on the card only: the main path's width and batch, and a C of several
# thousand at one env (the overlap matrix in column chunks)
BROADPHASE_CARD_CASES = (
    (12, 32, 1025, 8, 4, (0, None, -1), 0.05, 2),
    (13, 1, 5000, 8, 4, (0, None, -1), 0.02, 2),
)
# edges of the sort-and-sweep alone, run on the card and under g++ (all in
# the CPU test): (seed, B, C, K, num_phases, window, layout). "sorted" takes
# sort_for_sweep's order with the ground left out as the scenes do;
# "unsorted" hands the colliders to sap_sweep in index order, ground and
# all; "nan_inf" puts NaN and +-inf coordinates and inverted boxes into some
# colliders first; "dense" packs every box's min corner into [-1, 1], so
# that early rows overlap more than 300 later ones. Window 1 leaves most
# rows overflowing, 8 reaches past C; K 80: one warp a block, a wide shared
# tile of partners; K 300: past the tile (sap_broadphase.MAX_K), rows
# written straight to the outputs.
SWEEP_CASES = (
    (21, 1, 600, 8, 4, 1, "sorted"),
    (22, 3, 300, 8, 4, 4, "sorted"),
    (23, 1, 600, 20, 4, 8, "sorted"),
    (24, 3, 130, 8, 1, 2, "unsorted"),
    (25, 1, 600, 8, 4, 4, "unsorted"),
    (26, 3, 400, 8, 4, 2, "nan_inf"),
    (27, 1, 300, 20, 4, 3, "nan_inf unsorted"),
    (28, 1, 31, 1, 1, 9, "nan_inf"),
    (29, 1, 300, 80, 4, 4, "sorted"),
    (30, 2, 600, 300, 4, 5, "sorted dense"),
)


def broadphase_colliders(seed, B, C, statics=(0,), static_share=0.05,
                         device="cpu"):
    """B envs of C random AABBs and the (C,) body, owner and shape type
    vectors, made with numpy from `seed`: the colliders in `statics` and a
    `static_share` of the others are static (index 0, if static, a broad
    ground), rigid colliders share bodies in pairs, a few are force fields
    or triggers, and a dense cluster of a quarter of the boxes gives rows
    more hits than K."""
    rng = np.random.default_rng(seed)
    mn = rng.uniform(-6, 6, (B, C, 3)).astype(np.float32)
    ext = rng.uniform(0.5, 3.0, (B, C, 3))
    mn[:, : C // 4] = rng.uniform(-1, 1, (B, C // 4, 3))
    mx = (mn + ext).astype(np.float32)
    owner = np.where(rng.uniform(size=C) < static_share, 1, 0).astype(np.int32)
    owner[rng.uniform(size=C) < 0.03] = 2
    owner[rng.uniform(size=C) < 0.03] = 3
    for s in statics:
        owner[(C // 2 if s is None else s) % C] = 1
    if owner[0] == 1:
        mn[:, 0] = (-30.0, -1.0, -30.0)
        mx[:, 0] = (30.0, 0.5, 30.0)
    body = (np.arange(C, dtype=np.int32) // 2).astype(np.int32)
    body[owner == 1] = C
    ctype = rng.integers(0, 5, C).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (mn, mx, body, owner, ctype))


def broadphase_case_calls(case, device):
    """For one case of BROADPHASE_CASES: (summary, {kernel: {"kernel": call,
    "plain": call}}) on tensors made on `device`."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    seed, B, C, K, nph, statics, share, window = case
    mn, mx, body, owner, ctype = broadphase_colliders(seed, B, C, statics,
                                                      share, device)
    broad = (0,) if int(owner[0]) == 1 else ()
    sargs = sp.sort_for_sweep(mn, mx, body, owner, ctype, broad)[1:] + (
        nph, K, window)
    kargs = (mn, mx, body, owner, ctype, nph, K)
    summary = dict(seed=seed, B=B, C=C, K=K, num_phases=nph, window=window,
                   statics=int((owner == 1).sum()))
    return summary, {
        "aabb_overlap_matrix": dict(
            kernel=lambda: bk.aabb_overlap_matrix(mn, mx),
            plain=lambda: bk.aabb_overlap_matrix_plain(mn, mx)),
        "kselect_broadphase": dict(
            kernel=lambda: ks.kselect_broadphase(*kargs),
            plain=lambda: ks.kselect_broadphase_plain(*kargs)),
        "sap_broadphase": dict(
            kernel=lambda: sp.sap_sweep(*sargs),
            plain=lambda: sp.sap_sweep_plain(*sargs))}


def sweep_case_inputs(case, device="cpu"):
    """The arguments of sap_sweep for one case of SWEEP_CASES: (mn_s, mx_s,
    body_s, owner_s, ctype_s, num_phases, K, window), made on `device`."""
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    seed, B, C, K, nph, window, layout = case
    mn, mx, body, owner, ctype = broadphase_colliders(seed, B, C,
                                                      (0, None, -1), 0.05)
    if "dense" in layout:
        mn, mx = mn / 6.0, mn / 6.0 + (mx - mn)
    if "nan_inf" in layout:
        # per env, about one collider in twelve each: a NaN coordinate of
        # its min or max corner, min-x -inf, max-x +inf, max-x -inf, and an
        # axis whose min and max are swapped
        rng = np.random.default_rng(seed + 1000)
        mn, mx = mn.numpy().copy(), mx.numpy().copy()
        for b in range(B):
            pick = rng.integers(0, 6, C)
            pick[rng.uniform(size=C) < 0.5] = -1
            ax = rng.integers(0, 3, C)
            for i in np.nonzero(pick >= 0)[0]:
                k, a = pick[i], ax[i]
                if k == 0:
                    mn[b, i, a] = np.nan
                elif k == 1:
                    mx[b, i, a] = np.nan
                elif k == 2:
                    mn[b, i, 0] = -np.inf
                elif k == 3:
                    mx[b, i, 0] = np.inf
                elif k == 4:
                    mx[b, i, 0] = -np.inf
                else:
                    mn[b, i, a], mx[b, i, a] = mx[b, i, a], mn[b, i, a]
        mn, mx = torch.from_numpy(mn), torch.from_numpy(mx)
    if "unsorted" in layout:
        sorted_in = (mn, mx, *(x.to(torch.int32)[None].expand(B, C)
                               .contiguous() for x in (body, owner, ctype)))
    else:
        sorted_in = sp.sort_for_sweep(mn, mx, body, owner, ctype, (0,))[1:]
    return tuple(x.to(device) for x in sorted_in) + (nph, K, window)


def sweep_case_summary(case, sargs, cnt, ovf):
    """What one SWEEP_CASES case exercises, from its inputs and the plain
    sweep's counts and overflow flags."""
    seed, B, C, K, nph, window, layout = case
    mn_s, mx_s = sargs[0], sargs[1]
    both = torch.cat([mn_s, mx_s], dim=-1)
    return dict(seed=seed, B=B, C=C, K=K, num_phases=nph, window=window,
                layout=layout, nan=int(torch.isnan(both).sum()),
                inf=int(torch.isinf(both).sum()),
                inverted=int((mn_s > mx_s).sum()),
                rows_over_k=int((cnt > K).sum()),
                rows_overflowing=int(ovf.sum()), hits=int(cnt.sum()))


def broadphase_cases_phase():
    """The three broadphase kernels against their plain versions, integer
    for integer, on every case of BROADPHASE_CASES and
    BROADPHASE_CARD_CASES, and the sweep alone on SWEEP_CASES; raises on any
    difference."""
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    rows = []
    for case in BROADPHASE_CASES + BROADPHASE_CARD_CASES:
        summary, calls = broadphase_case_calls(case, DEVICE)
        summary["max_abs_err"] = hold_kernels(calls, f"seed {case[0]}")
        summary["rows_over_k"] = int(
            (calls["kselect_broadphase"]["plain"]()[2] > case[3]).sum())
        rows.append(summary)
    sweep_rows = []
    for case in SWEEP_CASES:
        sargs = sweep_case_inputs(case, DEVICE)
        calls = {"sap_broadphase": dict(
            kernel=lambda: sp.sap_sweep(*sargs),
            plain=lambda: sp.sap_sweep_plain(*sargs))}
        err = hold_kernels(calls, f"sweep seed {case[0]}")
        _idx, _cls, cnt, ovf = calls["sap_broadphase"]["plain"]()
        summary = sweep_case_summary(case, sargs, cnt, ovf)
        summary["max_abs_err"] = err
        sweep_rows.append(summary)
    emit("broadphase_cases", cases=rows, sweep_cases=sweep_rows)


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
                             plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail,
                             err_v=cmp["err_v"], err_w=cmp["err_w"])
    emit("zoo", chains=ZOO_CHAINS, bodies=n_bodies,
         colliders=tab.num_colliders, pair_rows=tab.num_rows,
         joints=tab.joint_counts, iterations=ITERATIONS, dt=ZOO_DT,
         plans=plans_by_batch(tab, ZOO_BATCHES + (ZOO_RAGGED,)),
         tolerance=KERNEL_TOL,
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
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(tab, big)}


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


WIDE_BOX_HALF = 0.08                      # the box on top of the wide pile
WIDE_CYL_HALF, WIDE_CYL_R = 0.06, 0.08    # the cylinder on top of another


def wide_hull_points():
    """Two hulls past the fused kernel's per-thread polytope buffers
    (fused_step.MAX_HULL_VERTS, MAX_HULL_LOOP): 64 points spread evenly
    over a sphere of radius 0.12 m, every one a vertex, and a 24-sided
    prism of radius 0.12 m and height 0.1 m about y, whose two caps are
    faces of 24 loop points."""
    i = np.arange(64) + 0.5
    y = 1.0 - 2.0 * i / 64
    r = np.sqrt(1.0 - y * y)
    t = np.pi * (3.0 - np.sqrt(5.0)) * i
    cloud = 0.12 * np.stack([r * np.cos(t), y, r * np.sin(t)], axis=1)
    a = 2.0 * np.pi * np.arange(24) / 24
    ring = np.stack([0.12 * np.cos(a), np.zeros(24), 0.12 * np.sin(a)],
                    axis=1)
    prism = np.concatenate([ring - (0.0, 0.05, 0.0), ring + (0.0, 0.05, 0.0)])
    return {"cloud64": cloud, "prism24": prism}


WIDE_PILES = ("cloud64", "prism24", "cloud64_cylinder")
WIDE_RECIPES = {"cloud64": ("box_hull",), "prism24": ("box_hull", "hull_hull"),
                "cloud64_cylinder": ("box_hull", "cylinder_hull")}


def wide_pile_builder(builder, name):
    """A pile of one wide hull on a ground box (40 x 2 x 40, top at y = 0),
    each body resting a few millimetres into the one below: the 64-point
    hull under a 0.16 m box (box-hull rows of the ground and of the box),
    the 24-sided prism under the hull pile's tetrahedron (a box-hull row of
    the ground, a hull-hull row), or the 64-point hull under an upright
    cylinder (half length 0.06 m, radius 0.08 m: a cylinder-hull row, and a
    box-hull row of the ground; the shapes build). One wide
    hull a scene: hulls are padded to the scene's largest, and the plain
    version walks every padded edge pair (the 64-point hull has 186 edge
    directions), so two such hulls in a hull-hull row would cost it
    minutes a step."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (20, 1, 20))
    pts = wide_hull_points()[name.split("_")[0]]
    hid = b.add_hull_geometry_from_mesh(pts)
    y = -pts[:, 1].min() - 0.003
    body = b.add_body(position=(0.0, y, 0.0))
    b.add_hull_collider(body, hid)
    y += pts[:, 1].max()
    if name == "cloud64":
        h = WIDE_BOX_HALF
        body = b.add_body(position=(0.0, y + h - 0.003, 0.0))
        b.add_box_collider(body, (0, 0, 0), (h, h, h))
    elif name == "cloud64_cylinder":
        h = WIDE_CYL_HALF
        body = b.add_body(position=(0.0, y + h - 0.003, 0.0))
        b.add_cylinder_collider(body, (0, -h, 0), (0, h, 0), WIDE_CYL_R)
    else:
        tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1],
                        [-1, -1, 1]]) * 0.1
        hid = b.add_hull_geometry_from_mesh(tet)
        body = b.add_body(position=(0.0, y - tet[:, 1].min() - 0.003, 0.0))
        b.add_hull_collider(body, hid)
    return b


def wide_pile_scene(name, device=DEVICE):
    from dxk_tpu_torch.scene import SceneBuilder
    return wide_pile_builder(SceneBuilder, name).finalize(device=device)


def pile_vertices(scene):
    """Each dynamic body's vertices in its own frame, in body order: its
    hull's, its box's corners, or 64 points on each cap rim of its
    cylinder (one collider a body, at the body's origin, as the pile
    builders make them)."""
    col = scene.colliders.to("cpu")
    hv = scene.hulls.vertices.double().cpu()
    hm = scene.hulls.vertex_mask.cpu()
    out = []
    for body in range(1, scene.num_bodies):
        c = (col.body == body).nonzero()
        if len(c) == 0:
            continue
        c = int(c[0, 0])
        if int(col.ctype[c]) == 4:
            h = int(col.hull_id[c])
            out.append(hv[h][hm[h]])
        elif int(col.ctype[c]) == 2:
            # a cylinder along local y: its cap rims
            t = torch.arange(64, dtype=torch.float64) * (2 * np.pi / 64)
            r = float(col.r[c])
            ring = torch.stack([r * torch.cos(t), torch.zeros(64),
                                r * torch.sin(t)], dim=1)
            out.append(torch.cat([ring + col.a[c].double(),
                                  ring + col.b[c].double()]))
        else:
            half = col.b[c].double()
            out.append(torch.tensor([[x, y, z] for x in (-1, 1)
                                     for y in (-1, 1) for z in (-1, 1)],
                                    dtype=torch.float64) * half)
    return out


def pile_poses(scene, batch, seed):
    """`batch` envs of a pile (pile_builder, wide_pile_builder): each body
    turned by a seeded random rotation (odd envs) or by up to 5 degrees
    (even envs), then set down with its lowest vertex 0-6 mm below the
    highest vertex of the body under it (the ground's top for the first),
    so that each pair below touches."""
    from dxk_tpu_torch.core.maths import quat_rotate
    st = scene.initial_state(batch)
    rng = np.random.default_rng(seed)
    pos = st.pos.double().cpu()
    rot = st.rot.double().cpu()
    body_verts = pile_vertices(scene)
    for e in range(batch):
        top = torch.tensor((rng.uniform(-0.03, 0.03), 0.0,
                            rng.uniform(-0.03, 0.03)), dtype=torch.float64)
        for k, verts in enumerate(body_verts):
            ang = rng.uniform(0, 2 * np.pi) if e % 2 else np.radians(
                rng.uniform(0, 5))
            q = _axis_quat(rng.normal(size=3), ang)
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


POKE_ENVS = 256
POKE_STRENGTH = 1000.0                    # N, LocoEnv's poke
POKE_TOL = 1e-5
POKE_REASON = (
    "apply_ray_impulse on the card and on the CPU from the same state and "
    "rays: the same float32 operations (sqrt and division correctly rounded "
    "on both), reductions over 3 components perhaps in another order; each "
    "accumulator held within 1e-5 of max(1, its largest value)")


def poke_check(scene, cpu_scene, state, seed):
    """physics.apply_ray_impulse on the card against the CPU on the first
    POKE_ENVS envs of `state` (config 3's scene: the ragdoll and its hull
    debris, the debris its last body): every fourth ray aimed down at the
    debris from 3 m (the hull its first hit), the others at seeded ragdoll
    parts, the last 8 far off (misses). The poked bodies, the accumulators'
    errors and the envs whose debris was poked."""
    from dxk_tpu_torch.physics import apply_ray_impulse
    n = POKE_ENVS
    st = _sub_state(state, lambda x: x[:n].contiguous())
    st = st.replace(force_acc=torch.zeros_like(st.force_acc),
                    torque_acc=torch.zeros_like(st.torque_acc))
    rng = np.random.default_rng(seed)
    nb = scene.num_bodies
    debris = nb - 1
    at_hull = np.arange(n) % 4 == 0
    target_body = np.where(at_hull, debris, rng.integers(0, nb - 1, n))
    target = st.pos.cpu().numpy()[np.arange(n), target_body]
    d = rng.normal(size=(n, 3)) * 0.2
    d[at_hull] += np.array([0.0, -1.0, 0.0])
    d[~at_hull] += rng.normal(size=(int((~at_hull).sum()), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origin = target - 3.0 * d
    origin[-8:] += 50.0
    o, dd = (torch.from_numpy(x.astype(np.float32)) for x in (origin, d))
    card = apply_ray_impulse(scene, st, o.to(DEVICE), dd.to(DEVICE),
                             POKE_STRENGTH)
    cpu = apply_ray_impulse(cpu_scene, _sub_state(st, lambda x: x.cpu()), o,
                            dd, POKE_STRENGTH)
    out = dict(envs=n, strength_n=POKE_STRENGTH, tolerance=POKE_TOL,
               reason=POKE_REASON)
    poked = {}
    for key in ("force_acc", "torque_acc"):
        a, b = getattr(card, key).cpu(), getattr(cpu, key)
        out[f"{key}_nan_places_equal"] = bool(torch.equal(a.isnan(),
                                                          b.isnan()))
        a, b = a.nan_to_num(), b.nan_to_num()
        err, scale = _rel_err(a, b)
        out[key] = dict(err=err, scale=scale)
        poked[key] = (a.abs().sum(-1) > 0, b.abs().sum(-1) > 0)
    ka, ca = poked["force_acc"]
    out["poked_bodies_equal"] = bool(torch.equal(ka, ca))
    out["envs_poked"] = int(ka.any(-1).sum())
    out["envs_hull_poked"] = int(ka[:, debris].sum())
    out["device"] = str(card.force_acc.device)
    return out


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

    # ---- the three-hull pile stepped PILE_STEPS steps: state finite
    pile_ok = {}
    ok = torch.ones((), dtype=torch.bool, device=DEVICE)
    st = pile_st
    for _ in range(PILE_STEPS):
        st, _info = physics_step(pile, st, settings, SETTLE_DT)
        ok &= torch.isfinite(st.pos).all() & torch.isfinite(
            st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
    pile_ok["pile"] = bool(ok)

    # ---- hulls past the per-thread polytope buffers (their buffers in the
    # hull scratch): each wide pile at bench's batch on fresh poses and
    # after PILE_STEPS steps, and at the main batch on fresh poses, held in
    # the averaged solve (base or shapes build) and in the sequential one
    # (prepped build). hold_modes runs the plain version once over the
    # three states side by side: it walks the padded edge pairs and 48 clip
    # slots op by op (~22 s a call for the prism at any batch), so its time
    # is that one call's
    small, big = SETTLE_BATCHES[0], SETTLE_BATCHES[-1]
    wide_checks, wide_timing = {}, {}
    for n in WIDE_PILES:
        wide = wide_pile_scene(n)
        fresh = pile_poses(wide, small, seed)
        st = fresh
        ok = torch.ones((), dtype=torch.bool, device=DEVICE)
        for _ in range(PILE_STEPS):
            st, _info = physics_step(wide, st, settings, SETTLE_DT)
            ok &= torch.isfinite(st.pos).all() & torch.isfinite(
                st.lin_vel).all() & torch.isfinite(st.ang_vel).all()
        pile_ok[f"wide_{n}"] = bool(ok)
        fresh_big = pile_poses(wide, big, seed)
        states = {f"B{small}_poses": fresh,
                  f"B{small}_after_{PILE_STEPS}_steps": st,
                  f"B{big}_poses": fresh_big}
        plain_ms = {}
        for mode, seq in (("fused", False), ("fused_seq", True)):
            held = hold_modes(wide, states, SETTLE_DT, seq,
                              prep_in_kernel=not seq)
            for k, c in held.items():
                wide_checks[f"wide_{n}.{mode}.{k}"] = c
            plain_ms[mode] = held[f"B{big}_poses"]["plain_call_ms"]
        # the kernel's time at each batch on fresh poses
        wide_tab = fs.fused_tables(wide, DEVICE)
        solver = fs.make_fused_step_solver(wide, ITERATIONS, 1.0)
        timed = {}
        for b, st_b in ((small, fresh), (big, fresh_big)):
            inputs = kernel_inputs(wide, st_b, SETTLE_DT)
            klive = solver(*inputs)[3]
            for _ in range(3):
                solver(*inputs)
            timed[b] = (time_ms(lambda: solver(*inputs), 20), klive, inputs)
        _ms, klive, (_b, wcol, _c, _i, _p) = timed[big]
        branches_big = fs.recipe_branches(wide_tab, wcol.a, wcol.b, wcol.rot)
        work = recipe_flops(wide_tab, branches_big, big)
        b_ms, b_by, _detail = bound_ms(wide_tab, klive, big, work)
        wide_timing[n] = dict(
            batch=big, ms=timed[big][0], ms_small=timed[small][0],
            plain_ms_one_call=plain_ms["fused"],
            plain_ms_one_call_fused_seq=plain_ms["fused_seq"],
            plain_envs=small * 2 + big, bound_ms=b_ms, bound_by=b_by,
            recipe_flops=work, hull_dims=dict(zip(
                ("V", "F", "FU", "LM", "EU"), wide_tab.hull_dims)),
            hull_scratch_shape=fs.hull_scratch_shape(wide_tab, big),
            pair_rows=wide_tab.num_rows,
            plans={str(b): vars(wide_tab.launch_plan(b))
                   for b in (small, big)},
            branches=branches_big, pile_finite=pile_ok[f"wide_{n}"])
    pile_finite = all(pile_ok.values())

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
                             plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail,
                             recipe_flops=work, err_v=cmp["err_v"],
                             err_w=cmp["err_w"],
                             live_rows_by_recipe=cmp["live_rows_by_recipe"],
                             branches=cmp["branches"])
        if batch == SETTLE_BATCHES[0]:
            poke = poke_check(scene, settle_scene("cpu"), st, seed + 2)
    emit("settle", bodies=scene.num_bodies, body_steps_counted=SETTLE_BODIES,
         colliders=tab.num_colliders, pair_rows=tab.num_rows,
         joints=tab.joint_counts, hull_dims=dict(zip(
             ("V", "F", "FU", "LM", "EU"), tab.hull_dims)),
         iterations=ITERATIONS, dt=SETTLE_DT,
         plans=plans_by_batch(tab, SETTLE_BATCHES + (SETTLE_RAGGED,)),
         tolerance=KERNEL_TOL,
         tolerance_reason=SETTLE_TOL_REASON,
         checks=checks, live_rows_by_recipe=live, branches=branches,
         pile=dict(steps=PILE_STEPS, finite=pile_ok["pile"],
                   pair_rows=fs.fused_tables(pile, DEVICE).num_rows,
                   hull_dims=fs.fused_tables(pile, DEVICE).hull_dims),
         wide_checks=wide_checks, wide_pile=wide_timing, runs=runs,
         kernel=timing, poke=poke)
    for c in list(checks.values()) + list(wide_checks.values()):
        hold_fused(c, relative=True)
    if not (poke["poked_bodies_equal"] and poke["envs_hull_poked"]
            and poke["force_acc_nan_places_equal"]
            and poke["torque_acc_nan_places_equal"]
            and poke["device"] != "cpu"
            and all(poke[k]["err"] <= POKE_TOL * poke[k]["scale"]
                    for k in ("force_acc", "torque_acc"))):
        raise RuntimeError(f"settle: the poke on the card disagrees with the "
                           f"CPU's: {poke}")
    dead = [r for r in ("capsule_hull", "box_hull", "hull_hull")
            if live.get(r, 0) == 0]
    dead += [f"{r}.{k}" for r, ks_ in (("capsule_hull", ("separated",
                                                          "overlap")),
                                       ("sat", ("face_a", "face_b", "edge")))
             for k in ks_ if branches.get(r, {}).get(k, 0) == 0]
    if dead:
        raise RuntimeError(f"settle: hull recipes or branches never live in "
                           f"the compared states: {dead}")
    if not pile_finite:
        raise RuntimeError(f"settle: a hull pile went non-finite: {pile_ok}")
    # every recipe of each wide pile live in each solve's compared states
    wide_dead = [f"{n}.{m}.{r}" for n, rs in WIDE_RECIPES.items()
                 for m in ("fused", "fused_seq") for r in rs
                 if not any(c["live_rows_by_recipe"].get(r, 0)
                            for k, c in wide_checks.items()
                            if k.startswith(f"wide_{n}.{m}."))]
    if wide_dead:
        raise RuntimeError(f"settle: no live {wide_dead} row in the wide "
                           f"piles' compared states")
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
                           for c in list(checks.values())
                           + list(wide_checks.values())),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(tab, big)}


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
                               plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
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
                plans=plans_by_batch(fs.fused_tables(s, DEVICE),
                                     SHAPES_BATCHES + (SHAPES_RAGGED,)))
        for n, s in scenes.items()},
         pile=dict(pair_rows=ptab.num_rows, plans=plans_by_batch(
             ptab, (SHAPES_BATCHES[0],))),
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
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(fs.fused_tables(scenes["mixed_shape_drop"], DEVICE),
                      SHAPES_BATCHES[-1])}


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
    of its eager launches, not the batch; `plain_call_ms` its time on CUDA
    events), one kernel launch per state at that state's batch; positions
    and rotations after one integration of each side's velocities. Returns
    {name: check}."""
    from dxk_tpu_torch.ops.integrator import integrate_velocities
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
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    pvw, pimp, plive = fs._fused_core(
        tab, ITERATIONS, 1.0, inv_dt, torch.cat([bodies.v, bodies.w], -1),
        bodies.inv_mass, bodies.inv_inertia, bodies.pos_cog, bodies.rot,
        joints if prep_in_kernel else None, wcol.a, wcol.b, wcol.rot,
        joint_tables=tables, sequential=sequential, passed=passed)
    stop.record()
    torch.cuda.synchronize()
    plain_call_ms = start.elapsed_time(stop)
    dt32 = float(np.float32(dt))
    ps = integrate_velocities(scene, bodies.replace(
        v=pvw[..., :3].contiguous(), w=pvw[..., 3:].contiguous()), cat, dt32)
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0,
                                       sequential=sequential,
                                       joint_prep_in_kernel=prep_in_kernel)
    out, lo, kvs, kws = {}, 0, [], []
    for n in names:
        hi = lo + states[n].pos.shape[0]
        kv, kw, kimp, klive = solver(*_envs(inputs, lo, hi))
        torch.cuda.synchronize()
        kvs.append(kv)
        kws.append(kw)
        out[n] = dict(
            batch=hi - lo, plain_call_ms=plain_call_ms,
            live_rows_by_recipe=live_rows_by_recipe(tab, klive),
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
    ks = integrate_velocities(scene, bodies.replace(
        v=torch.cat(kvs), w=torch.cat(kws)), cat, dt32)
    lo = 0
    for n in names:
        hi = lo + states[n].pos.shape[0]
        out[n]["err_pos"] = float((ks.pos[lo:hi] - ps.pos[lo:hi]).abs().max())
        out[n]["err_rot"] = float((ks.rot[lo:hi] - ps.rot[lo:hi]).abs().max())
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
                plans=plans_by_batch(fs.fused_tables(s, DEVICE),
                                     (1, FIDELITY_TIMED_BATCH)))
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
        "library_ms": None,
        **plan_fields(fs.fused_tables(scenes["ragdoll_settle"], DEVICE),
                      FIDELITY_TIMED_BATCH)}


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
TERRAIN_STEPS = 300
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


def profile_steps(step, n, host_ops=True):
    """Device busy ms, device kernel launches and fused-step kernel ms per
    call of `step` over `n` calls under torch.profiler, and the top device
    kernels. host_ops=False traces the device alone: the same device rows,
    without the host's operator events (tens of thousands a step on the
    reference step, whose processing takes seconds)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.append(torch.profiler.ProfilerActivity.CPU)
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
                             plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
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
         iterations=ITERATIONS, dt=TERRAIN_DT,
         plans=plans_by_batch(tab, TERRAIN_BATCHES + (TERRAIN_RAGGED,)),
         tolerance=KERNEL_TOL,
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
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(tab, big)}


# ---------------------------------------------------------------------------
# cloth: BASELINE config 4's sheet, and a thick one on the ragdoll and terrain

CLOTH_SHEET = dict(width=2.0, height=2.0, grid_x=12, grid_y=12,
                   total_mass=1.0)                 # bench.py:386-387
CLOTH_A_POS = (6.0, 3.0, 0.0)                      # bench.py:387, thickness 0
CLOTH_B_POS = (0.0, 2.0, 1.0)                      # pinned beside the ragdoll
CLOTH_B_ROT = (0.0, 1.0, 0.0, 0.0)                 # turned to reach +z
CLOTH_B_THICKNESS = 0.05


def cloth_builder(builder, add_ragdoll=None):
    """BASELINE config 4 without its vehicle: terrain_builder's terrain,
    ragdoll and debris, config 4's 12 x 12 sheet as bench.py:386-387 adds
    it (cloth A, no thickness), and the same sheet with a 0.05 m thickness
    (cloth B) pinned along x at CLOTH_B_POS, 2 m up and 0.9 m in front of
    the ragdoll, lying flat away from it: it swings down like a pendulum,
    its free edge reaches the terrain and sweeps through the falling
    ragdoll."""
    b = terrain_builder(builder, add_ragdoll)
    b.add_cloth(**CLOTH_SHEET, transform_pos=CLOTH_A_POS)
    b.add_cloth(**CLOTH_SHEET, transform_pos=CLOTH_B_POS,
                transform_rot=CLOTH_B_ROT, thickness=CLOTH_B_THICKNESS)
    return b


def cloth_scene(device=DEVICE):
    from dxk_tpu_torch.models.ragdoll import add_ragdoll
    from dxk_tpu_torch.scene import SceneBuilder
    return cloth_builder(SceneBuilder, add_ragdoll).finalize(device=device)


CLOTH_BATCHES = (128, 4096)               # bench.py:794's on-chip batch; 4096
CLOTH_STEPS = (300, 150)                  # steps of the main path, per batch
CLOTH_RAGGED = 1000
CLOTH_WARM = 60
CLOTH_DT = 1.0 / 120.0
CLOTH_MODE = "colored"                    # bench.py:393-395
CLOTH_EVERY = 25                          # steps between contact reads
CLOTH_HIT_MARGIN = 0.005                  # m outside its shell: a hit
CLOTH_STRETCH_TOL = 0.15                  # tests/test_cloth.py:47
CLOTH_DEPTH_TOL = 0.02                    # tests/test_cloth.py:146
CLOTH_DEPTH_REASON = (
    "the thick sheet's depth inside the surfaces at the end of each run is "
    "reported by the kind of the deepest surface, not gated: the push-out "
    "(collide_particles, as in the JAX package) moves a particle out of its "
    "deepest surface only, so a particle between a limb sunk into the "
    "terrain (up to 0.128 m, sink_reason of the terrain line) and the "
    "terrain, or in the overlap of two limbs at a joint, stays inside the "
    "other (`trapped`), and a limb moves up to ~2 cm into the sheet in the "
    "step after its push-out; tests/test_cloth.py's bound is held where the "
    "push-out guarantees it, on that test's drape scene on the card "
    "(`drape`: a static sphere, 128 envs x 600 steps)")
CLOTH_PROFILED = 3
CLOTH_CPU_ENVS = 8
CLOTH_CPU_STEPS = 5
CLOTH_CPU_TOL = 1e-4
CLOTH_CPU_REASON = (
    "the cloth step on the card against the same code on the CPU from the "
    "same inputs (the state after the warm-up, the colliders and bodies of "
    "its next step copied over), each field after 5 steps held relative to "
    "max(1, its largest value): the wind's per-vertex sums and the two-way "
    "per-body sums are index_add_ / scatter_add_ atomics over repeated "
    "indices on the card, in no fixed order, and the card's reductions over "
    "3 components may round in another order; a position difference of an "
    "ulp (2.4e-7 at 3 m) is 120 times that in the velocity, (pos - prev) / "
    "dt")
CLOTH_SDF_TOL = 1e-5
CLOTH_SDF_REASON = (
    "the same elementwise float32 operations on both devices (sqrt and "
    "division correctly rounded on both), reductions over 3 components "
    "perhaps in another order; per-body impulse sums by scatter_add_ atomics "
    "on the card; each field held relative to max(1, its largest value)")


def cloth_kinds(scene):
    """Each collider's kind for the hit counts, (C,) int64 on the scene's
    device: 0 a ragdoll collider, 1 debris (the last TERRAIN_DEBRIS bodies
    of terrain_builder); the terrain is kind 2."""
    n_rag = scene.num_bodies - len(TERRAIN_DEBRIS)
    return (scene.colliders.body.long() >= n_rag).long()


CLOTH_KIND_NAMES = ("ragdoll", "debris", "terrain")


def cloth_contacts(scene, state, kinds):
    """For the free particles with a thickness, their deepest surface as
    ops/cloth.collide_particles picks it (the deepest collider, or the
    terrain where deeper) on `state`'s colliders: hits (B, 3) int64, each
    env's particles within CLOTH_HIT_MARGIN of their shell by the surface's
    kind (cloth_kinds), and the deepest particle's depth inside its shell
    (m), both on the device."""
    from dxk_tpu_torch.ops.cloth import _particle_collider_sdf
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.shapes import world_colliders
    cl = scene.cloth
    p = state.cloth.positions
    w = world_colliders(scene, state.pos, state.rot)
    sd, _n = _particle_collider_sdf(w, scene.hulls, p, cl.collider_groups)
    depth, ci = torch.max(cl.thickness - sd, dim=1)
    hdep = cl.thickness - (p[..., 1] - height_at(scene.heightfield,
                                                 p[..., 0], p[..., 2]))
    use_h = hdep > depth
    depth = torch.where(use_h, hdep, depth)
    kind = torch.where(use_h, 2, kinds[ci])
    thick = (cl.thickness > 0.0) & (cl.inv_masses > 0.0)
    hit = (depth > -CLOTH_HIT_MARGIN) & thick
    hits = torch.stack([(hit & (kind == k)).sum(1) for k in range(3)], -1)
    return hits, depth[:, thick].max()


def cloth_depth_report(scene, state, kinds):
    """The thick sheet's free particles inside their shells at `state`, by
    the kind of their deepest surface (cloth_kinds): the deepest depth (m)
    and the particles deeper than CLOTH_DEPTH_TOL; and the particles inside
    two surfaces at once (`trapped`: between a limb and the terrain, or in
    the overlap of two limbs at a joint), of which `trapped_deep` are
    deeper than CLOTH_DEPTH_TOL. The push-out moves a particle out of its
    deepest surface only, in both packages."""
    from dxk_tpu_torch.ops.cloth import _particle_collider_sdf
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.shapes import world_colliders
    cl = scene.cloth
    thick = (cl.thickness > 0.0) & (cl.inv_masses > 0.0)
    p = state.cloth.positions[:, thick]
    th = cl.thickness[thick]
    w = world_colliders(scene, state.pos, state.rot)
    sd, _n = _particle_collider_sdf(w, scene.hulls, p, cl.collider_groups)
    dep = th - sd                                         # (B, C, P')
    hdep = th - (p[..., 1] - height_at(scene.heightfield, p[..., 0],
                                       p[..., 2]))
    depth, ci = torch.max(dep, dim=1)
    use_h = hdep > depth
    depth = torch.where(use_h, hdep, depth)
    kind = torch.where(use_h, 2, kinds[ci])
    inside = (dep > 0.0).sum(1) + (hdep > 0.0).long()
    trapped = inside >= 2
    deep = depth > CLOTH_DEPTH_TOL
    out = dict(trapped=int(trapped.sum()),
               trapped_deep=int((trapped & deep).sum()))
    for k, name in enumerate(CLOTH_KIND_NAMES):
        m = kind == k
        out[name] = dict(
            deepest_m=float(torch.where(m, depth, -float("inf")).max()),
            deeper_than_tol=int((m & deep).sum()))
    return out


def cloth_drape_builder(builder, thickness=CLOTH_B_THICKNESS):
    """tests/test_cloth.py:108-116: a 0.8 m static sphere at (0, 1.5, 0)
    under an 8 x 8 sheet with a thickness, pinned at (0, 3, 0)."""
    b = builder()
    g = b.add_static(position=(0.0, 1.5, 0.0))
    b.add_sphere_collider(g, (0, 0, 0), 0.8)
    b.add_cloth(width=2.0, height=2.0, grid_x=8, grid_y=8, total_mass=1.0,
                transform_pos=(0, 3, 0), thickness=thickness)
    return b


CLOTH_DRAPE_ENVS = 128
CLOTH_DRAPE_STEPS = 600                   # tests/test_cloth.py:118's horizon
CLOTH_DRAPE_BOUND = 0.8 + 0.05 - 0.02     # tests/test_cloth.py:146


def cloth_drape_check(seed):
    """tests/test_cloth.py::test_drapes_on_sphere on the card: the sheet's
    free particles never come nearer the sphere's centre than its radius
    plus the thickness less 0.02 m, read every 10th step over
    CLOTH_DRAPE_STEPS "colored" steps of CLOTH_DRAPE_ENVS envs (their
    particle velocities given a seeded 0.01 m/s noise so that they
    differ)."""
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene import SceneBuilder
    scene = cloth_drape_builder(SceneBuilder).finalize(device=DEVICE)
    st = scene.initial_state(CLOTH_DRAPE_ENVS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    st = st.replace(cloth=st.cloth.replace(velocities=torch.randn(
        st.cloth.velocities.shape, generator=gen, device=DEVICE) * 0.01))
    free = scene.cloth.inv_masses > 0.0
    centre = torch.tensor([0.0, 1.5, 0.0], device=DEVICE)
    settings = PhysicsSettings(cloth_solver_mode=CLOTH_MODE)
    dmin = torch.full((), float("inf"), device=DEVICE)
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    t0 = time.perf_counter()
    for i in range(CLOTH_DRAPE_STEPS):
        st = physics_step(scene, st, settings, CLOTH_DT)[0]
        if i % 10 == 0:
            p = st.cloth.positions[:, free]
            finite &= torch.isfinite(p).all()
            dmin = torch.minimum(dmin, torch.linalg.vector_norm(
                p - centre, dim=-1).min())
    return dict(envs=CLOTH_DRAPE_ENVS, steps=CLOTH_DRAPE_STEPS,
                min_distance_m=float(dmin), bound_m=CLOTH_DRAPE_BOUND,
                finite=bool(finite), seconds=time.perf_counter() - t0)


def cloth_stretch(scene, state):
    """Per cloth, the largest over envs of the median relative stretch
    |length - rest| / rest of its constraints (tests/test_cloth.py:37-47)."""
    cl = scene.cloth
    cons = cl.constraints.long()
    p = state.cloth.positions
    cur = torch.linalg.vector_norm(p[:, cons[:, 0]] - p[:, cons[:, 1]],
                                   dim=-1)
    rel = (cur - cl.rest_lengths).abs() / torch.clamp(cl.rest_lengths,
                                                       min=1e-6)
    offs = [g[2] for g in cl.grids] + [cl.inv_masses.shape[0]]
    first = cl.constraints[:, 0].cpu().numpy()
    out = []
    for lo, hi in zip(offs[:-1], offs[1:]):
        k = np.flatnonzero((first >= lo) & (first < hi))
        out.append(float(rel[:, torch.from_numpy(k).to(p.device)]
                         .median(dim=1).values.max()))
    return out


def cloth_finite(state):
    """Every field of the state, cloth included, finite (on the device)."""
    ok = torch.ones((), dtype=torch.bool, device=state.pos.device)
    for x in (state.pos, state.rot, state.lin_vel, state.ang_vel,
              state.cloth.positions, state.cloth.prev_positions,
              state.cloth.velocities):
        ok &= torch.isfinite(x).all()
    return ok


def cloth_pinned_equal(scene, state):
    """The pinned particles (inverse mass 0) of every env bit-equal to their
    initial positions."""
    cl = scene.cloth
    pinned = cl.inv_masses == 0.0
    return bool(torch.equal(state.cloth.positions[:, pinned],
                            cl.init_positions[pinned].expand(
                                state.pos.shape[0], -1, -1)))


def _world_to(w, device):
    import dataclasses
    return dataclasses.replace(w, **{
        f.name: getattr(w, f.name).to(device)
        for f in dataclasses.fields(w)})


def _rel_err(a, b):
    """Largest |a - b| and max(1, the largest |b|), on the host."""
    return (float((a.cpu() - b.cpu()).abs().max()),
            max(1.0, float(b.abs().max())))


def cloth_cpu_check(scene, cpu_scene, state, mode):
    """CLOTH_CPU_STEPS cloth steps of CLOTH_CPU_ENVS envs of `state` on the
    card and on the CPU from the same inputs: the cloth state, and the
    colliders and solver bodies of `state`'s next step computed on the card
    and copied over. Returns each field's error and scale after the last
    step and, where the sheet collides, its two-way sums' and the last
    step's largest two-way impulse on a ragdoll body."""
    from dxk_tpu_torch.ops.cloth import cloth_step
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import PhysicsSettings
    n = CLOTH_CPU_ENVS
    st = _sub_state(state, lambda x: x[:n].contiguous())
    dt32 = float(np.float32(CLOTH_DT))
    w = world_colliders(scene, st.pos, st.rot)
    bodies = integrate_forces(scene, st, dt32)
    settings = PhysicsSettings(cloth_solver_mode=mode)
    sides = {}
    for name, sc, ww, bb, cl in (
            ("card", scene, w, bodies, st.cloth),
            ("cpu", cpu_scene, _world_to(w, "cpu"), bodies.to("cpu"),
             st.cloth.to("cpu"))):
        for _ in range(CLOTH_CPU_STEPS):
            cl, imp = cloth_step(sc.cloth, cl, settings, sc.global_ff_force,
                                 dt32, world=ww, hulls=sc.hulls,
                                 heightfield=sc.heightfield, bodies=bb,
                                 colbody=sc.colliders.body)
        sides[name] = (cl, imp)
    (kc, kimp), (cc, cimp) = sides["card"], sides["cpu"]
    fields = [("positions", kc.positions, cc.positions),
              ("velocities", kc.velocities, cc.velocities)]
    if kimp is not None:       # the sheet collides: its two-way sums
        fields += [("jsum", kimp[0], cimp[0]), ("tsum", kimp[1], cimp[1])]
    out = {}
    for key, a, b in fields:
        err, scale = _rel_err(a, b)
        out[key] = dict(err=err, scale=scale)
    if kimp is not None:
        n_rag = scene.num_bodies - len(TERRAIN_DEBRIS)
        out["ragdoll_impulse_max"] = float(kimp[0][:, :n_rag].abs().max())
    return out


def sdf_case_builder(builder):
    """One collider of each type on a body of its own (a sphere, a capsule,
    a cylinder, a box and the golden hull) over a patch of config 4's
    terrain, and a 20 x 16 sheet with a 0.05 m thickness whose particles
    cloth_sdf_case places around them."""
    b = builder()
    b.set_heightfield(terrain_heights()[:9, :9], cell_size=1.0,
                      min_corner=(-4.0, 0.0, -4.0), friction=1.0)
    s = b.add_body(position=(-2.0, 1.5, -2.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.4)
    c = b.add_body(position=(0.0, 1.5, -2.0))
    b.add_capsule_collider(c, (-0.3, 0, 0), (0.3, 0, 0), 0.2)
    y = b.add_body(position=(2.0, 1.5, -2.0))
    b.add_cylinder_collider(y, (0, -0.3, 0), (0, 0.3, 0), 0.3)
    x = b.add_body(position=(-2.0, 1.5, 2.0))
    b.add_box_collider(x, (0, 0, 0), (0.3, 0.2, 0.4))
    h = b.add_body(position=(2.0, 1.5, 2.0))
    b.add_hull_collider(h, b.add_hull_geometry_from_mesh(GOLDEN_HULL))
    b.add_cloth(width=2.0, height=2.0, grid_x=20, grid_y=16, total_mass=1.0,
                transform_pos=(0.0, 3.0, 0.0), thickness=0.05)
    return b


SDF_CASE_ENVS = 256
SDF_CASE_TARGETS = ("sphere", "capsule", "cylinder", "box", "hull", "terrain")


def cloth_sdf_case(seed):
    """Seeded inputs of the SDF case, on the CPU: SDF_CASE_ENVS envs of
    sdf_case_builder's scene with each body turned at random and given
    random velocities, and every particle placed at random within 0.7 m of
    the centre of one of the five colliders or 0-0.2 m over the terrain
    (particle i by target i mod 6). Returns the scene, the state, the
    particles (B, P, 3) and their velocities."""
    from dxk_tpu_torch.core.maths import quat_normalize
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.scene import SceneBuilder
    scene = sdf_case_builder(SceneBuilder).finalize(device="cpu")
    rng = np.random.default_rng(seed)
    B, nb = SDF_CASE_ENVS, scene.num_bodies
    P = scene.cloth.inv_masses.shape[0]
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    st = scene.initial_state(B)
    rot = st.rot.clone()
    rot[:, :nb] = quat_normalize(f32(rng.normal(size=(B, nb, 4))))
    st = st.replace(rot=rot, lin_vel=f32(rng.normal(size=(B, nb + 1, 3))),
                    ang_vel=f32(rng.normal(size=(B, nb + 1, 3))))
    target = np.arange(P) % len(SDF_CASE_TARGETS)
    p = st.pos[:, np.minimum(target, nb - 1)] + f32(
        rng.uniform(-0.7, 0.7, (B, P, 3)))
    ter = torch.from_numpy(target == nb)
    p[:, ter, 1] = height_at(scene.heightfield, p[:, ter, 0],
                             p[:, ter, 2]) + f32(rng.uniform(
                                 0.0, 0.2, (B, int(ter.sum()))))
    return scene, st, p, f32(rng.normal(size=(B, P, 3)))


def cloth_sdf_check(seed):
    """_particle_collider_sdf and collide_particles (two-way) on the card
    against the CPU on cloth_sdf_case's inputs, copied over to the card:
    each output's error and scale, and per collider the particles outside
    and inside its surface, and the terrain's particles pushed and clear."""
    from dxk_tpu_torch.ops.cloth import (_particle_collider_sdf,
                                         collide_particles)
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.scene import SceneBuilder
    scene_c, st, p, vel = cloth_sdf_case(seed)
    w_c = world_colliders(scene_c, st.pos, st.rot)
    bodies_c = integrate_forces(scene_c, st, float(np.float32(CLOTH_DT)))
    scene_k = sdf_case_builder(SceneBuilder).finalize(device=DEVICE)
    res = {}
    for name, sc, ww, bb, pp, vv in (
            ("cpu", scene_c, w_c, bodies_c, p, vel),
            ("card", scene_k, _world_to(w_c, DEVICE), bodies_c.to(DEVICE),
             p.to(DEVICE), vel.to(DEVICE))):
        sd, n = _particle_collider_sdf(ww, sc.hulls, pp,
                                       sc.cloth.collider_groups)
        res[name] = (sd, n) + collide_particles(
            sc.cloth, ww, sc.hulls, sc.heightfield, pp, vv, bodies=bb,
            colbody=sc.colliders.body)
    out = {}
    for i, key in enumerate(("sd", "normal", "pos", "vel", "jsum", "tsum")):
        err, scale = _rel_err(res["card"][i], res["cpu"][i])
        out[key] = dict(err=err, scale=scale)
    sd = res["cpu"][0]                                 # (B, C, P)
    target = np.arange(p.shape[1]) % len(SDF_CASE_TARGETS)
    cover = {}
    for t, tname in enumerate(SDF_CASE_TARGETS[:-1]):
        own = sd[:, t, torch.from_numpy(target == t)]
        cover[tname] = dict(outside=int((own > 0).sum()),
                            inside=int((own <= 0).sum()))
    ter = torch.from_numpy(target == len(SDF_CASE_TARGETS) - 1)
    pushed = (res["cpu"][2] - p).abs().amax(-1)[:, ter]
    cover["terrain"] = dict(pushed=int((pushed > 0).sum()),
                            clear=int((pushed == 0).sum()))
    out["coverage"] = cover
    return out


def cloth_phase(seed):
    """BASELINE config 4 without its vehicle (cloth_builder): the terrain,
    config 3's ragdoll, the debris, config 4's sheet and a thick sheet
    that swings onto the ragdoll and the terrain, on the fused step
    (prepped build, terrain rows passed in) with "colored" cloth and
    two-way coupling. The main path at each batch (launches, finiteness,
    pinned rows, stretch, hits by kind, depth inside the shells, rates,
    memory, the kernel's times); the kernel vs its plain version on bench's
    batch (initial, after the warm-up) and a ragged one; the cloth step on
    the card against the CPU in both cloth modes on the envs of bench's
    batch with the most ragdoll hits at the end; the particle SDF and
    push-out on seeded cases of every collider type and the terrain; the
    cloth substep's launches in each mode."""
    from dxk_tpu_torch.ops.cloth import cloth_step
    from dxk_tpu_torch.ops.integrator import integrate_forces
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    t_phase = time.perf_counter()
    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene = cloth_scene(DEVICE)
    cpu_scene = cloth_scene("cpu")
    tab = fs.fused_tables(scene, DEVICE)
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0)
    kinds = cloth_kinds(scene)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused",
                               cloth_solver_mode=CLOTH_MODE,
                               cloth_two_way=True)
    P = scene.cloth.inv_masses.shape[0]

    def warm_up(st):
        """CLOTH_WARM steps; hits by kind every 10th."""
        hits = torch.zeros(3, dtype=torch.int64, device=DEVICE)
        for i in range(CLOTH_WARM):
            st, _info = physics_step(scene, st, settings, CLOTH_DT)
            if i % 10 == 9:
                hits += cloth_contacts(scene, st, kinds)[0].sum(0)
        return st, dict(zip(CLOTH_KIND_NAMES, hits.tolist()))

    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase

    # ---- the ragged batch's states for the kernel check
    states = {}
    st = terrain_initial_state(scene, CLOTH_RAGGED, seed)
    states[f"B{CLOTH_RAGGED}_initial"] = st
    st, ragged_hits = warm_up(st)
    states[f"B{CLOTH_RAGGED}_after_{CLOTH_WARM}_steps"] = st
    mark("ragged_warm_up")

    # ---- the main path at each batch, counts from zero just before it
    runs, timing = {}, {}
    for batch, steps in zip(CLOTH_BATCHES, CLOTH_STEPS):
        st = terrain_initial_state(scene, batch, seed + 1)
        if batch == CLOTH_BATCHES[0]:
            states[f"B{batch}_initial"] = st
        st, run_warm_hits = warm_up(st)
        if batch == CLOTH_BATCHES[0]:
            states[f"B{batch}_after_{CLOTH_WARM}_steps"] = st
        hits = torch.zeros(3, dtype=torch.int64, device=DEVICE)
        deepest = torch.full((), -float("inf"), device=DEVICE)
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(steps):
            st, _info = physics_step(scene, st, settings, CLOTH_DT)
            if i % CLOTH_EVERY == CLOTH_EVERY - 1:
                h, d = cloth_contacts(scene, st, kinds)
                hits += h.sum(0)
                deepest = torch.maximum(deepest, d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        launches["fused_step.prepped"] = fs.launch_count("prepped")
        end_hits, end_depth = cloth_contacts(scene, st, kinds)
        end_report = cloth_depth_report(scene, st, kinds)
        if batch == CLOTH_BATCHES[0]:
            end_state, end_ragdoll_hits = st, end_hits[:, 0]
        holder = [st]

        def step():
            holder[0] = physics_step(scene, holder[0], settings,
                                     CLOTH_DT)[0]
        prof = profile_steps(step, CLOTH_PROFILED)
        ms = secs / steps * 1e3
        runs[batch] = dict(
            warm_steps=CLOTH_WARM, warm_hits_by_kind=run_warm_hits,
            steps=steps, seconds=secs,
            env_steps_per_s=batch * steps / secs,
            body_steps_per_s=scene.num_bodies * batch * steps / secs,
            particle_steps_per_s=P * batch * steps / secs,
            ms_per_step=ms, launches=launches,
            finite=bool(cloth_finite(st)),
            pinned_bit_equal=cloth_pinned_equal(scene, st),
            median_stretch_by_cloth=cloth_stretch(scene, st),
            hits_by_kind=dict(zip(CLOTH_KIND_NAMES, hits.tolist())),
            end_hits_by_kind=dict(zip(CLOTH_KIND_NAMES,
                                      end_hits.sum(0).tolist())),
            deepest_in_shell_m=float(deepest),
            end_deepest_in_shell_m=float(end_depth),
            end_depth_by_kind=end_report,
            peak_memory_bytes=peak,
            **{k: v for k, v in prof.items() if k != "top_device_kernels"},
            top_device_kernels=prof["top_device_kernels"][:4],
            device_idle_share=1.0 - prof["device_busy_ms_per_step"] / ms)
        # the kernel at this batch on the state after the run
        inputs = kernel_inputs(scene, st, CLOTH_DT)
        for _ in range(3):
            out = solver(*inputs)
        work = recipe_flops(tab, fs.recipe_branches(
            tab, inputs[1].a, inputs[1].b, inputs[1].rot), batch)
        b_ms, b_by, b_detail = bound_ms(tab, out[3], batch, work,
                                        prepped=False)
        timing[batch] = dict(ms=time_ms(lambda: solver(*inputs), 20),
                             bound_ms=b_ms, bound_by=b_by,
                             bound_detail=b_detail)
        mark(f"run_B{batch}")
    big = CLOTH_BATCHES[-1]
    bodies_k, wcol, ctl, inv_dt, passed = inputs
    timing[big]["plain_ms"] = time_ms(lambda: fs._fused_core(
        tab, ITERATIONS, 1.0, inv_dt, torch.cat([bodies_k.v, bodies_k.w], -1),
        bodies_k.inv_mass, bodies_k.inv_inertia, bodies_k.pos_cog,
        bodies_k.rot, ctl, wcol.a, wcol.b, wcol.rot, passed=passed), 1)

    mark("plain_ms")

    # ---- kernel vs plain version on bench's batch and the ragged one
    checks = hold_modes(scene, states, CLOTH_DT, False, prep_in_kernel=True)
    mark("kernel_checks")

    # ---- the cloth step on the card against the CPU, both cloth modes,
    # on the envs of bench's batch with the most ragdoll hits at the end
    envs = torch.argsort(end_ragdoll_hits, descending=True,
                         stable=True)[:CLOTH_CPU_ENVS]
    touching = _sub_state(end_state, lambda x: x[envs].contiguous())
    cpu_checks = {mode: cloth_cpu_check(scene, cpu_scene, touching, mode)
                  for mode in ("colored", "scan")}
    mark("card_vs_cpu")
    sdf = cloth_sdf_check(seed)
    mark("sdf_cases")
    drape = cloth_drape_check(seed + 2)
    mark("drape")

    # ---- launches of the cloth substep alone, each mode, at bench's batch
    # (one profiled call each: the launches are the same every call)
    w = world_colliders(scene, end_state.pos, end_state.rot)
    bodies = integrate_forces(scene, end_state, float(np.float32(CLOTH_DT)))
    cloth_prof = {}
    for mode in ("colored", "scan"):
        cs_ = PhysicsSettings(cloth_solver_mode=mode)

        def substep():
            cloth_step(scene.cloth, end_state.cloth, cs_,
                       scene.global_ff_force, float(np.float32(CLOTH_DT)),
                       world=w, hulls=scene.hulls,
                       heightfield=scene.heightfield, bodies=bodies,
                       colbody=scene.colliders.body)
        substep()
        prof = profile_steps(substep, 1)
        cloth_prof[mode] = {k: v for k, v in prof.items()
                            if k != "fused_kernel_ms_per_step"}
    mark("cloth_substep_profiles")
    seconds = time.perf_counter() - t_phase
    emit("cloth", bodies=scene.num_bodies, colliders=tab.num_colliders,
         particles=P, cloths=[list(g) for g in scene.cloth.grids],
         constraints=int(scene.cloth.constraints.shape[0]),
         colour_groups=len(scene.cloth.color_index),
         scan_levels=len(scene.cloth.scan_levels),
         cloth_b=dict(pos=list(CLOTH_B_POS), rot=list(CLOTH_B_ROT),
                      thickness=CLOTH_B_THICKNESS),
         iterations=ITERATIONS, dt=CLOTH_DT, cloth_solver_mode=CLOTH_MODE,
         plans=plans_by_batch(tab, CLOTH_BATCHES + (CLOTH_RAGGED,)),
         tolerance=KERNEL_TOL, tolerance_reason=TERRAIN_TOL_REASON,
         checks=checks, ragged_warm_hits_by_kind=ragged_hits,
         card_vs_cpu_envs=envs.tolist(),
         card_vs_cpu=cpu_checks, card_vs_cpu_tol=CLOTH_CPU_TOL,
         card_vs_cpu_reason=CLOTH_CPU_REASON, sdf_cases=sdf,
         sdf_tol=CLOTH_SDF_TOL, sdf_reason=CLOTH_SDF_REASON, drape=drape,
         depth_reason=CLOTH_DEPTH_REASON,
         cloth_substep=cloth_prof, stretch_tol=CLOTH_STRETCH_TOL,
         depth_tol=CLOTH_DEPTH_TOL, hit_margin=CLOTH_HIT_MARGIN,
         runs=runs, kernel=timing, seconds=seconds,
         seconds_at_end_of=marks)
    # ---- gates
    for name, c in checks.items():
        worst = max(c["err_v"] / c["v_scale"], c["err_w"] / c["w_scale"],
                    c["err_imp"] / c["imp_scale"])
        if not c["finite"] or c["mask_mismatch"] or not worst <= KERNEL_TOL:
            raise RuntimeError(f"cloth {name}: the kernel disagrees with its "
                               f"plain version: {c}")
    for mode, c in cpu_checks.items():
        bad = {k: v for k, v in c.items() if k != "ragdoll_impulse_max"
               and not v["err"] <= CLOTH_CPU_TOL * v["scale"]}
        if bad:
            raise RuntimeError(f"cloth {mode}: the card's cloth step "
                               f"disagrees with the CPU's: {bad}")
        if not c["ragdoll_impulse_max"] > 0.0:
            raise RuntimeError(f"cloth {mode}: no two-way impulse on the "
                               f"ragdoll: {c}")
    if not (drape["finite"]
            and drape["min_distance_m"] > CLOTH_DRAPE_BOUND):
        raise RuntimeError(f"cloth drape: a free particle came within "
                           f"{CLOTH_DRAPE_BOUND} m of the sphere: {drape}")
    bad = {k: v for k, v in sdf.items() if k != "coverage"
           and not v["err"] <= CLOTH_SDF_TOL * v["scale"]}
    dead = [f"{t}.{k}" for t, c in sdf["coverage"].items()
            for k, v in c.items() if v == 0]
    if bad or dead:
        raise RuntimeError(f"cloth sdf cases: card vs CPU {bad}, never "
                           f"reached {dead}")
    for batch, r in runs.items():
        want = {n: (r["steps"] if n == "fused_step" else 0)
                for n in counters}
        want["fused_step.prepped"] = r["steps"]
        hits = {k: r["warm_hits_by_kind"][k] + r["hits_by_kind"][k]
                + r["end_hits_by_kind"][k] for k in CLOTH_KIND_NAMES}
        if (r["launches"] != want or not r["finite"]
                or not r["pinned_bit_equal"]
                or not max(r["median_stretch_by_cloth"]) < CLOTH_STRETCH_TOL
                or not hits["ragdoll"] or not hits["terrain"]):
            raise RuntimeError(f"cloth B={batch}: launches {r['launches']} "
                               f"(expected {want}), hits {hits}: {r}")
    big = CLOTH_BATCHES[-1]
    return {
        "name": "fused_step_cloth", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step.prepped"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_imp"])
                           for c in checks.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(tab, big)}


# ---------------------------------------------------------------------------
# BASELINE config 4 whole: the vehicle and the sheet on the terrain

CONFIG4_VEHICLE_POS = (0.0, 1.6, 0.0)              # bench.py:377
CONFIG4_ORBIT_MARGIN = 0.5                         # bench.py:391
CONFIG4_MOTOR = dict(hinge_motor_type=0, hinge_target=3.0,
                     hinge_max_torque=500.0)       # bench.py:392-396


def config4_builder(builder, add_vehicle):
    """bench.py:367-388 (bench_cloth_vehicle_heightfield), copied: config
    4's terrain (terrain_heights, cell 1.0, min corner (-16, 0, -16),
    friction 1.0, no ground box), the vehicle at CONFIG4_VEHICLE_POS and
    the 12 x 12 sheet at CLOTH_A_POS. `builder` is a SceneBuilder class
    and `add_vehicle` its package's vehicle; returns (builder, vehicle),
    finalized by the caller (bench.py: orbit_margin=0.5)."""
    b = builder()
    b.set_heightfield(terrain_heights(), cell_size=TERRAIN_CELL,
                      min_corner=TERRAIN_CORNER, friction=1.0)
    veh = add_vehicle(b, initial_position=CONFIG4_VEHICLE_POS)
    b.add_cloth(**CLOTH_SHEET, transform_pos=CLOTH_A_POS)
    return b, veh


def with_motor(scene, veh):
    """The port's scene with the vehicle's motor hinge driven as bench.py
    drives it (velocity motor, target 3 rad/s, 500 N m)."""
    c = scene.default_controls
    fields = {}
    for name, value in CONFIG4_MOTOR.items():
        x = getattr(c, name).clone()
        x[veh.motor_hinge] = value
        fields[name] = x
    return scene.replace(default_controls=c.replace(**fields))


def config4_scene(device=DEVICE, orbit_margin=CONFIG4_ORBIT_MARGIN):
    """BASELINE config 4 as bench.py builds it, on the port: (scene with
    the motor driven, vehicle)."""
    from dxk_tpu_torch.models.vehicle import add_vehicle
    from dxk_tpu_torch.scene import SceneBuilder
    b, veh = config4_builder(SceneBuilder, add_vehicle)
    kw = {} if orbit_margin is None else dict(orbit_margin=orbit_margin)
    return with_motor(b.finalize(device=device, **kw), veh), veh


CONFIG4_BATCHES = (128, 4096)             # the cloth phase's batches
CONFIG4_STEPS = 180                       # tests/test_vehicle.py's horizon
CONFIG4_PRUNE_STEPS = 240                 # tests/test_orbit_prune.py's
CONFIG4_PRUNE_BATCH = 128                 # run that far at this batch
CONFIG4_RAGGED = 1000                     # envs of the 4096 run, held apart
CONFIG4_WARM = 60
CONFIG4_DT = 1.0 / 120.0
CONFIG4_MODE = "colored"                  # bench.py:394
CONFIG4_BODIES = 16
CONFIG4_POSE_ENVS = 256
CONFIG4_PROFILED = 3
CONFIG4_SPREAD = 5.0                      # tests/test_vehicle.py's bounds
CONFIG4_FLOOR = -1.0
CONFIG4_SPIN = 0.05
CONFIG4_SPIN_SHARE = 0.64                 # of envs 1.. above CONFIG4_SPIN at 180
CONFIG4_PRUNE_TOL = 1e-5
CONFIG4_RECIPES = ("capsule_capsule", "capsule_cylinder", "capsule_box",
                   "cylinder_cylinder", "cylinder_box", "passed")
CONFIG4_STATE_REASON = (
    "every env starts from the scene's initial state, as bench.py's "
    "_broadcast_state gives it; env 0 as it is, tests/test_vehicle.py's "
    "drop, the others with a seeded 0.01 m/s normal velocity noise (as "
    "tests/test_fused_solver.py perturbs its envs) so that they differ, "
    "drawn with numpy so that tools/vehicle_spin_cpu.py replays the same "
    "envs on the CPU")
CONFIG4_SPIN_REASON = (
    "tests/test_vehicle.py holds the motor gear's |w_y| > 0.05 rad/s at "
    "step 180 of one undisturbed drop: env 0 is that drop and holds it "
    "exactly; in envs that differ by the 0.01 m/s noise the loaded gear "
    "train stalls and slips back and forth, and the instant misses the "
    "bound in some envs in the JAX package too: its compiled \"jacobi\" "
    "step of config 4 on the CPU (tools/vehicle_spin_cpu.py, envs 1-63 of "
    "this phase's seed) has it in 50 of 63 (0.794, env 0 at 0.158 rad/s; "
    "the port's plain fused step there: 49 of 63, env 0 at 0.159), "
    "so the other envs hold a share: at least CONFIG4_SPIN_SHARE, JAX's "
    "0.794 less three binomial standard errors of a 63-env share (0.153)")
CONFIG4_PRUNE_REASON = (
    "pruning leaves out only pair rows that never touch, and the kernel "
    "skips a dead row and sums each body's deltas in row order, so the "
    "pruned and the unpruned scene step alike: 0.0 expected, held within "
    "1e-5 of max(1, the largest value)")
CONFIG4_CLOTH_REASON = (
    "bench.py adds config 4's sheet with no thickness, and a particle with "
    "no thickness collides with nothing in both packages (ops/cloth.py "
    "cloth_step calls collide_particles only where a thickness is > 0): the "
    "sheet hangs from its pinned row and never meets the terrain, so its "
    "terrain hits are 0 by construction; its clearance over the terrain is "
    "printed instead")
OVERLAP_ENVS = 256
OVERLAP_STEPS = 240
OVERLAP_EVERY = 20
OVERLAP_TOL = 1e-5
OVERLAP_REASON = (
    "_overlap_interactions on the card and on the CPU from the same state: "
    "the same float32 operations; the per-body force sums by index_add_ "
    "(atomics on the card) held within 1e-5 of max(1, the largest force)")


def config4_noise(batch, rows, seed):
    """(batch, rows, 3) float32 linear-velocity noise, normal with 0.01 m/s
    from numpy's default_rng(seed), env 0's zero; env e's rows are the same
    at every batch."""
    noise = np.random.default_rng(seed).normal(size=(batch, rows, 3)) * 0.01
    noise[0] = 0.0
    return noise.astype(np.float32)


def config4_initial_state(scene, batch, seed):
    """`batch` envs of config 4 from its initial state: env 0 as dropped,
    the others with config4_noise's velocity noise."""
    st = scene.initial_state(batch)
    noise = config4_noise(batch, st.lin_vel.shape[1], seed)
    return st.replace(lin_vel=st.lin_vel + torch.from_numpy(noise).to(
        st.lin_vel.device))


def config4_poses(scene, batch, seed):
    """`batch` envs of config 4 in which each of the five contact recipes has
    live rows: env e takes pair group e mod 5 (the groups hold capsule-
    capsule, capsule-cylinder, capsule-box, cylinder-cylinder and
    cylinder-box rows), picks a seeded row of it and turns the row's second
    collider's body by up to 40 degrees, then moves it so that collider's
    centre lies within 5 cm of the first's; then the whole vehicle is set
    down until its lowest support point is a seeded 0-3 cm below the terrain,
    so that terrain rows are live too."""
    from dxk_tpu_torch.core.maths import quat_mul
    from dxk_tpu_torch.ops.heightmap import height_at
    from dxk_tpu_torch.ops.shapes import world_colliders
    st = config4_initial_state(scene, batch, seed)
    rng = np.random.default_rng(seed)
    dev = st.pos.device
    pos, rot = st.pos.clone(), st.rot.clone()
    body = scene.colliders.body.long()
    groups = [g.pairs.long() for g in scene.pair_groups]
    for e in range(batch):
        pairs = groups[e % len(groups)]
        ia, ib = pairs[int(rng.integers(pairs.shape[0]))].tolist()
        mover = int(body[ib])
        axis = rng.normal(size=3)
        ang = np.radians(rng.uniform(0, 40))
        q = torch.tensor([*(axis / np.linalg.norm(axis) * np.sin(ang / 2)),
                          np.cos(ang / 2)], dtype=torch.float32, device=dev)
        rot[e, mover] = quat_mul(q, rot[e, mover])
        w = world_colliders(scene, pos[e:e + 1], rot[e:e + 1])
        centre = lambda c: (w.a[0, c] + w.b[0, c]) * 0.5 if int(
            scene.colliders.ctype[c]) in (1, 2) else w.a[0, c]
        target = centre(ia) + torch.from_numpy(
            rng.uniform(-0.05, 0.05, 3)).float().to(dev)
        pos[e, mover] += target - centre(ib)
    w = world_colliders(scene, pos, rot)
    low = terrain_lowest(scene, w)
    gap = low[..., 1] - height_at(scene.heightfield, low[..., 0],
                                  low[..., 2])
    depth = torch.from_numpy(rng.uniform(0, 0.03, batch)).float().to(dev)
    pos[:, :scene.num_bodies, 1] -= (gap.amin(dim=1) + depth)[:, None]
    return st.replace(pos=pos, rot=rot)


def vehicle_gates(scene, veh, state):
    """tests/test_vehicle.py::test_drop_and_drive's measures in every env of
    `state`, on the device: finite, each part's distance from the motor,
    each part's height, the motor gear's spin about y."""
    ids = torch.tensor(sorted(veh.parts.values()), device=state.pos.device)
    pos, vel = state.pos[:, ids], state.lin_vel[:, ids]
    spread = torch.linalg.vector_norm(
        pos - state.pos[:, veh.parts["motor"]][:, None], dim=-1)
    spin = state.ang_vel[:, veh.parts["motor_gear"], 1].abs()
    return dict(finite=bool(torch.isfinite(pos).all()
                            & torch.isfinite(vel).all()),
                spread_max_m=float(spread.max()),
                lowest_part_y_m=float(pos[..., 1].min()),
                spin_env0_rad_s=float(spin[0]),
                spin_min_rad_s=float(spin.min()),
                share_spin_above=float(
                    (spin[1:] > CONFIG4_SPIN).float().mean()))


def sheet_clearance(scene, state):
    """The sheet's lowest particle's height over the terrain below it (m),
    on the device."""
    from dxk_tpu_torch.ops.heightmap import height_at
    p = state.cloth.positions
    return (p[..., 1] - height_at(scene.heightfield, p[..., 0],
                                  p[..., 2])).min()


def overlap_check(seed):
    """A trigger volume and a localized force field on the card
    (overlap_builder's scene, OVERLAP_ENVS envs with seeded velocity noise,
    the fused step): every OVERLAP_EVERY-th step the trigger mask and each
    body's field force of _overlap_interactions on the card against the
    CPU from the same state, and the mask physics_step returned against
    the card's; over OVERLAP_STEPS steps, each env's trigger enter and leave
    events by pair (trigger_events: both spheres fall through the trigger
    box, one enter and one leave each) and the field bodies lifted."""
    from dxk_tpu_torch.events import trigger_events
    from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
    from dxk_tpu_torch.physics import (PhysicsSettings, _overlap_interactions,
                                       physics_step)
    from dxk_tpu_torch.scene import SceneBuilder
    b, field_bodies = overlap_builder(SceneBuilder)
    scene = b.finalize(device=DEVICE)
    cpu_scene = overlap_builder(SceneBuilder)[0].finalize(device="cpu")
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")
    st = zoo_initial_state(scene, OVERLAP_ENVS, seed)
    Q = scene.overlap_pairs.shape[0]
    prev = torch.zeros((OVERLAP_ENVS, Q), dtype=torch.bool, device=DEVICE)
    enters = torch.zeros_like(prev, dtype=torch.int64)
    leaves = torch.zeros_like(enters)
    lifted = torch.zeros(OVERLAP_ENVS, dtype=torch.bool, device=DEVICE)
    mismatch, step_mismatch, force_err, force_scale, samples = 0, 0, 0.0, 1.0, 0
    for i in range(OVERLAP_STEPS):
        if i % OVERLAP_EVERY == 0:
            outs = []
            for sc, s in ((scene, st), (cpu_scene, _sub_state(
                    st, lambda x: x.cpu()))):
                w = world_colliders(sc, s.pos, s.rot)
                mn, mx = collider_aabbs(sc, w)
                outs.append(_overlap_interactions(sc, w, mn, mx))
            (kt, kf), (ct, cf) = outs
            mismatch += int((kt.cpu() != ct).sum())
            err, scale = _rel_err(kf, cf)
            force_err, force_scale = max(force_err, err), max(force_scale,
                                                               scale)
            samples += 1
        st, info = physics_step(scene, st, settings, CONFIG4_DT)
        if i % OVERLAP_EVERY == 0:
            step_mismatch += int((info.trigger_overlap != kt).sum())
        e, l_ = trigger_events(prev, info.trigger_overlap)
        enters += e
        leaves += l_
        prev = info.trigger_overlap
        lifted |= (st.lin_vel[:, field_bodies, 1] > 0.0).any(-1)
    # the spheres' trigger pairs: each enters once and leaves once
    c = scene.colliders
    pairs = scene.overlap_pairs.long()
    sphere_pairs = ((c.owner_type[pairs].amax(-1) == 3)
                    & (c.ctype[pairs].amin(-1) == 0))
    per_env_enters = enters[:, sphere_pairs].sum(-1)
    per_env_leaves = leaves[:, sphere_pairs].sum(-1)
    want = int(sphere_pairs.sum())
    return dict(envs=OVERLAP_ENVS, steps=OVERLAP_STEPS,
                overlap_pairs=Q, sphere_trigger_pairs=want,
                enters_by_pair=enters.sum(0).tolist(),
                leaves_by_pair=leaves.sum(0).tolist(),
                field_force=list(OVERLAP_FF_FORCE),
                field_turn_rad=OVERLAP_FF_TURN,
                samples=samples, mask_mismatch_card_vs_cpu=mismatch,
                mask_mismatch_step_vs_card=step_mismatch,
                force_err=force_err, force_scale=force_scale,
                tolerance=OVERLAP_TOL, reason=OVERLAP_REASON,
                enters_per_env=sorted(set(per_env_enters.tolist())),
                leaves_per_env=sorted(set(per_env_leaves.tolist())),
                every_env_sphere_enters_and_leaves_once=bool(
                    (per_env_enters == want).all()
                    & (per_env_leaves == want).all()),
                envs_lifted=int(lifted.sum()),
                device=str(info.trigger_overlap.device))


def config4_phase(seed):
    """BASELINE config 4 whole (bench.py:354-396): the driven vehicle and
    the 12 x 12 sheet on the terrain, finalize(orbit_margin=0.5), on the
    fused step (prepped build, terrain rows passed in), "colored" cloth.
    The main path at each batch for CONFIG4_STEPS steps (CONFIG4_PRUNE_STEPS
    at CONFIG4_PRUNE_BATCH), counts from zero just before it:
    tests/test_vehicle.py's drop-and-drive gates in every env, the sheet's
    gates, rates, host and device ms and launches a step, peak memory, the
    kernel's times and bound; the kernel vs its plain version (initial,
    after CONFIG4_WARM steps, at 128 and a ragged 1000, on posed states
    with every recipe live, and after the 4096 run); the unpruned scene
    (2,591 rows) on the kernel beside the pruned one; the cloth step on the
    card against the CPU; a trigger and an owned force field on the card
    against the CPU (overlap_check)."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase

    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene, veh = config4_scene(DEVICE)
    cpu_scene, _veh = config4_scene("cpu")
    tab = fs.fused_tables(scene, DEVICE)
    solver = fs.make_fused_step_solver(scene, ITERATIONS, 1.0)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused",
                               cloth_solver_mode=CONFIG4_MODE)
    P = scene.cloth.inv_masses.shape[0]

    def counted(fn):
        for mod in counters.values():
            mod.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = {n: mod.launch_count() for n, mod in counters.items()}
        launches["fused_step.prepped"] = fs.launch_count("prepped")
        return out, time.perf_counter() - t0, launches

    # ---- the main path at each batch, counts from zero just before it
    states, runs, timing, ends = {}, {}, {}, {}
    for batch in CONFIG4_BATCHES:
        steps = (CONFIG4_PRUNE_STEPS if batch == CONFIG4_PRUNE_BATCH
                 else CONFIG4_STEPS)
        st0 = config4_initial_state(scene, batch, seed)
        snap = {}

        def run(st=st0, steps=steps, snap=snap):
            clear = torch.full((), float("inf"), device=DEVICE)
            for i in range(steps):
                st = physics_step(scene, st, settings, CONFIG4_DT)[0]
                if i == CONFIG4_WARM - 1:
                    snap["warm"] = st
                if i == CONFIG4_STEPS - 1:
                    snap["gated"] = st
                if i % 25 == 24:
                    clear = torch.minimum(clear, sheet_clearance(scene, st))
            snap["clear"] = clear
            return st
        torch.cuda.reset_peak_memory_stats()
        st, secs, launches = counted(run)
        peak = torch.cuda.max_memory_allocated()
        if batch == CONFIG4_BATCHES[0]:
            states[f"B{batch}_initial"] = st0
            states[f"B{batch}_after_{CONFIG4_WARM}_steps"] = snap["warm"]
        else:
            cut = lambda x: x[:CONFIG4_RAGGED].contiguous()
            states[f"B{CONFIG4_RAGGED}_initial"] = _sub_state(st0, cut)
            states[f"B{CONFIG4_RAGGED}_after_{CONFIG4_WARM}_steps"] = \
                _sub_state(snap["warm"], cut)
        ends[batch] = st
        holder = [st]

        def step():
            holder[0] = physics_step(scene, holder[0], settings,
                                     CONFIG4_DT)[0]
        prof = profile_steps(step, CONFIG4_PROFILED)
        ms = secs / steps * 1e3
        gates = vehicle_gates(scene, veh, snap["gated"])
        runs[batch] = dict(
            steps=steps, gated_at_step=CONFIG4_STEPS, seconds=secs,
            env_steps_per_s=batch * steps / secs,
            body_steps_per_s=CONFIG4_BODIES * batch * steps / secs,
            particle_steps_per_s=P * batch * steps / secs,
            ms_per_step=ms, launches=launches, vehicle=gates,
            cloth_finite=bool(cloth_finite(st)),
            pinned_bit_equal=cloth_pinned_equal(scene, st),
            median_stretch_by_cloth=cloth_stretch(scene, st),
            sheet_min_clearance_m=float(snap["clear"]),
            peak_memory_bytes=peak,
            **{k: v for k, v in prof.items() if k != "top_device_kernels"},
            top_device_kernels=prof["top_device_kernels"][:4],
            device_idle_share=1.0 - prof["device_busy_ms_per_step"] / ms)
        # the kernel at this batch on the state after the run
        inputs = kernel_inputs(scene, st, CONFIG4_DT)
        for _ in range(3):
            out = solver(*inputs)
        work = recipe_flops(tab, fs.recipe_branches(
            tab, inputs[1].a, inputs[1].b, inputs[1].rot), batch)
        b_ms, b_by, b_detail = bound_ms(tab, out[3], batch, work)
        timing[batch] = dict(ms=time_ms(lambda: solver(*inputs), 20),
                             bound_ms=b_ms, bound_by=b_by,
                             bound_detail=b_detail, recipe_flops=work)
        mark(f"run_B{batch}")
    big = CONFIG4_BATCHES[-1]
    bodies_k, wcol, ctl, inv_dt, passed = inputs
    timing[big]["plain_ms"] = time_ms(lambda: fs._fused_core(
        tab, ITERATIONS, 1.0, inv_dt, torch.cat([bodies_k.v, bodies_k.w], -1),
        bodies_k.inv_mass, bodies_k.inv_inertia, bodies_k.pos_cog,
        bodies_k.rot, ctl, wcol.a, wcol.b, wcol.rot, passed=passed), 1)
    mark("plain_ms")

    # ---- pruning leaves the trajectory alone: the unpruned scene on the
    # kernel from the same initial state as the pruned run at its batch
    uscene, _uveh = config4_scene(DEVICE, orbit_margin=None)
    utab = fs.fused_tables(uscene, DEVICE)
    nb = CONFIG4_PRUNE_BATCH

    def urun():
        st = config4_initial_state(uscene, nb, seed)
        for _ in range(CONFIG4_PRUNE_STEPS):
            st = physics_step(uscene, st, settings, CONFIG4_DT)[0]
        return st
    ust, usecs, ulaunches = counted(urun)
    pst = ends[nb]
    diffs = {}
    for name, a, b in (("pos", ust.pos, pst.pos), ("rot", ust.rot, pst.rot),
                       ("lin_vel", ust.lin_vel, pst.lin_vel),
                       ("ang_vel", ust.ang_vel, pst.ang_vel),
                       ("cloth", ust.cloth.positions, pst.cloth.positions)):
        err, scale = _rel_err(a, b)
        diffs[name] = dict(err=err, scale=scale)
    prune = dict(batch=nb, steps=CONFIG4_PRUNE_STEPS,
                 pair_rows=dict(pruned=tab.num_rows, unpruned=utab.num_rows),
                 plans=dict(pruned=vars(tab.launch_plan(nb)),
                            unpruned=vars(utab.launch_plan(nb))),
                 unpruned_seconds=usecs, unpruned_launches=ulaunches,
                 diffs=diffs, bit_equal=all(v["err"] == 0.0
                                            for v in diffs.values()),
                 tolerance=CONFIG4_PRUNE_TOL, reason=CONFIG4_PRUNE_REASON)
    mark("prune_check")

    # ---- kernel vs plain version: bench's batch, a ragged one, the posed
    # states with every recipe live, and the 4096 run's last state
    states[f"B{CONFIG4_POSE_ENVS}_poses"] = config4_poses(
        scene, CONFIG4_POSE_ENVS, seed + 1)
    states[f"B{big}_after_{CONFIG4_STEPS}_steps"] = ends[big]
    checks = hold_modes(scene, states, CONFIG4_DT, False, prep_in_kernel=True)
    live = {}
    for c in checks.values():
        for r, n in c["live_rows_by_recipe"].items():
            live[r] = live.get(r, 0) + n
    mark("kernel_checks")

    # ---- the cloth step on the card against the CPU, both cloth modes
    first = _sub_state(ends[CONFIG4_BATCHES[0]],
                       lambda x: x[:CLOTH_CPU_ENVS].contiguous())
    cpu_checks = {mode: cloth_cpu_check(scene, cpu_scene, first, mode)
                  for mode in ("colored", "scan")}
    mark("cloth_card_vs_cpu")
    overlaps = overlap_check(seed + 2)
    mark("overlap_check")
    seconds = time.perf_counter() - t_phase
    emit("config4", bodies=scene.num_bodies, colliders=tab.num_colliders,
         pair_rows=tab.num_rows, joints=tab.joint_counts, particles=P,
         orbit_margin=CONFIG4_ORBIT_MARGIN, motor=CONFIG4_MOTOR,
         iterations=ITERATIONS, dt=CONFIG4_DT,
         cloth_solver_mode=CONFIG4_MODE, state_reason=CONFIG4_STATE_REASON,
         plans=plans_by_batch(tab, CONFIG4_BATCHES + (CONFIG4_RAGGED,
                                                      CONFIG4_POSE_ENVS)),
         tolerance=KERNEL_TOL, tolerance_reason=TERRAIN_TOL_REASON,
         checks=checks, live_rows_by_recipe=live,
         vehicle_bounds=dict(spread_m=CONFIG4_SPREAD, floor_m=CONFIG4_FLOOR,
                             spin_rad_s=CONFIG4_SPIN,
                             spin_share=CONFIG4_SPIN_SHARE),
         spin_reason=CONFIG4_SPIN_REASON, prune=prune,
         card_vs_cpu=cpu_checks, card_vs_cpu_tol=CLOTH_CPU_TOL,
         card_vs_cpu_reason=CLOTH_CPU_REASON, cloth_reason=CONFIG4_CLOTH_REASON,
         stretch_tol=CLOTH_STRETCH_TOL, overlaps=overlaps, runs=runs,
         kernel=timing, seconds=seconds, seconds_at_end_of=marks)
    # ---- gates
    for name, c in checks.items():
        worst = max(c["err_v"] / c["v_scale"], c["err_w"] / c["w_scale"],
                    c["err_imp"] / c["imp_scale"])
        if not c["finite"] or c["mask_mismatch"] or not worst <= KERNEL_TOL:
            raise RuntimeError(f"config4 {name}: the kernel disagrees with "
                               f"its plain version: {c}")
    dead = [r for r in CONFIG4_RECIPES if not live.get(r, 0)]
    if dead:
        raise RuntimeError(f"config4: no live {dead} row in the compared "
                           f"states: {live}")
    for batch, r in runs.items():
        want = {n: (r["steps"] if n == "fused_step" else 0)
                for n in counters}
        want["fused_step.prepped"] = r["steps"]
        v = r["vehicle"]
        if (r["launches"] != want or not v["finite"]
                or not v["spread_max_m"] < CONFIG4_SPREAD
                or not v["lowest_part_y_m"] > CONFIG4_FLOOR
                or not v["spin_env0_rad_s"] > CONFIG4_SPIN
                or not v["share_spin_above"] >= CONFIG4_SPIN_SHARE
                or not r["cloth_finite"] or not r["pinned_bit_equal"]
                or not max(r["median_stretch_by_cloth"]) < CLOTH_STRETCH_TOL):
            raise RuntimeError(f"config4 B={batch}: launches {r['launches']} "
                               f"(expected {want}): {r}")
    want = {n: (CONFIG4_PRUNE_STEPS if n == "fused_step" else 0)
            for n in counters}
    want["fused_step.prepped"] = CONFIG4_PRUNE_STEPS
    bad = {k: v for k, v in diffs.items()
           if not v["err"] <= CONFIG4_PRUNE_TOL * v["scale"]}
    if bad or ulaunches != want:
        raise RuntimeError(f"config4: the unpruned scene parts from the "
                           f"pruned one: {prune}")
    for mode, c in cpu_checks.items():
        bad = {k: v for k, v in c.items()
               if not v["err"] <= CLOTH_CPU_TOL * v["scale"]}
        if bad:
            raise RuntimeError(f"config4 cloth {mode}: the card's cloth step "
                               f"disagrees with the CPU's: {bad}")
    if (overlaps["mask_mismatch_card_vs_cpu"]
            or overlaps["mask_mismatch_step_vs_card"]
            or not overlaps["force_err"] <= OVERLAP_TOL
            * overlaps["force_scale"]
            or not overlaps["every_env_sphere_enters_and_leaves_once"]
            or overlaps["envs_lifted"] != OVERLAP_ENVS
            or overlaps["device"] == "cpu"):
        raise RuntimeError(f"config4: trigger / force-field check failed: "
                           f"{overlaps}")
    return {
        "name": "fused_step_config4", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": runs[big]["launches"]["fused_step.prepped"],
        "max_abs_err": max(max(c["err_v"], c["err_w"], c["err_imp"])
                           for c in checks.values()),
        "ms": timing[big]["ms"], "plain_ms": timing[big]["plain_ms"],
        "bound_ms": timing[big]["bound_ms"],
        "bound_by": timing[big]["bound_by"], "library_ms": None,
        **plan_fields(tab, big)}


# ---------------------------------------------------------------------------
# a 1,081-row box pile: a scene the one-env-per-block kernel refused

BIGPILE_BOXES = 46
BIGPILE_HALF = 0.2
BIGPILE_LAYERS = (16, 16, 14)            # boxes per layer, on a 4 x 4 grid
BIGPILE_GAP = 0.01                       # m between neighbours in a layer
BIGPILE_SINK = 0.002                     # m each layer rests in the one below
BIGPILE_BATCHES = (256,)
BIGPILE_RAGGED = 1000
BIGPILE_WARM = 60
BIGPILE_DT = 1.0 / 120.0
BIGPILE_TOL_REASON = (
    "velocities and impulses held relative to the largest one, as in the "
    "settle phase: on the card the plain version sums per-body deltas with "
    "index_add_ atomics in no fixed order, so after steps the two differ by "
    "float rounding; on the initial states 0.0 is expected")


def bigpile_builder(builder):
    """46 boxes of 0.4 m in three layers on a 4 x 4 grid on a ground box
    (40 x 2 x 40, top at y = 0), each layer a few millimetres into the one
    below; finalize()'s default all-pairs tables give 47 * 46 / 2 = 1,081
    box-box rows and 4,324 point slots, whose one-env-per-block shared
    memory (581,632 bytes) no block holds."""
    b = builder()
    ground = b.add_static()
    b.add_box_collider(ground, (0, -1, 0), (20, 1, 20))
    h, step = BIGPILE_HALF, 2 * BIGPILE_HALF + BIGPILE_GAP
    for layer, n in enumerate(BIGPILE_LAYERS):
        y = h - BIGPILE_SINK + layer * (2 * h - BIGPILE_SINK)
        for i in range(n):
            x, z = (i % 4 - 1.5) * step, (i // 4 - 1.5) * step
            body = b.add_body(position=(x, y, z))
            b.add_box_collider(body, (0, 0, 0), (h, h, h))
    return b


def bigpile_scene(device=DEVICE):
    from dxk_tpu_torch.scene import SceneBuilder
    return bigpile_builder(SceneBuilder).finalize(device=device)


def one_block_per_env_bytes(tab):
    """Shared memory the one-env-per-block kernel carved for a scene: every
    body's state, collider params, controls, joint rows and impulses, one
    joint pass's deltas, all point slots' 30 fields, every row's deltas,
    inverse degrees and masks."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    nb, C = tab.num_bodies, tab.num_colliders
    return 4 * (nb * 23 + C * 10 + tab.ctl_rows + 1 + tab.joint_row_floats
                + tab.joint_acc_floats
                + 12 * max(max(tab.joint_counts.values()), 1)
                + fs.POINT_FIELDS * tab.num_points + 13 * tab.num_rows
                + tab.num_phases * nb)


def bigpile_phase(seed):
    """The 1,081-row box pile on the fused step: kernel vs plain version on
    the card at B=256 and a ragged 1000, on the initial state and after 60
    steps, and the kernel's times at each."""
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    scene = bigpile_scene()
    tab = fs.fused_tables(scene, DEVICE)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")
    checks, timing = {}, {}
    for batch in BIGPILE_BATCHES + (BIGPILE_RAGGED,):
        st = zoo_initial_state(scene, batch, seed)
        checks[f"B{batch}_initial"] = compare_kernel(scene, st, batch,
                                                     BIGPILE_DT)[0]
        for _ in range(BIGPILE_WARM):
            st, _info = physics_step(scene, st, settings, BIGPILE_DT)
        cmp, run_kernel, run_plain, _tab, klive = compare_kernel(
            scene, st, batch, BIGPILE_DT)
        checks[f"B{batch}_after_{BIGPILE_WARM}_steps"] = cmp
        for _ in range(3):
            run_kernel()
        b_ms, b_by, b_detail = bound_ms(tab, klive, batch)
        timing[batch] = dict(ms=time_ms(run_kernel, 20),
                             plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
                             bound_by=b_by, bound_detail=b_detail)
    emit("bigpile", bodies=scene.num_bodies, colliders=tab.num_colliders,
         pair_rows=tab.num_rows, point_slots=tab.num_points,
         one_block_per_env_smem_bytes=one_block_per_env_bytes(tab),
         iterations=ITERATIONS, dt=BIGPILE_DT,
         plans=plans_by_batch(tab, BIGPILE_BATCHES + (BIGPILE_RAGGED,
                                                      NUM_ENVS)),
         tolerance=KERNEL_TOL, tolerance_reason=BIGPILE_TOL_REASON,
         checks=checks, kernel=timing)
    for c in checks.values():
        hold_fused(c, relative=True)
    if not all(c["live_rows_per_env"] > 0 for k, c in checks.items()
               if "after" in k):
        raise RuntimeError("bigpile: no live contact row after the steps")


# ---------------------------------------------------------------------------
# BASELINE config 1's default path: the 1k-box stack as island envs on the
# fused step (bench.py's "fused_islands")

ISLAND_PHASES = 2                         # bench.py's tuned box stack
ISLAND_MARGIN = 0.25
ISLAND_WARM = 60
ISLAND_STEPS = 600                        # tests/test_islands.py's horizon
ISLAND_FULL_STEPS = 3                     # tests/test_islands.py
ISLAND_POS_TOL = 1e-5
ISLAND_VEL_TOL = 1e-4
ISLAND_TOL_REASON = ("tests/test_islands.py's bound between a scene and its "
                     "islands: the same contacts and joints, their per-body "
                     "sums in another order")
ISLAND_TOP_DROP = 0.15                    # tests/test_islands.py's standing
ISLAND_XZ_MOVE = 0.25                     # tower bounds (bench tuning)
ISLAND_STAND_GATED = 120                  # steps the bounds are held over
ISLAND_STAND_REASON = (
    "the towers lean in the JAX package's own island step too: on the CPU "
    "its \"fused\" step, 64 towers, has by step 600 a box past 0.25 m "
    "sideways in all 64 islands and a top box down past 0.15 m in 54 from "
    "bench.py's spawn, 64 and 51 from this phase's 0.5 mm jitter (the "
    "port's plain version: 64 and 41, 64 and 57; the median sideways move "
    "1.27 m and 1.34 m in JAX, 1.23 m and 1.38 m in the port), and no "
    "island of either package past either bound up to step 175 "
    "(tools/island_towers_cpu.py); "
    "tests/test_torch_island_drift.py holds the port's drift against the "
    "JAX step's; so the bounds are held over the first ISLAND_STAND_GATED "
    "steps of every island env and the 600-step values are printed")
ISLAND_PROFILED = 3
SERVICE_ENVS = 16
SERVICE_STEPS = 3
SERVICE_NAN_ENV = 5


def island_scene(device=None):
    """bench.py's 1k-box stack finalized as its fused_islands default
    takes it: 2 contact phases, candidate margin 0.25."""
    from dxk_tpu_torch.scene import SceneBuilder
    return box_towers(SceneBuilder).finalize(
        contact_phases=ISLAND_PHASES, candidate_margin=ISLAND_MARGIN,
        device=device or DEVICE)


def services_check(sub, state, seed):
    """The engine services on the card: VecLocoEnv steps, the validate
    stage of a NaN position on the fused step, editor picking."""
    from dxk_tpu_torch.envs.gym_adapter import VecLocoEnv
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene.session import SceneSession
    from dxk_tpu_torch.utils.knn import knn
    from dxk_tpu_torch.utils.validate import STAGE_ID

    venv = VecLocoEnv(num_envs=SERVICE_ENVS, seed=seed, device=DEVICE)
    obs = venv.reset()
    rewards = []
    for _ in range(SERVICE_STEPS):
        obs, rew, done, _infos = venv.step(
            np.zeros((SERVICE_ENVS, 27), np.float32))
        rewards.append(float(rew.mean()))
    vec = dict(envs=SERVICE_ENVS, steps=SERVICE_STEPS,
               solver_mode=venv.env.settings.solver_mode,
               obs_shape=list(obs.shape), mean_reward_by_step=rewards,
               finite=bool(np.isfinite(obs).all() and np.isfinite(rewards)
                           .all()))

    vset = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                           solver_mode="fused", validate=True)
    clean = physics_step(sub, state, vset, BOX_DT)[1].validate_stage
    pos = state.pos.clone()
    pos[SERVICE_NAN_ENV, 0, 1] = float("nan")
    bad = physics_step(sub, state.replace(pos=pos), vset,
                       BOX_DT)[1].validate_stage
    want = torch.full_like(bad, -1)
    want[SERVICE_NAN_ENV] = STAGE_ID["world_colliders"]
    validate = dict(device=str(bad.device), dtype=str(bad.dtype),
                    clean_all_minus_one=bool((clean == -1).all()),
                    nan_env=SERVICE_NAN_ENV,
                    nan_env_stage=int(bad[SERVICE_NAN_ENV]),
                    as_expected=bool(torch.equal(bad, want)))

    sess = SceneSession(sub, lambda s: s, state)
    point = state.pos[0, 0].tolist()
    idx, sq = sess.pick_nearest_body((point[0] + 0.05, point[1], point[2]))
    cpu_idx, _sq = knn(state.pos.cpu(), torch.tensor(
        [[point[0] + 0.05, point[1], point[2]]]).expand(
            state.pos.shape[0], 1, 3), 1)
    pick = dict(device=str(idx.device), env0_index=int(idx[0, 0]),
                env0_sq_dist=float(sq[0, 0]),
                equal_to_cpu=bool(torch.equal(idx.cpu(), cpu_idx[:, 0])))
    out = dict(vec_env=vec, validate=validate, pick=pick)
    if not (vec["finite"] and validate["clean_all_minus_one"]
            and validate["as_expected"] and pick["env0_index"] == 0
            and pick["equal_to_cpu"] and idx.device.type == "cuda"
            and bad.device.type == "cuda"):
        raise RuntimeError(f"services check failed: {out}")
    return out


OVERLAP_FF_FORCE = (0.0, 1500.0, 0.0)     # N, in the field owner's frame
OVERLAP_FF_TURN = 0.3                     # rad about z: the force is turned


def overlap_builder(builder):
    """A trigger volume and a localized force field over a ground box
    (tests/test_events.py's trigger scene, widened): a static 2 x 1 x 2 m
    trigger box 2 m up, which two spheres fall through, and a static 2 m
    force-field cube at x = -3, turned OVERLAP_FF_TURN about z, whose force
    (1500 N up in its own frame, so also 443 N towards -x, away from the
    trigger) lifts the box and the capsule dropped into it. Returns
    (builder, the ids of those two bodies)."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    trig = b.add_static(position=(0.0, 2.0, 0.0))
    b.add_box_collider(trig, (0, 0, 0), (1.0, 0.5, 1.0))
    b.mark_trigger(trig)
    h = OVERLAP_FF_TURN * 0.5
    ff = b.add_static(position=(-3.0, 1.0, 0.0),
                      rotation=(0.0, 0.0, float(np.sin(h)), float(np.cos(h))))
    b.add_box_collider(ff, (0, 0, 0), (1.0, 1.0, 1.0))
    b.add_force_field(OVERLAP_FF_FORCE, owner=ff)
    for x, y, z in ((0.0, 4.0, 0.0), (0.5, 5.5, 0.3)):
        b.add_sphere_collider(b.add_body(position=(x, y, z)), (0, 0, 0), 0.3)
    box = b.add_body(position=(-3.0, 3.0, 0.0))
    b.add_box_collider(box, (0, 0, 0), (0.2, 0.2, 0.2))
    capsule = b.add_body(position=(-2.7, 4.0, 0.2))
    b.add_capsule_collider(capsule, (-0.25, 0, 0), (0.25, 0, 0), 0.15)
    return b, [box, capsule]


def islands_phase(seed, smi):
    """BASELINE config 1 on its default path: islandize turns the 64 towers
    into 64 identical 16-box sub-scenes, gather puts BOX_BATCH worlds of them
    on the batch axis (2,048 envs of 17 bodies) and one fused-kernel launch
    steps them all. The kernel vs its plain version on the island states;
    the full scene and its islands scattered back agreeing on "colored"
    steps; the main path over ISLAND_STEPS steps with the standing-tower
    invariant; then the services check."""
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene.islands import islandize

    t_phase = time.perf_counter()
    counters = {"fused_step": fs, "aabb_overlap_matrix": bk,
                "kselect_broadphase": ks, "sap_broadphase": sp}
    scene = island_scene()
    t0 = time.perf_counter()
    im = islandize(scene)
    islandize_s = time.perf_counter() - t0
    sub = im.sub_scene
    tab = fs.fused_tables(sub, DEVICE)
    settings = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                               solver_mode="fused")
    full0 = box_initial_state(scene, seed)
    isl0 = im.gather(full0)
    B = isl0.pos.shape[0]
    top = sub.num_bodies - 1              # an island's top box
    boxes = scene.num_bodies - 1          # body 0 owns the ground

    # ---- kernel vs plain version on the island states
    st = isl0
    for _ in range(ISLAND_WARM):
        st = physics_step(sub, st, settings, BOX_DT)[0]
    checks = {}
    for where, state in (("initial", isl0), (f"after_{ISLAND_WARM}_steps",
                                             st)):
        checks[where] = compare_kernel(sub, state, B, BOX_DT)[0]
        hold_fused(checks[where])

    # ---- islands are exact: one world, the full scene and its islands
    colored = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                              solver_mode="colored")
    one = _sub_state(full0, lambda x: x[:1].contiguous())
    full, isl = one, im.gather(one)
    for _ in range(ISLAND_FULL_STEPS):
        full = physics_step(scene, full, colored, BOX_DT)[0]
        isl = physics_step(sub, isl, colored, BOX_DT)[0]
    back = im.scatter(isl, one)
    exact = dict(
        worlds=1, steps=ISLAND_FULL_STEPS, mode="colored",
        err_pos=float((back.pos - full.pos).abs().max()),
        err_vel=float((back.lin_vel - full.lin_vel).abs().max()),
        err_ang_vel=float((back.ang_vel - full.ang_vel).abs().max()),
        moved_by=float((full.pos - one.pos).abs().max()))

    # ---- the main path, counts from zero just before it
    def standing(s):
        """Each island env's top-box fall and largest sideways box move."""
        return (isl0.pos[:, top, 1] - s.pos[:, top, 1],
                (s.pos - isl0.pos)[:, :sub.num_bodies][..., [0, 2]].abs()
                .amax(dim=(1, 2)))

    def finite(s):
        return bool(torch.isfinite(s.pos).all()
                    & torch.isfinite(s.lin_vel).all())

    # the timed loop steps and nothing else: the state after
    # ISLAND_STAND_GATED steps is kept, and both are checked after it
    st, at_gate = isl0, None
    for mod in counters.values():
        mod.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ISLAND_STEPS):
        st = physics_step(sub, st, settings, BOX_DT)[0]
        if i + 1 == ISLAND_STAND_GATED:
            at_gate = st
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: mod.launch_count() for n, mod in counters.items()}
    launches["fused_step.base"] = fs.launch_count("base")
    gated, (drop, xz) = standing(at_gate), standing(st)
    holder = [st]

    def step():
        holder[0] = physics_step(sub, holder[0], settings, BOX_DT)[0]
    prof = profile_steps(step, ISLAND_PROFILED)
    host_ms = secs / ISLAND_STEPS * 1e3
    run = dict(
        steps=ISLAND_STEPS, seconds=secs,
        body_steps_per_s=boxes * BOX_BATCH * ISLAND_STEPS / secs,
        ms_per_step=host_ms, launches=launches,
        finite=finite(at_gate) and finite(st),
        gated_steps=ISLAND_STAND_GATED,
        gated_top_box_drop_max_m=float(gated[0].max()),
        gated_top_box_drop_median_m=float(gated[0].median()),
        gated_max_xz_move_m=float(gated[1].max()),
        gated_median_xz_move_m=float(gated[1].median()),
        top_box_drop_max_m=float(drop.max()),
        top_box_drop_median_m=float(drop.median()),
        max_xz_move_m=float(xz.max()),
        median_xz_move_m=float(xz.median()),
        envs_past_drop_bound=int((drop >= ISLAND_TOP_DROP).sum()),
        envs_past_xz_bound=int((xz >= ISLAND_XZ_MOVE).sum()),
        scatter_back_finite=bool(torch.isfinite(
            im.scatter(st, full0).pos).all()),
        **{k: v for k, v in prof.items()},
        device_idle_share=1.0 - prof["device_busy_ms_per_step"] / host_ms)

    # ---- the kernel at B on the state after the run
    inputs = kernel_inputs(sub, st, BOX_DT)
    bodies, wcol, ctl, inv_dt, passed = inputs
    solver = fs.make_fused_step_solver(sub, ITERATIONS, 1.0)
    for _ in range(3):
        out = solver(*inputs)
    klive = out[3]

    def run_plain():
        return fs._fused_core(
            tab, ITERATIONS, 1.0, inv_dt, torch.cat([bodies.v, bodies.w], -1),
            bodies.inv_mass, bodies.inv_inertia, bodies.pos_cog, bodies.rot,
            ctl, wcol.a, wcol.b, wcol.rot, passed=passed)
    b_ms, b_by, b_detail = bound_ms(tab, klive, B)
    timing = dict(batch=B, ms=time_ms(lambda: solver(*inputs), 20),
                  plain_ms=time_ms(run_plain, 1), bound_ms=b_ms,
                  bound_by=b_by, bound_detail=b_detail,
                  live_rows_per_env=float((klive != 0).sum()) / B)
    services = services_check(sub, st, seed)
    emit("islands", device=smi, worlds=BOX_BATCH, boxes=boxes,
         islands=im.num_islands, island_bodies=sub.num_bodies,
         kernel_envs=B, colliders_per_island=tab.num_colliders,
         pair_rows_per_island=tab.num_rows, contact_phases=tab.num_phases,
         iterations=ITERATIONS, dt=BOX_DT, islandize_s=islandize_s,
         plans=plans_by_batch(tab, (B, im.num_islands)), tolerance=KERNEL_TOL,
         tolerance_reason=TOL_REASON, checks=checks,
         full_vs_islands=exact, full_vs_islands_tol=dict(
             pos=ISLAND_POS_TOL, vel=ISLAND_VEL_TOL,
             reason=ISLAND_TOL_REASON),
         standing_tol=dict(top_box_drop_m=ISLAND_TOP_DROP,
                           xz_move_m=ISLAND_XZ_MOVE,
                           gated_steps=ISLAND_STAND_GATED,
                           reason=ISLAND_STAND_REASON),
         run=run, kernel=timing, services=services,
         seconds=time.perf_counter() - t_phase)
    if not (exact["err_pos"] <= ISLAND_POS_TOL
            and exact["err_vel"] <= ISLAND_VEL_TOL and exact["moved_by"] > 0):
        raise RuntimeError(f"islands: the full scene and its islands "
                           f"disagree: {exact}")
    want = {n: (ISLAND_STEPS if n == "fused_step" else 0) for n in counters}
    want["fused_step.base"] = ISLAND_STEPS
    if launches != want or not run["finite"] or not run["scatter_back_finite"]:
        raise RuntimeError(f"islands: launches {launches} (expected {want}), "
                           f"finite {run['finite']}")
    if not (run["gated_top_box_drop_max_m"] < ISLAND_TOP_DROP
            and run["gated_max_xz_move_m"] < ISLAND_XZ_MOVE):
        raise RuntimeError(f"islands: a tower fell within "
                           f"{ISLAND_STAND_GATED} steps: {run}")
    return {
        "name": "fused_step_islands", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": launches["fused_step"],
        "max_abs_err": max(c[k] for c in checks.values() for k in (
            "err_v", "err_w", "err_pos", "err_rot", "err_imp")),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **plan_fields(tab, B)}


# ---------------------------------------------------------------------------
# the reference step: "scan" (sequential impulses), the JAX package's entry()
# configuration on the card, the other reference modes, the step-1 gate
# against the fused kernel's sequential solve, and the fast goldens on "scan"

SCAN_ENVS = 4096
SCAN_ITERS = 10                           # __graft_entry__.entry()
SCAN_NARROW = 32                          # max_narrow_pairs of entry()
SCAN_WARM = 10                            # the ragdoll lands on its feet
SCAN_STEPS = 8
SCAN_CPU_ENVS = 8
SCAN_MODE_STEPS = 2                       # each of "jacobi" and "colored"
SCAN_POS_TOL = 1e-6
SCAN_VEL_TOL = 1e-5                       # of max(1, the largest velocity)
SCAN_CPU_REASON = (
    "the card and the CPU run the same eager float32 operations in the "
    "same order (the sequential pass has no atomics: it gathers and writes "
    "one row at a time, and its averaged passes are not in this step); "
    "they differ only where a library routine rounds differently (sin and "
    "cos of the cone-twists' swing-motor angle, a reduction's order), by "
    "an ulp that the solve carries")
SCAN_FMA_REASON = (
    "step 1 of \"scan\" (eager PyTorch, no fused multiply-add) against "
    "step 1 of \"fused_seq\" (the prepped kernel, which nvcc builds with "
    "--fmad=true, so a product and a sum round once): the same operations "
    "in the same order, bit-equal on the CPU where both are plain "
    "(tests/test_torch_scan_fused_seq.py), here within an ulp's growth")
SCAN_GOLDENS = (("sphere_bounce", 1000), ("double_pendulum", 1000),
                ("box_stack", 50))
SCAN_GOLDEN_GATED = {"box_stack": 25}
SCAN_GOLDEN_REASON = (
    "box_stack is chaotic between compiles of one program (ROADMAP.md "
    "standing note 2), and 1e-3 over 50 steps is not met here: on the CPU "
    "the JAX package's own \"scan\", compiled with the scene as an "
    "argument, is 1.06e-3 from this golden at step 50, two compiles of it "
    "differ by 9.1e-4 within 50 steps, and the port's \"scan\" is within "
    "5.3e-4 of it over the 50 steps (tests/test_torch_scan_step.py, "
    "tools/golden_divergence_cpu.py); gated over the first 25 steps, the "
    "50-step deviation printed")


def fused_seq_mixed_builder(builder):
    """The mixed scene of the JAX package's tests/test_fused_seq.py:19-31,
    copied: three stacked boxes on a ground box, a sphere, and a capsule
    on a ball joint to the ground. `builder` is a SceneBuilder class; the
    result is finalized by the caller with no arguments."""
    b = builder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    for i in range(3):
        bd = b.add_body(position=(0.02 * i, 0.5 + 1.001 * i, -0.01 * i))
        b.add_box_collider(bd, (0, 0, 0), (0.5, 0.5, 0.5))
    s = b.add_body(position=(2.0, 1.0, 0.0))
    b.add_sphere_collider(s, (0, 0, 0), 0.5)
    c = b.add_body(position=(-2.0, 1.0, 0.0))
    b.add_capsule_collider(c, (0, -0.3, 0), (0, 0.3, 0), 0.2)
    b.add_ball_constraint(g, c, (-2.0, 2.0, 0.0))
    return b


def _field_diffs(a, b):
    return {k: float((getattr(a, k).cpu() - getattr(b, k).cpu()).abs().max())
            for k in ("pos", "rot", "lin_vel", "ang_vel")}


def _hold_state(diffs, want, what, reason):
    """Positions and rotations within SCAN_POS_TOL, velocities within
    SCAN_VEL_TOL of max(1, their largest) in `want`; raises otherwise."""
    for k, d in diffs.items():
        tol = SCAN_POS_TOL if k in ("pos", "rot") else SCAN_VEL_TOL * max(
            1.0, float(getattr(want, k).abs().max()))
        if not d <= tol:
            raise RuntimeError(f"{what}: {k} differs by {d} (tolerance "
                               f"{tol}; {reason})")


def scan_phase(seed):
    """The reference step on the card: (a) the JAX package's entry()
    configuration, LocoEnv(solver_mode="scan", solver_iterations=10,
    max_narrow_pairs=32) at 4096 envs, zero actions, pokes on: env-steps/s,
    synchronised ms an env step, the overlap-matrix kernel's launches (one
    an env step: both large pair tables are dense), live rows per bucket,
    dropped pairs, the kernel against its plain version on these AABBs,
    and 8 envs' pre-step state stepped by the same code on the CPU;
    (b) two steps each of "jacobi" and "colored" and the joints' anchor
    gaps; (c) step 1 of "scan" against the prepped kernel's "fused_seq"
    on the mixed scene of the JAX package's fused_seq test; (d) the fast
    goldens on "scan" at one env. Returns the overlap-matrix launches of
    (a) and the phase's kernel times at its shapes."""
    from dxk_tpu_torch.envs.loco_env import ACTION_EMA_BETA
    from dxk_tpu_torch.envs.loco_env import DT as LOCO_DT
    from dxk_tpu_torch.envs.loco_env import LocoEnv
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.kernels import fused_step as fs
    from dxk_tpu_torch.ops.kernels import kselect_broadphase as ks
    from dxk_tpu_torch.ops.kernels import sap_broadphase as sp
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.scene import SceneBuilder
    from dxk_tpu_torch.scene.scene import SHAPE_TYPE_NAMES

    t_phase = time.perf_counter()
    counters = {"aabb_overlap_matrix": bk, "kselect_broadphase": ks,
                "sap_broadphase": sp, "fused_step": fs}
    kw = dict(solver_mode="scan", solver_iterations=SCAN_ITERS,
              max_narrow_pairs=SCAN_NARROW)
    env = LocoEnv(device=DEVICE, **kw)
    cpu_env = LocoEnv(device="cpu", **kw)
    scene = env.scene
    groups = [dict(bucket=f"{SHAPE_TYPE_NAMES[g.type_a]}-"
                          f"{SHAPE_TYPE_NAMES[g.type_b]}",
                   pairs=int(g.pairs.shape[0]), slots=g.max_narrow,
                   phase=g.phase) for g in scene.pair_groups]

    # ---- (a) the entry configuration: warm steps, then the timed steps
    # with the launch counts from zero
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    act = torch.zeros((SCAN_ENVS, 27), device=env.device)
    st, _obs = env.reset(SCAN_ENVS)
    for _ in range(SCAN_WARM):
        st, _obs, _r, _d = env.step(st, act, gen)
    pre = None
    for mod in counters.values():
        mod.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SCAN_STEPS):
        if i == SCAN_STEPS - 1:
            pre = st                      # the last step's input, kept
        st, obs, _r, done = env.step(st, act, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: mod.launch_count() for n, mod in counters.items()}
    finite = bool(torch.isfinite(st.physics.pos).all()
                  & torch.isfinite(st.physics.lin_vel).all()
                  & torch.isfinite(st.physics.ang_vel).all()
                  & torch.isfinite(obs).all())
    if not finite:
        raise RuntimeError("scan: a state is not finite after the entry "
                           "configuration's steps")
    want = {n: (SCAN_STEPS if n == "aabb_overlap_matrix" else 0)
            for n in counters}
    if launches != want:
        raise RuntimeError(f"scan: kernel launches {launches} in "
                           f"{SCAN_STEPS} env steps, expected {want}")

    # one more env step under torch.profiler: device busy time and device
    # launches an env step (after the counts were read)
    holder = [st]

    def one_step():
        holder[0] = env.step(holder[0], act, gen)[0]
    prof = profile_steps(one_step, 1)
    prof.pop("fused_kernel_ms_per_step")
    # against the unprofiled synchronised ms an env step of the timed run
    prof["device_idle_share"] = 1.0 - (prof["device_busy_ms_per_step"]
                                       / (secs / SCAN_STEPS * 1e3))

    # what the step saw: live rows per bucket and dropped pairs, from one
    # more step of the final state
    settings = env.settings
    _next, info = physics_step(scene, st.physics, settings, LOCO_DT)
    live, off = {}, 0
    for g, meta in zip(scene.pair_groups, groups):
        n = g.max_narrow
        live[meta["bucket"]] = int(info.contact_mask[:, off:off + n].sum())
        off += n
    dropped = int(info.broadphase_overflow.sum())

    # the overlap-matrix kernel against its plain version on these AABBs
    matrix = overlap_matrix_check(scene, st.physics, "scan")
    matrix_err = matrix.pop("max_abs_err")

    # 8 envs' state before the last timed step, with the controls that
    # step set (and no poke), stepped by the same code on the card and on
    # the CPU
    phys = pre.physics
    ctl = env._controls_from_action(
        pre.smoothed_action + (act - pre.smoothed_action) * ACTION_EMA_BETA)
    sub = lambda x: x[:SCAN_CPU_ENVS]        # noqa: E731
    card_in = _sub_state(phys.replace(controls=ctl), sub)
    card_out = physics_step(scene, card_in, settings, LOCO_DT)[0]
    cpu_out = physics_step(cpu_env.scene, card_in.to("cpu"), settings,
                           LOCO_DT)[0]
    cpu_diff = _field_diffs(card_out, cpu_out)
    _hold_state(cpu_diff, cpu_out, "scan: card vs CPU", SCAN_CPU_REASON)

    # ---- (b) the other reference modes on the same env and state
    modes = {}
    for mode in ("jacobi", "colored"):
        ps = st.physics
        ms = PhysicsSettings(num_rigid_solver_iterations=SCAN_ITERS,
                             solver_mode=mode)
        for _ in range(SCAN_MODE_STEPS):
            ps = physics_step(scene, ps, ms, LOCO_DT)[0]
        ok = bool(torch.isfinite(ps.pos).all() & torch.isfinite(
            ps.ang_vel).all())
        modes[mode] = dict(steps=SCAN_MODE_STEPS, finite=ok,
                           anchor_gap_m={n: anchor_gap(scene, ps, n)
                                         for n in ("hinge", "cone_twist")})
        if not ok:
            raise RuntimeError(f"scan: {mode} state not finite")
    modes["scan"] = dict(anchor_gap_m={n: anchor_gap(scene, st.physics, n)
                                       for n in ("hinge", "cone_twist")})

    # ---- (c) step 1 of "scan" against the fused_seq kernel
    mixed = fused_seq_mixed_builder(SceneBuilder).finalize(device=DEVICE)
    s0 = mixed.initial_state(1)
    fs.reset_launch_count()
    a = physics_step(mixed, s0, PhysicsSettings(solver_mode="scan"),
                     FIDELITY_DT)[0]
    b = physics_step(mixed, s0, PhysicsSettings(solver_mode="fused_seq"),
                     FIDELITY_DT)[0]
    gate_launches = fs.launch_count()
    gate = _field_diffs(a, b)
    if gate_launches != 1:
        raise RuntimeError(f"scan: fused_seq launched the kernel "
                           f"{gate_launches} times in one step")
    _hold_state(gate, b, "scan vs fused_seq, step 1", SCAN_FMA_REASON)

    # ---- (d) the fast goldens on "scan", one env each: the longest in a
    # child process of its own (scan_golden_child), beside the others here
    # (each is launch bound on the host; the child is stopped on any error)
    child = scan_golden_child(SCAN_GOLDEN_CHILD)
    try:
        goldens = {name: scan_golden(name, steps)
                   for name, steps in SCAN_GOLDENS
                   if name != SCAN_GOLDEN_CHILD}
        out, _err = child.communicate(timeout=SCAN_GOLDEN_CHILD_TIMEOUT)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"scan: the {SCAN_GOLDEN_CHILD} golden's process "
                           f"exited with {child.returncode}: {out[-2000:]}")
    goldens[SCAN_GOLDEN_CHILD] = json.loads(out.strip().splitlines()[-1])
    goldens[SCAN_GOLDEN_CHILD]["own_process"] = True
    for name, g in goldens.items():
        if not g["max_dev_gated"] <= FIDELITY_TOL:
            raise RuntimeError(f"scan: {name} leaves its golden by "
                               f"{g['max_dev_gated']}")

    emit("scan", envs=SCAN_ENVS, iterations=SCAN_ITERS,
         max_narrow_pairs=SCAN_NARROW, pokes=True, groups=groups,
         steps=SCAN_STEPS, seconds=secs,
         env_steps_per_s=SCAN_ENVS * SCAN_STEPS / secs,
         ms_per_env_step=secs / SCAN_STEPS * 1e3, launches=launches,
         overlap_matrix_launches_per_env_step=(
             launches["aabb_overlap_matrix"] / SCAN_STEPS),
         profiled_step=prof, live_rows_by_bucket=live,
         dropped_pairs=dropped, finite=finite,
         done_envs=int(done.sum()), overlap_matrix_max_abs_err=matrix_err,
         overlap_matrix=matrix, cpu_envs=SCAN_CPU_ENVS,
         card_vs_cpu=cpu_diff, card_vs_cpu_reason=SCAN_CPU_REASON,
         modes=modes, fused_seq_gate=gate, fused_seq_gate_reason=(
             SCAN_FMA_REASON),
         goldens=goldens, golden_tolerance=FIDELITY_TOL,
         golden_reason=SCAN_GOLDEN_REASON,
         phase_seconds=time.perf_counter() - t_phase)
    return launches["aabb_overlap_matrix"], matrix


SCAN_GOLDEN_CHILD = "double_pendulum"   # the longest: ~164 s of 242
SCAN_GOLDEN_CHILD_TIMEOUT = 600


def scan_golden(name, steps):
    """One golden scene at one env on "scan" for `steps` steps from its
    start: its deviation from tests/golden/ at every FIDELITY_EVERY-th step
    (the largest, and the largest over the gated steps) and the seconds.
    The steps run in inference mode, as the demo's frames do: the same
    operations, each with less host work."""
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    gscene = shapes_scene(name, DEVICE)
    gold = np.load(golden_path(name))
    gs = gscene.initial_state(1)
    ss = PhysicsSettings(solver_mode="scan")
    rows = []
    t1 = time.perf_counter()
    with torch.inference_mode():
        for i in range(steps):
            gs = physics_step(gscene, gs, ss, FIDELITY_DT)[0]
            if i % FIDELITY_EVERY == FIDELITY_EVERY - 1:
                rows.append(torch.cat([gs.pos[0].flatten(),
                                       gs.rot[0].flatten()]))
    torch.cuda.synchronize()
    g_secs = time.perf_counter() - t1
    dev = np.abs(torch.stack(rows).cpu().numpy()
                 - gold[:len(rows)]).max(axis=1)
    gated = SCAN_GOLDEN_GATED.get(name, steps) // FIDELITY_EVERY
    return dict(steps=steps, seconds=g_secs, max_dev=float(dev.max()),
                max_dev_gated=float(dev[:gated].max()),
                gated_steps=gated * FIDELITY_EVERY)


def scan_golden_child(name):
    """A child process of this script that runs scan_golden(name) on the
    card and prints its result as its last line (main's --scan-golden)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scan-golden", name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def _sub_state(state, sub):
    """The State with `sub` applied to every tensor (controls too)."""
    import dataclasses
    fields = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if isinstance(x, torch.Tensor):
            fields[f.name] = sub(x)
        elif x is not None and dataclasses.is_dataclass(x):
            fields[f.name] = _sub_state(x, sub)
        else:
            fields[f.name] = x
    return state.replace(**fields)


DEMO_ENVS = 1024
DEMO_BATCH_FROM = 3                       # the twin's frames before the batch
DEMO_BATCH_FRAMES = 2
NOISE_HASH_POINTS = 4096
NOISE_HEIGHT_TOL = 4e-6                   # m, tests/test_torch_noise.py's
NOISE_REASON = (
    "the hash is integer arithmetic, held bit for bit; the heights pass "
    "through cos / sin, which the card and the CPU may round an ulp apart, "
    "summed over four octaves and scaled by 4 to ~6 m: held within 4e-6 m, "
    "the tolerance the tests hold the port's CPU heights to against JAX's")
DEMO_STATE_TOL = 1e-4                     # of max(1, the largest |value|)
DEMO_POOL_TOL = 1e-4
DEMO_DEPTH_TOL = 1e-4                     # of max(1, depth)
DEMO_RGB_TOL = 1e-3
DEMO_EXCUSED_PIXELS = 8                   # of a 160 x 120 frame's pixels
DEMO_CPU_REASON = (
    "the first frame (60 \"scan\" steps and the pools' tick) on the card "
    "against the same code on the CPU from the same state and uniforms: "
    "the same float32 operations, but the card's reductions (the solver's "
    "per-body sums) may add in another order, so states and pools are held "
    "within 1e-4 of scale after 60 steps")
DEMO_RENDER_REASON = (
    "a render of one state on the card against the CPU: the same float32 "
    "operations, but the card's 3-term sums may round an ulp apart, and "
    "t = -b - sqrt(b^2 - c) divides that ulp (of b^2 ~ 600 m^2 at the "
    "demo's 25 m) by sqrt(b^2 - c), which is at most the radius: ~2.5e-5 "
    "of the depth on the chain's 0.08 m capsules, more where a ray grazes "
    "any surface; such an ulp can also flip a grazing ray's hit or tip a "
    "box's face, picked by the largest |local coordinate| at an edge. "
    "Depths are held within 1e-4 relative and colours within 1e-3, and 8 "
    "pixels of each 160 x 120 frame may flip or differ past those: "
    "against 1e-5 relative, the first card run had 10 pixels past, the "
    "largest 1.7e-4 in depth and 0.015 in colour")
# sphere heights after the six frames: python examples/demo_scene.py (the
# JAX package on the CPU) prints [1.0, 1.42, 1.76]; the port's plain path
# on the CPU [1.0, 1.41, 1.76] (python -m dxk_tpu_torch.examples.demo_scene
# --device cpu). Sphere 0 rests on the ground box (top at y = 0, radius 1),
# the others on it or beside it: centres within 1.0 +- 0.02 for sphere 0
# and within [0.95, 3.05] (on the ground, or on a sphere) for all
DEMO_SPHERE0_Y = (0.98, 1.02)
DEMO_SPHERE_Y = (0.95, 3.05)
DEMO_SOUND_REASON = (
    "events are diffed once a frame, the frame's last step against the "
    "last frame's (as the JAX example does), and in the six frames only "
    "resting contacts begin there, below the audible speed, in the JAX "
    "example too (it prints no sound line); the sound path is gated on a "
    "crafted impact instead: sphere 1 dropped onto sphere 0 at 4 m/s from "
    "3 cm above, whose begin event on the frame's last step is audible "
    "(tests/test_torch_demo_scene.py's drop), card against CPU")
RASTER_ENVS = 256
RASTER_CPU_ENVS = 4
RASTER_SCENES = {"settle": ((4.0, 2.5, 5.0), (0.0, 1.0, 0.0)),
                 "mixed_shape_drop": ((5.0, 4.0, 6.0), (0.0, 2.0, 0.0)),
                 "sphere_bounce": ((3.0, 2.0, 4.0), (0.0, 1.0, 0.0))}


def _demo_draws(batch, gen, device):
    """Each pool's uniforms for one tick, drawn from `gen` on `device`."""
    return {k: torch.rand((batch, 256, 6), generator=gen, device=device)
            for k in ("fire", "smoke", "debris")}


def _finite(*xs):
    return all(bool(torch.isfinite(x).all()) for x in xs)


def _frame_finite(fr):
    s = fr.state
    ok = _finite(s.pos, s.rot, s.lin_vel, s.ang_vel)
    for _p, ps in fr.pools.values():
        ok = ok and _finite(ps.pos, ps.vel, ps.life)
    if fr.rgb is not None:
        ok = ok and _finite(fr.rgb, fr.depth)
    return ok


def _pool_errs(a, b):
    """Per pool: alive counts equal, emit_accum and fields' largest error
    relative to max(1, their largest)."""
    from dxk_tpu_torch.ops.particles import alive_count
    out = {}
    for k in a:
        pa, pb = a[k][1], b[k][1]
        errs = {f: _rel_err(getattr(pa, f), getattr(pb, f))
                for f in ("pos", "vel", "life", "max_life", "rot",
                          "emit_accum")}
        out[k] = dict(alive_equal=bool(torch.equal(
            alive_count(pa).cpu(), alive_count(pb).cpu())),
            worst=max(e / s for e, s in errs.values()))
    return out


def _render_errs(rgb, depth, rgb_ref, depth_ref):
    """Pixels whose hit flips; over the pixels both hit, those whose depth
    differs past DEMO_DEPTH_TOL relative or whose colour differs past
    DEMO_RGB_TOL, and the largest errors."""
    hit, hit_ref = depth.cpu() > 0, depth_ref.cpu() > 0
    both = hit & hit_ref
    dd = (depth.cpu() - depth_ref.cpu()).abs()[both]
    rel = dd / torch.clamp(depth_ref.cpu()[both], min=1.0)
    dc = (rgb.cpu() - rgb_ref.cpu()).abs().amax(-1)[both]
    past = (rel > DEMO_DEPTH_TOL) | (dc > DEMO_RGB_TOL)
    return dict(pixels=int(hit.numel()), flips=int((hit != hit_ref).sum()),
                pixels_past_tol=int(past.sum()),
                depth_rel_err=float(rel.max()) if rel.numel() else 0.0,
                rgb_err=float(dc.max()) if dc.numel() else 0.0)


def _hold_render(errs, what):
    allowed = DEMO_EXCUSED_PIXELS * errs["pixels"] // (160 * 120)
    if errs["flips"] + errs["pixels_past_tol"] > allowed:
        raise RuntimeError(f"{what}: render differs {errs} "
                           f"({DEMO_RENDER_REASON})")


def demo_impact_check(device, heights):
    """tests/test_torch_demo_scene.py's drop on the card and on the CPU (both
    on the terrain `heights`): one frame of two steps in which sphere 1
    lands on sphere 0. Returns the begin events and sound triggers of
    each."""
    from dxk_tpu_torch.examples import demo_scene as demo
    from dxk_tpu_torch.ops.cloth import collider_groups
    out = {}
    for dev in (device, "cpu"):
        b, spheres = demo.build_demo_scene(heights=heights)
        scene = demo.finalize_demo(b, dev)
        st = scene.initial_state(1)
        st.pos[0, spheres[0], 1] = 8.0
        st.pos[0, spheres[1], 1] = 10.03
        st.lin_vel[0, spheres[1], 1] = -4.0
        groups = collider_groups(scene.colliders.ctype.cpu().numpy(),
                                 scene.hulls is not None, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        fr = demo.run_frame(scene, st, demo.init_pools(1, dev), None,
                            groups=groups, steps=2, generator=gen,
                            rng=np.random.default_rng(demo.SOUND_SEED),
                            render_frame=False)
        out[dev] = dict(begins=[(e.collider_a, e.collider_b, e.impulse)
                                for e in fr.events[0][0]],
                        sounds=fr.sounds[0])
    card, cpu = out[device], out["cpu"]
    if not card["sounds"]:          # triggers are audible (volume > 0)
        raise RuntimeError(f"demo: the crafted impact made no sound "
                           f"trigger on the card: {card}")
    same = ([b[:2] for b in card["begins"]] == [b[:2] for b in cpu["begins"]]
            and len(card["sounds"]) == len(cpu["sounds"])
            and all(abs(a["volume"] - b["volume"]) <= 1e-5
                    and a["pitch"] == b["pitch"]
                    for a, b in zip(card["sounds"], cpu["sounds"])))
    if not same:
        raise RuntimeError(f"demo: the impact's events on the card {card} "
                           f"differ from the CPU's {cpu}")
    return dict(card=card, cpu=cpu, equal_to_cpu=same)


def noise_check(device):
    """utils/noise.py on the card against the CPU: the lattice hash on
    NOISE_HASH_POINTS seeded coordinates whose products pass int32, and the
    int32 extremes, bit for bit; the demo's terrain within
    NOISE_HEIGHT_TOL. Returns the result and the card's heights."""
    from dxk_tpu_torch.examples import demo_scene as demo
    from dxk_tpu_torch.utils import noise
    rng = np.random.default_rng(3)
    ix = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, NOISE_HASH_POINTS))
    iy = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, NOISE_HASH_POINTS))
    ix[:4] = torch.tensor([2 ** 31 - 1, -2 ** 31, 0, -1])
    iy[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0])
    hash_equal = all(torch.equal(
        noise._hash2(ix.to(device), iy.to(device), seed).cpu(),
        noise._hash2(ix, iy, seed)) for seed in (0, 3, 2 ** 31 - 1))
    t0 = time.perf_counter()
    heights = noise.terrain_heightfield(**demo.TERRAIN, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float((heights.cpu() - noise.terrain_heightfield(
        **demo.TERRAIN, device="cpu")).abs().max())
    out = dict(hash_points=NOISE_HASH_POINTS, hash_equal=hash_equal,
               terrain_shape=list(heights.shape), terrain_ms=ms,
               height_err_m=err, height_tol_m=NOISE_HEIGHT_TOL,
               reason=NOISE_REASON)
    if not (hash_equal and err <= NOISE_HEIGHT_TOL):
        raise RuntimeError(f"demo: the noise on the card differs from the "
                           f"CPU: {out}")
    return out, heights.cpu().numpy()


def demo_twin(device, heights):
    """The twin as `python -m dxk_tpu_torch.examples.demo_scene` runs it: one
    env, six frames of 60 steps and 160 x 120 frames, the terrain's noise
    computed on the card (`heights` is what noise_check got there; the CPU
    rerun of the first frame takes them, to keep the noise's rounding out
    of the step's). The pools' uniforms are drawn from a seeded generator
    on the card up front, so that the first frame can be redone on the CPU.
    Returns its per-frame fields and gates, and the state, step info and
    pools after DEMO_BATCH_FROM frames (demo_batch starts there)."""
    from dxk_tpu_torch.examples import demo_scene as demo
    from dxk_tpu_torch.ops.cloth import collider_groups
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.particles import alive_count
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.render.raster import render

    b, spheres = demo.build_demo_scene(device=device)
    scene = demo.finalize_demo(b, device)
    if not np.array_equal(scene.heightfield.heights.cpu().numpy(), heights):
        raise RuntimeError("demo: the twin's terrain is not noise_check's")
    groups = collider_groups(scene.colliders.ctype.cpu().numpy(),
                             scene.hulls is not None, device)
    st = scene.initial_state(1)
    pools = demo.init_pools(1, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rng = np.random.default_rng(demo.SOUND_SEED)
    prev, frames, first, start = None, [], None, None
    begins_total, sounds_total = 0, 0
    bk.reset_launch_count()
    t0 = time.perf_counter()
    for i in range(demo.FRAMES):
        draws = _demo_draws(1, gen, device)
        fr = demo.run_frame(scene, st, pools, prev, groups=groups, rng=rng,
                            draws=draws)
        if i == 0:
            first = (st, pools, draws, fr)
        st, pools, prev = fr.state, fr.pools, fr.info
        if i + 1 == DEMO_BATCH_FROM:
            start = (st, prev, pools)
        if not _frame_finite(fr):
            raise RuntimeError(f"demo: frame {i} is not finite")
        hit_share = float((fr.depth[0] > 0).float().mean())
        if not 0.0 < hit_share < 1.0:
            raise RuntimeError(f"demo: frame {i} hit share {hit_share}")
        begins = fr.events[0][0]
        begins_total += len(begins)
        sounds_total += len(fr.sounds[0])
        trig = (fr.info.trigger_overlap[0].cpu().tolist()
                if fr.info.trigger_overlap is not None else None)
        frames.append(dict(
            t=demo.PARTICLE_DT * (i + 1), seconds=fr.seconds, trigger=trig,
            contacts=int(fr.info.num_contacts[0]),
            alive={k: int(alive_count(p[1])[0]) for k, p in pools.items()},
            begins=[(e.collider_a, e.collider_b, e.body_a, e.body_b,
                     e.impulse) for e in begins],
            sounds=len(fr.sounds[0]), hit_share=hit_share))
        print(json.dumps(frames[-1]), file=sys.stderr, flush=True)
    total = time.perf_counter() - t0
    matrix_launches = bk.launch_count()
    ys = [float(st.pos[0, s, 1]) for s in spheres]
    lo0, hi0 = DEMO_SPHERE0_Y
    lo, hi = DEMO_SPHERE_Y
    if not (lo0 <= ys[0] <= hi0 and all(lo <= y <= hi for y in ys)):
        raise RuntimeError(f"demo: sphere heights {ys} outside the bounds "
                           f"{DEMO_SPHERE0_Y}, {DEMO_SPHERE_Y}")
    if begins_total == 0:
        raise RuntimeError("demo: no collision begin event in six frames")
    if max(f["alive"]["debris"] for f in frames) == 0:
        raise RuntimeError("demo: no debris alive after the burst")

    # ms a step from the frames' own steps; device busy time and launches
    # of one more step under torch.profiler
    step_s = sum(f["seconds"]["steps"] for f in frames)
    ms_step = step_s / (demo.FRAMES * demo.STEPS_PER_FRAME) * 1e3
    settings = PhysicsSettings()
    holder = [st]

    def one_step():
        holder[0] = physics_step(scene, holder[0], settings, demo.DT)[0]
    prof = profile_steps(one_step, 1, host_ops=False)
    prof.pop("fused_kernel_ms_per_step")
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / ms_step
    matrix = overlap_matrix_check(scene, st, "demo twin")

    # the first frame again on the CPU from the same state and uniforms
    s0, p0, draws, fr0 = first
    cb, _ = demo.build_demo_scene(heights=heights)
    cscene = demo.finalize_demo(cb, "cpu")
    cgroups = collider_groups(cscene.colliders.ctype.numpy(),
                              cscene.hulls is not None, "cpu")
    cpools = {k: (p.to("cpu"), ps.to("cpu")) for k, (p, ps) in p0.items()}
    cfr = demo.run_frame(cscene, s0.to("cpu"), cpools, None, groups=cgroups,
                         rng=np.random.default_rng(demo.SOUND_SEED),
                         draws={k: v.cpu() for k, v in draws.items()})
    state_errs = {k: _rel_err(getattr(fr0.state, k), getattr(cfr.state, k))
                  for k in ("pos", "rot", "lin_vel", "ang_vel")}
    pool_errs = _pool_errs(fr0.pools, cfr.pools)
    # the render of the card's own state on the CPU: the ray-caster alone
    crgb, cdepth = render(cscene, fr0.state.to("cpu"), eye=demo.EYE,
                          target=demo.TARGET, width=demo.WIDTH,
                          height=demo.HEIGHT)
    render_errs = _render_errs(fr0.rgb, fr0.depth, crgb, cdepth)
    for k, (e, s) in state_errs.items():
        if not e <= DEMO_STATE_TOL * s:
            raise RuntimeError(f"demo: frame 0's {k} differs from the CPU by "
                               f"{e} (scale {s}; {DEMO_CPU_REASON})")
    for k, e in pool_errs.items():
        if not (e["alive_equal"] and e["worst"] <= DEMO_POOL_TOL):
            raise RuntimeError(f"demo: frame 0's {k} pool differs from the "
                               f"CPU: {e} ({DEMO_CPU_REASON})")
    _hold_render(render_errs, "demo: frame 0")
    return dict(frames=frames, seconds=total,
                overlap_matrix_launches=matrix_launches,
                overlap_matrix=matrix, ms_per_step=ms_step,
                profiled_step=prof, sphere_heights=ys, sphere_bounds=dict(
                    sphere0=DEMO_SPHERE0_Y, all=DEMO_SPHERE_Y),
                begins=begins_total, sounds=sounds_total,
                sound_reason=DEMO_SOUND_REASON,
                card_vs_cpu=dict(state=state_errs, pools=pool_errs,
                                 render=render_errs,
                                 reason=DEMO_CPU_REASON)), start


def _tile_env(x, batch):
    """A State, StepInfo or ParticleState of one env as `batch` copies of
    it (an unbatched (P, 2) contact_pairs stays as it is)."""
    pairs = getattr(x, "contact_pairs", None)
    return x.map_tensors(
        lambda t: t if (t is pairs and t.dim() == 2)
        else t.expand(batch, *t.shape[1:]).contiguous())


def demo_batch(device, seed, start):
    """The demo at DEMO_ENVS envs through demo_scene.run_frame, from the
    twin's state, step info and pools after DEMO_BATCH_FROM frames (the
    frame after it is the first with begin events, whose bursts the next
    frame's debris tick emits): env 0 goes on undisturbed, the others'
    dynamic bodies get config4_noise's 0.01 m/s there. A warm frame of one
    step from the same start (its own generators), then DEMO_BATCH_FRAMES
    frames of 60 steps, three pools of (DEMO_ENVS, 256) a frame, events
    and sound triggers in every env, and a 160 x 120 render of every env;
    each part timed (Frame.seconds); launches and device time of one more
    step under torch.profiler; peak memory of the frames."""
    from dxk_tpu_torch.examples import demo_scene as demo
    from dxk_tpu_torch.ops.cloth import collider_groups
    from dxk_tpu_torch.ops.kernels import broadphase_kernel as bk
    from dxk_tpu_torch.ops.particles import alive_count
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step

    B = DEMO_ENVS
    s1, info1, pools1 = start
    scene = demo.finalize_demo(demo.build_demo_scene(device=device)[0],
                               device)
    groups = collider_groups(scene.colliders.ctype.cpu().numpy(),
                             scene.hulls is not None, device)
    st = _tile_env(s1, B)
    dyn = (scene.body_params.inv_mass > 0.0).to(torch.float32)[None, :, None]
    noise = torch.from_numpy(config4_noise(B, st.lin_vel.shape[1], seed)).to(
        device)
    st = st.replace(lin_vel=st.lin_vel + noise * dyn)
    prev = _tile_env(info1, B)
    pools = {k: (p, _tile_env(pools1[k][1], B))
             for k, (p, _ps) in demo.init_pools(B, device).items()}
    warm_gen = torch.Generator(device=device)
    warm_gen.manual_seed(seed + 1)
    demo.run_frame(scene, st, pools, prev, groups=groups, steps=1,
                   generator=warm_gen, rng=np.random.default_rng(seed + 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(demo.SOUND_SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_count()
    frames = []
    for i in range(DEMO_BATCH_FRAMES):
        fr = demo.run_frame(scene, st, pools, prev, groups=groups, rng=rng,
                            generator=gen)
        st, pools, prev = fr.state, fr.pools, fr.info
        if not _frame_finite(fr):
            raise RuntimeError(f"demo: the batch's frame {i} is not finite")
        hit_share = float((fr.depth > 0).float().mean())
        if not 0.0 < hit_share < 1.0:
            raise RuntimeError(f"demo: the batch's frame {i} hit share "
                               f"{hit_share}")
        sec = fr.seconds
        frames.append(dict(
            seconds=sec,
            ms_per_step=sec["steps"] / demo.STEPS_PER_FRAME * 1e3,
            env_steps_per_s=B * demo.STEPS_PER_FRAME / sec["steps"],
            particle_steps_per_s=3 * B * demo.CAPACITY / sec["particles"],
            events_and_sounds_ms=sec["events"] * 1e3,
            render_ms=sec["render"] * 1e3,
            rays_per_s=B * demo.WIDTH * demo.HEIGHT / sec["render"],
            envs_with_begins=sum(1 for bg, _ in fr.events if bg),
            begins=sum(len(bg) for bg, _ in fr.events),
            sounds=sum(len(x) for x in fr.sounds),
            alive={k: int(alive_count(q[1]).sum()) for k, q in pools.items()},
            hit_share=hit_share))
    matrix_launches = bk.launch_count()
    peak = torch.cuda.max_memory_allocated()
    if frames[0]["envs_with_begins"] == 0:
        raise RuntimeError("demo: no begin event in the batch's first frame")
    if frames[-1]["alive"]["debris"] == 0:
        raise RuntimeError("demo: no debris alive in the batch")

    settings = PhysicsSettings()
    holder = [st]

    def one_step():
        holder[0] = physics_step(scene, holder[0], settings, demo.DT)[0]
    prof = profile_steps(one_step, 1, host_ops=False)
    prof.pop("fused_kernel_ms_per_step")
    step_s = sum(f["seconds"]["steps"] for f in frames)
    ms_step = step_s / (DEMO_BATCH_FRAMES * demo.STEPS_PER_FRAME) * 1e3
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / ms_step
    matrix = overlap_matrix_check(scene, st, "demo batch")
    return dict(envs=B, start_frame=DEMO_BATCH_FROM,
                frames=frames, ms_per_step=ms_step,
                profiled_step=prof, overlap_matrix_launches=matrix_launches,
                overlap_matrix=matrix, peak_memory_bytes=peak)


def raster_check(device, seed):
    """The ray-caster at RASTER_ENVS envs on the settle scene (hulls), the
    golden mixed drop (cylinders) and the sphere bounce (spheres): times,
    the collider types hit, and RASTER_CPU_ENVS envs on the card against
    the CPU."""
    from dxk_tpu_torch.render import raster
    out = {}
    for name, (eye, target) in RASTER_SCENES.items():
        if name == "settle":
            scene, cscene = settle_scene(device), settle_scene("cpu")
            st = settle_initial_state(scene, RASTER_ENVS, seed)
        else:
            scene, cscene = shapes_scene(name, device), shapes_scene(name,
                                                                     "cpu")
            st = shapes_initial_state(scene, RASTER_ENVS, seed)
        kw = dict(eye=eye, target=target, width=160, height=120)
        raster.render(scene, st, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, depth = raster.render(scene, st, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        w = raster.world_colliders(scene, st.pos[:8], st.rot[:8])
        o, dirs = raster.camera_rays(eye, target, width=160, height=120,
                                     device=device)
        t, ci = raster._hit_all_colliders(scene, w, o, dirs.reshape(-1, 3))
        types = sorted(set(scene.colliders.ctype[ci[t < 1e9]].tolist()))
        want = sorted(set(scene.colliders.ctype.tolist()))
        if types != want:
            raise RuntimeError(f"raster {name}: collider types hit {types}, "
                               f"the scene has {want}")
        sub = _sub_state(st, lambda x: x[:RASTER_CPU_ENVS]).to("cpu")
        crgb, cdepth = raster.render(cscene, sub, **kw)
        errs = _render_errs(rgb[:RASTER_CPU_ENVS], depth[:RASTER_CPU_ENVS],
                            crgb, cdepth)
        _hold_render(errs, f"raster {name}")
        if not _finite(rgb, depth):
            raise RuntimeError(f"raster {name}: not finite")
        out[name] = dict(envs=RASTER_ENVS, render_ms=secs * 1e3,
                         rays_per_s=RASTER_ENVS * 160 * 120 / secs,
                         types_hit=types,
                         hit_share=float((depth > 0).float().mean()),
                         card_vs_cpu=errs)
    return out


def demo_phase(seed):
    """The demo scene on the card: the noise against the CPU, the twin at
    one env as the example runs it, the crafted impact's sound, the batch
    from the twin's state and the ray-caster on the hull, cylinder and
    sphere scenes, one after another. Returns the overlap-matrix kernel's
    launches in the twin's 360 steps and in the batch's frames, and its
    checks at their shapes."""
    t_phase = time.perf_counter()
    secs, parts = {}, {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out
    parts["noise"], heights = part("noise", lambda: noise_check(DEVICE))
    parts["twin"], start = part("twin", lambda: demo_twin(DEVICE, heights))
    parts["impact"] = part("impact",
                           lambda: demo_impact_check(DEVICE, heights))
    parts["batch"] = part("batch", lambda: demo_batch(DEVICE, seed, start))
    parts["raster"] = part("raster", lambda: raster_check(DEVICE, seed))
    emit("demo", **parts, seconds=secs,
         phase_seconds=time.perf_counter() - t_phase)
    return {k: (parts[k]["overlap_matrix_launches"],
                parts[k]["overlap_matrix"]) for k in ("twin", "batch")}


CONTENT_PAIRS = 65536
CONTENT_CPU_PAIRS = 256
CONTENT_TOL = 1e-4                        # of max(1, the largest |value|)
CONTENT_REASON = (
    "GJK and EPA write their 3-term sums out (ops/gjk.py), so the card runs "
    "the CPU's float32 operations in the CPU's order and 0.0 is expected; "
    "EPA on curved shapes is chaotic in an ulp (an input moved by one ulp on "
    "the CPU turns a quarter of the sphere-sphere pairs' normals, by up to "
    "1.7), so hit flags must agree on all but 1 % of the CPU slice and "
    "points, normals and depths be within 1e-4 of scale on all but 1 % of "
    "the pairs both call hits")
CONTENT_SHAPES = ("sphere", "capsule", "cylinder", "box", "hull")
CONTENT_PAIRINGS = tuple((a, b) for i, a in enumerate(CONTENT_SHAPES)
                         for b in CONTENT_SHAPES[i:])
ANIM_INSTANCES = 4096
ANIM_JOINTS = 24
ANIM_VERTS = 1024
ANIM_WEIGHTS = 4
ANIM_CPU_INSTANCES = 8
ANIM_TOL = 1e-5                           # of max(1, the largest |value|)


def _content_shape(kind, rng, n, centre, device):
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731,E501
    if kind == "sphere":
        return (f(centre), f(rng.uniform(0.2, 1.0, n)))
    if kind in ("capsule", "cylinder"):
        axis = rng.normal(size=(n, 3)) * 0.5
        return (f(centre - axis), f(centre + axis),
                f(rng.uniform(0.1, 0.5, n)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if kind == "box":
        return (f(centre), f(rng.uniform(0.3, 1.0, (n, 3))), f(q))
    mask = np.ones((n, 12), bool)
    mask[:, 10:] = False
    return (f(centre), f(q), f(rng.normal(size=(n, 12, 3)) * 0.6),
            torch.from_numpy(mask).to(device))


CONTENT_JAX_SOUPS = (("cylinder", "box"), ("cylinder", "cylinder"))
# the JAX package's own GJK + EPA (24 iterations) against its analytic
# recipes on these soups at 65,536 pairs and the phase's seed (16):
# JAX_PLATFORMS=cpu python3 tools/gjk_epa_soups_cpu.py
CONTENT_JAX_STATS = {
    "cylinder-box": dict(hit_agreement=0.9862060546875,
                         normal_or_depth_ok=0.9820284419440538,
                         depth_p90=0.005202719010412693),
    "cylinder-cylinder": dict(hit_agreement=0.99285888671875,
                              normal_or_depth_ok=0.9018751605445672,
                              depth_p90=0.04126860946416855)}
CONTENT_STATS_REASON = (
    "tests/test_gjk_epa.py bounds GJK + EPA against the analytic recipes on "
    "256 pairs (agreement >= 0.995, normal or depth share > 0.9, depth gap "
    "p90 < 0.05, max < 0.15); at 65,536 pairs of the same distributions the "
    "JAX package itself has agreement 0.9862 (cylinder-box) and 0.9929 "
    "(cylinder-cylinder) and largest gaps 0.174 and 0.234 "
    "(tools/gjk_epa_soups_cpu.py), so the card is held to the JAX "
    "package's own statistics on the same pairs: agreement within 0.002, "
    "the normal-or-depth share within 0.005, the p90 gap within 0.005; the "
    "largest gap is printed")


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _jax_test_soup(ka, kb, rng, n, device):
    """tests/test_gjk_epa.py's cylinder-box and cylinder-cylinder soups
    (their distributions, drawn with numpy): the cylinder-box pairs have
    the box at the origin, unturned, and the first quarter of the
    cylinders upright over it."""
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731,E501
    u = rng.uniform
    if kb == "box":
        aa = u(-1.5, 1.5, (n, 3))
        ab = aa + u(-1.5, 1.5, (n, 3))
        ar = u(0.1, 0.5, n)
        bh = u(0.3, 1.0, (n, 3))
        q = n // 4
        aa[:q, 0] = u(-0.5, 0.5, q)
        aa[:q, 2] = u(-0.5, 0.5, q)
        aa[:q, 1] = u(0.2, 1.2, q)
        ab[:q] = aa[:q] + np.array([0.0, 1.0, 0.0])
        idq = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
        return (f(aa), f(ab), f(ar)), (f(np.zeros((n, 3))), f(bh), f(idq))
    aa = u(-1.0, 1.0, (n, 3))
    ab = aa + u(-1.5, 1.5, (n, 3))
    ba = u(-1.0, 1.0, (n, 3))
    bb = ba + u(-1.5, 1.5, (n, 3))
    return ((f(aa), f(ab), f(u(0.1, 0.5, n))),
            (f(ba), f(bb), f(u(0.1, 0.5, n))))


def _analytic(ka, kb, pa, pb):
    """The reference step's closed-form recipe of a pairing, where the
    port has one: (hit, the first point's depth, normal), as
    tests/test_gjk_epa.py reads them."""
    from dxk_tpu_torch.ops import narrowphase as nph
    fn = {("sphere", "sphere"): nph.sphere_sphere_contact,
          ("sphere", "capsule"): nph.sphere_capsule_contact,
          ("sphere", "cylinder"): nph.sphere_cylinder_contact,
          ("sphere", "box"): nph.sphere_box_contact,
          ("capsule", "capsule"): nph.capsule_capsule_contact,
          ("capsule", "cylinder"): nph.capsule_cylinder_contact,
          ("capsule", "box"): nph.capsule_box_contact,
          ("cylinder", "cylinder"): nph.cylinder_cylinder_contact,
          ("cylinder", "box"): nph.cylinder_box_contact,
          ("box", "box"): nph.box_box_contact}.get((ka, kb))
    if fn is None:
        return None
    _pts, dps, nrm, _cnt, hit = fn(*pa, *pb)
    return hit, dps[:, 0], nrm


def content_gjk(device, seed):
    """GJK + EPA on CONTENT_PAIRS seeded pairs of each pairing of the five
    shapes: ms a call, hit share, the analytic recipe's agreement where
    there is one (held to the JAX package's own statistics on the JAX
    test's cylinder-box and cylinder-cylinder soups), and a slice on the
    card against the CPU."""
    from dxk_tpu_torch.ops import epa as epa_mod
    from dxk_tpu_torch.ops import gjk as gjk_mod
    out = {}
    for ka, kb in CONTENT_PAIRINGS:
        rng = np.random.default_rng(seed + 31 * CONTENT_SHAPES.index(ka)
                                    + CONTENT_SHAPES.index(kb))
        n = CONTENT_PAIRS
        if (ka, kb) in CONTENT_JAX_SOUPS:
            pa, pb = _jax_test_soup(ka, kb, rng, n, device)
        else:
            ca = rng.normal(size=(n, 3))
            cb = ca + rng.normal(size=(n, 3)) * 0.9
            pa = _content_shape(ka, rng, n, ca, device)
            pb = _content_shape(kb, rng, n, cb, device)
        sa = getattr(gjk_mod, f"support_{ka}")
        sb = getattr(gjk_mod, f"support_{kb}")

        iters = 24 if (ka, kb) in CONTENT_JAX_SOUPS else 20
        _sync(device)
        t0 = time.perf_counter()
        hit, simplex = gjk_mod.gjk_intersection(sa, sb, pa, pb)
        point, normal, depth = epa_mod.epa(sa, sb, pa, pb, simplex,
                                           max_iterations=iters)
        _sync(device)
        secs = time.perf_counter() - t0
        if not _finite(point[hit], normal[hit], depth[hit]):
            raise RuntimeError(f"content {ka}-{kb}: not finite")
        row = dict(ms=secs * 1e3, pairs=n, epa_iterations=iters,
                   pairs_per_s=n / secs,
                   hit_share=float(hit.float().mean()))
        # the CPU slice, pair by pair
        m = CONTENT_CPU_PAIRS
        cpa, cpb = (tuple(x[:m].cpu() for x in p) for p in (pa, pb))
        chit, csx = gjk_mod.gjk_intersection(sa, sb, cpa, cpb)
        cpu = (chit,) + epa_mod.epa(sa, sb, cpa, cpb, csx,
                                    max_iterations=iters)
        card = [x[:m].cpu() for x in (hit, point, normal, depth)]
        both = card[0] & cpu[0]
        worst = torch.stack([
            (x - y).abs().reshape(m, -1).amax(-1)
            / max(1.0, float(y.abs().max()))
            for x, y in zip(card[1:], cpu[1:])]).amax(0)[both]
        off = float((worst > CONTENT_TOL).float().mean()) if worst.numel() \
            else 0.0
        row["card_vs_cpu"] = dict(
            hit_agreement=float((card[0] == cpu[0]).float().mean()),
            hits=int(both.sum()), share_past_tol=off,
            worst=float(worst.max()) if worst.numel() else 0.0)
        if row["card_vs_cpu"]["hit_agreement"] < 0.99 or off > 0.01:
            raise RuntimeError(f"content {ka}-{kb}: card vs CPU "
                               f"{row['card_vs_cpu']} ({CONTENT_REASON})")
        ana = _analytic(ka, kb, pa, pb)
        if ana is not None:
            ahit, adepth, anrm = ana
            valid = torch.ones_like(hit)
            if (ka, kb) == ("cylinder", "cylinder"):
                ua = pa[1] - pa[0]
                ub = pb[1] - pb[0]
                cosab = (ua * ub).sum(-1) / (ua.norm(dim=-1)
                                             * ub.norm(dim=-1))
                valid = cosab.abs() <= 0.99
            both = hit & ahit & valid & (depth < 0.3)
            dd = (adepth - depth).abs()[both]
            nd = (anrm * normal).sum(-1)[both]
            ok = (nd > 0.9) | (dd < 0.01)
            ana_row = dict(
                hit_agreement=float(((hit == ahit) | ~valid)
                                    .float().mean()),
                depth_p90=float(torch.quantile(dd, 0.9)) if dd.numel()
                else 0.0, depth_max=float(dd.max()) if dd.numel()
                else 0.0, normal_or_depth_ok=float(ok.float().mean())
                if ok.numel() else 1.0)
            row["analytic"] = ana_row
            want = CONTENT_JAX_STATS.get(f"{ka}-{kb}")
            if want is not None:
                ana_row["jax_package"] = want
                if not (ana_row["hit_agreement"]
                        >= want["hit_agreement"] - 0.002
                        and ana_row["normal_or_depth_ok"]
                        >= want["normal_or_depth_ok"] - 0.005
                        and ana_row["depth_p90"]
                        <= want["depth_p90"] + 0.005):
                    raise RuntimeError(f"content {ka}-{kb}: GJK+EPA vs "
                                       f"the analytic recipe {ana_row} "
                                       f"({CONTENT_STATS_REASON})")
        out[f"{ka}-{kb}"] = row
    return out


def content_clip(device, seed):
    """A seeded clip of ANIM_JOINTS joints (a chain with branches), keys at
    seeded times, root motion, looping."""
    from dxk_tpu_torch.ops.animation import make_clip
    rng = np.random.default_rng(seed)
    length = 3.0

    def tracks(dim, quat):
        out = []
        for _ in range(ANIM_JOINTS):
            n = int(rng.integers(0, 9))
            ts = np.sort(rng.uniform(0, length, n))
            if n:
                ts[0] = 0.0
            v = rng.normal(size=(n, dim))
            if quat:
                v /= np.linalg.norm(v, axis=-1, keepdims=True)
            elif dim == 3 and rng.uniform() < 0.3:
                v = np.abs(v) * 0.2 + 0.9
            out.append((ts.tolist(), v.tolist()))
        return out
    parents = np.array([-1] + [int(rng.integers(0, j))
                               for j in range(1, ANIM_JOINTS)])
    clip = make_clip(tracks(3, False), tracks(4, True),
                     [([], [])] * ANIM_JOINTS, length,
                     root_pos=([0.0, length], [(0, 0, 0), (2, 0, 1)]),
                     device=device)
    return clip, parents


def content_animation(device, seed):
    """ANIM_INSTANCES instances of a seeded clip: instance_update,
    global_transforms, skinning_matrices and skin_points of ANIM_VERTS
    points, timed on the card; ANIM_CPU_INSTANCES of them on the card
    against the CPU."""
    from dxk_tpu_torch.ops import animation as an
    rng = np.random.default_rng(seed + 1)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    inv_bind = f(rng.normal(size=(ANIM_JOINTS, 4, 4)) * 0.3 + np.eye(4))
    pts = f(rng.normal(size=(ANIM_VERTS, 3)))
    ids = torch.from_numpy(rng.integers(0, ANIM_JOINTS,
                                        (ANIM_VERTS, ANIM_WEIGHTS)))
    wts = f(rng.dirichlet(np.ones(ANIM_WEIGHTS), ANIM_VERTS))
    start = f(rng.uniform(0, 3.0, ANIM_INSTANCES))

    def run(dev, n, steps=3):
        clip, parents = content_clip(dev, seed)
        inst = an.instance_init(clip, start[:n].to(dev))
        times = {}

        def timed(name, fn):
            _sync(dev)
            t0 = time.perf_counter()
            r = fn()
            _sync(dev)
            times[name] = (time.perf_counter() - t0) * 1e3
            return r
        for _ in range(steps):
            inst, loc, delta = timed("instance_update_ms",
                                     lambda: an.instance_update(clip, inst,
                                                                1.0 / 30.0))
        g = timed("global_transforms_ms",
                  lambda: an.global_transforms(parents, loc))
        m = timed("skinning_matrices_ms",
                  lambda: an.skinning_matrices(g, inv_bind.to(dev)))
        skin = timed("skin_points_ms", lambda: an.skin_points(
            m, pts.to(dev), ids.to(dev), wts.to(dev)))
        return dict(inst=inst, delta=delta, g=g, m=m, skin=skin), times
    card, times = run(device, ANIM_INSTANCES)
    card, times = run(device, ANIM_INSTANCES)         # warm
    cpu, _ = run("cpu", ANIM_CPU_INSTANCES)
    k = ANIM_CPU_INSTANCES
    errs = {
        "time": _rel_err(card["inst"].time[:k], cpu["inst"].time),
        "delta_pos": _rel_err(card["delta"].pos[:k], cpu["delta"].pos),
        "global_rot": _rel_err(card["g"].rot[:k], cpu["g"].rot),
        "global_pos": _rel_err(card["g"].pos[:k], cpu["g"].pos),
        "matrices": _rel_err(card["m"][:k], cpu["m"]),
        "skinned": _rel_err(card["skin"][:k], cpu["skin"])}
    for name, (e, s) in errs.items():
        if not e <= ANIM_TOL * s:
            raise RuntimeError(f"content animation: {name} differs from the "
                               f"CPU by {e} (scale {s})")
    if not _finite(card["skin"], card["m"]):
        raise RuntimeError("content animation: not finite")
    return dict(instances=ANIM_INSTANCES, joints=ANIM_JOINTS,
                verts=ANIM_VERTS, weights=ANIM_WEIGHTS, **times,
                card_vs_cpu=errs, tolerance=ANIM_TOL)


def content_phase(seed):
    """GJK + EPA and skeletal animation on the card."""
    t_phase = time.perf_counter()
    gjk = content_gjk(DEVICE, seed)
    t_anim = time.perf_counter()
    anim = content_animation(DEVICE, seed)
    emit("content", gjk_epa=gjk, gjk_epa_reason=CONTENT_REASON,
         animation=anim, seconds=dict(gjk_epa=t_anim - t_phase,
                                      animation=time.perf_counter() - t_anim),
         phase_seconds=time.perf_counter() - t_phase)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600,
                    help="env steps of each serve rollout (at least 120)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan-golden", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.scan_golden:
        # the scan phase's child: one golden on "scan", its result as JSON
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke.py needs a CUDA device")
        print(json.dumps(scan_golden(args.scan_golden, dict(SCAN_GOLDENS)[
            args.scan_golden])), flush=True)
        return
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
    plain_ms = time_ms(run_plain, 1)
    kernel_ms2 = time_ms(run_kernel, 20)
    b_ms, b_by, b_detail = bound_ms(tab, live, NUM_ENVS)
    emit("kernels", tolerance=KERNEL_TOL, tolerance_reason=TOL_REASON,
         full=cmp_full, ragged=cmp_ragged, phased=cmp_phased,
         kernel_ms=kernel_ms,
         kernel_ms_again=kernel_ms2, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, bound_detail=b_detail,
         plans=plans_by_batch(tab, (NUM_ENVS, RAGGED_ENVS)))
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

    # ---- train: on-device PPO through the training entry point
    train_kernel = train_phase(args.seed + 10)

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

    # ---- config 4 without its vehicle: cloth on the terrain and ragdoll
    cloth_kernel = cloth_phase(args.seed + 13)

    # ---- config 4 whole: the vehicle and the sheet on the terrain; a
    # trigger and an owned force field
    config4_kernel = config4_phase(args.seed + 14)

    # ---- a 1,081-row box pile, past the one-env-per-block kernel's limit
    bigpile_phase(args.seed + 9)

    # ---- the broadphase kernels' edge cases
    broadphase_cases_phase()

    # ---- the box stack on the reference step, each broadphase
    box_kernels = box_stack_phase(args.seed + 3)

    # ---- config 1's default path: the box stack as island envs on the
    # fused step, and the engine services
    islands_kernel = islands_phase(args.seed + 12, smi)

    # ---- the reference step in "scan": the entry() configuration, the
    # other reference modes, the step-1 gate and the fast goldens
    scan_launches, scan_matrix = scan_phase(args.seed + 11)

    # ---- the demo scene: the noise, the twin, a batch of it, the
    # ray-caster; then GJK + EPA and skeletal animation
    demo_matrix = demo_phase(args.seed + 15)
    content_phase(args.seed + 16)
    for k in box_kernels:
        if k["name"] == "aabb_overlap_matrix":
            k["launches_by_path"] = {"box_stack_table": k["launches"],
                                     "scan_entry": scan_launches,
                                     "demo_twin": demo_matrix["twin"][0],
                                     "demo_batch": demo_matrix["batch"][0]}
            k["launches"] += scan_launches + sum(
                n for n, _m in demo_matrix.values())
            k["scan_entry_shape"] = scan_matrix
            for path, (_n, m) in demo_matrix.items():
                k[f"demo_{path}_shape"] = m

    print(json.dumps({"kernels": [{
        "name": "fused_step", "route": "cuda",
        "source": "dxk_tpu_torch/ops/kernels/csrc/fused_step.cu",
        "replaces": "dxk_tpu/ops/pallas/fused_step.py:1177",
        "launches": launches, "max_abs_err": max(
            cmp_full[k] for k in ("err_v", "err_w", "err_pos", "err_rot",
                                  "err_imp")),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        **plan_fields(tab, NUM_ENVS)}, train_kernel, zoo_kernel,
        settle_kernel,
        shapes_kernel, fidelity_kernel, terrain_kernel, cloth_kernel,
        config4_kernel, islands_kernel]
        + box_kernels}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
