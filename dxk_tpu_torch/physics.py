"""Top-level physics step of the port.

Pipeline per substep, batched over environments (same order as the JAX
package's physics.py):
  1. world-space collider flattening + AABBs
  2. broadphase: static pair tables, K-select or sort-and-sweep
  3. narrowphase: per-bucket contact manifolds (+ heightfield terrain rows)
  4. trigger / localized force-field overlaps, then integrate forces
     (gravity, damping, global and localized force fields)
  5. contact and joint prep + N solver iterations over the seven types
  6. integrate velocities
  7. cloth (ops/cloth.py): wind, the constraint passes, the push-out from
     the colliders and the terrain and, with two-way coupling, its
     impulses on the bodies' velocities

Two branches, as in the JAX package: the fused step (``solver_mode=
"fused"`` or ``"fused_seq"`` on a scene the fused kernel takes), where 3
and 5 run inside one kernel (ops/kernels/fused_step.py), heightfield
terrain contacts prepared beside it and passed in; and the reference step
for every other scene and mode ("scan", "jacobi", "colored"; "fused" runs
"jacobi" there and "fused_seq" runs "scan"), with all 15 contact buckets,
the six joint types and heightfield terrain. Both branches find the
trigger and localized force-field overlaps before the forces are
integrated, and step cloth.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from dxk_tpu_torch.core.maths import cross, quat_inv_rotate, quat_rotate, sqrt
from dxk_tpu_torch.ops.integrator import (_mat3_vec, integrate_forces,
                                          integrate_velocities)
from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu_torch.scene.scene import (SHAPE_BOX, SHAPE_CAPSULE,
                                       SHAPE_CYLINDER, SHAPE_HULL,
                                       SHAPE_SPHERE, Scene, State, StepInfo)

@dataclass(frozen=True)
class PhysicsSettings:
    """Solver settings: the fields of the JAX package's PhysicsSettings,
    with its defaults. `solver_mode` is "scan" (sequential impulses),
    "jacobi", "colored", "fused" or "fused_seq"; `validate` reports the
    first pipeline stage with a non-finite value in
    StepInfo.validate_stage (utils/validate.py). The cloth passes run
    `num_cloth_*_iterations` times each; `cloth_solver_mode` is "scan"
    (the reference's sequential sweep) or "colored" (colour groups);
    `cloth_two_way` gives the bodies the momentum the cloth's push-out
    takes from the particles."""

    num_rigid_solver_iterations: int = 30
    num_cloth_velocity_iterations: int = 0
    num_cloth_position_iterations: int = 1
    num_cloth_drift_iterations: int = 0
    cloth_solver_mode: str = "scan"
    solver_mode: str = "scan"
    sor_omega: float = 1.0
    validate: bool = False
    cloth_two_way: bool = True
    joint_prep_in_kernel: bool = True


def controls_pack(scene: Scene, controls, dt) -> torch.Tensor:
    """(B, R+1) controls pack for the fused step: per joint type in solve
    order, per joint, the type's control fields as float32 (distance, ball
    and fixed joints have none); dt last."""
    from dxk_tpu_torch.ops.kernels.cm_joint_prep import CTL_ATTRS, CTL_FIELDS
    like = controls.hinge_target                            # (B, Jh)
    cols = []
    for name in scene.joint_types:
        per_field = [getattr(controls, CTL_ATTRS[name][f]).to(torch.float32)
                     for f in CTL_FIELDS[name]]             # each (B, J)
        if per_field:
            cols.append(torch.stack(per_field, dim=-1).flatten(1))
    cols.append(torch.full((like.shape[0], 1), float(np.float32(dt)),
                           dtype=torch.float32, device=like.device))
    return torch.cat(cols, dim=1).contiguous()


def _cloth_substep(scene, new_state, state, settings, dt, w, bodies):
    """The cloth step on the colliders `w` from before the step and, with
    two-way coupling, its impulse and torque-impulse sums applied to the
    post-solve velocities through `bodies` (the solve's SolverBodies: its
    world inverse inertia and centres of mass from before integration).
    Cloth runs last (physics.cpp:1354-1358)."""
    from dxk_tpu_torch.ops.cloth import cloth_step
    two_way = settings.cloth_two_way
    cl, imp = cloth_step(
        scene.cloth, state.cloth, settings, scene.global_ff_force, dt,
        world=w, hulls=scene.hulls, heightfield=scene.heightfield,
        bodies=bodies if two_way else None,
        colbody=scene.colliders.body if two_way else None)
    new_state = new_state.replace(cloth=cl)
    if imp is not None:
        jsum, tsum = imp
        new_state = new_state.replace(
            lin_vel=new_state.lin_vel + jsum * bodies.inv_mass[:, None],
            ang_vel=new_state.ang_vel + _mat3_vec(bodies.inv_inertia, tsum))
    return new_state


def physics_step(scene: Scene, state: State, settings: PhysicsSettings,
                 dt: float) -> Tuple[State, StepInfo]:
    """One fixed substep of a batch of environments."""
    tracker = None
    if settings.validate:
        from dxk_tpu_torch.utils.validate import StageTracker
        tracker = StageTracker(state.pos.shape[0], state.pos.device)
    if settings.solver_mode in ("fused", "fused_seq"):
        from dxk_tpu_torch.ops.kernels.fused_step import fused2_eligible
        if fused2_eligible(scene):
            return _physics_step_fused(scene, state, settings, dt, tracker)
    return _physics_step_reference(scene, state, settings, dt, tracker)


def _hull_tables(hulls, hid):
    """The per-pair hull tables of the SAT recipes, gathered by hull id
    (hid (B, P)): vertices, vertex mask, face polygons' normals, offsets,
    mask, loops, loop lengths, edge directions and edge mask."""
    return tuple(t[hid] for t in (
        hulls.vertices, hulls.vertex_mask, hulls.poly_normals,
        hulls.poly_offsets, hulls.poly_mask, hulls.loop_pts, hulls.loop_len,
        hulls.edge_dirs, hulls.edge_mask))


def _contacts_for_group(scene, w, group, pairs, mask):
    """Contact manifolds of one (typeA, typeB) bucket. pairs (B, P, 2),
    mask (B, P). Returns (points (B, P, 4, 3), depths (B, P, 4),
    normal (B, P, 3), count (B, P), hit (B, P))."""
    from dxk_tpu_torch.ops import narrowphase as np_ops
    ta, tb = group.type_a, group.type_b
    ia, ib = pairs[..., 0].long(), pairs[..., 1].long()
    ar = torch.arange(ia.shape[0], device=ia.device)[:, None]
    a_a, a_b, a_r, a_q = w.a[ar, ia], w.b[ar, ia], w.r[ia], w.rot[ar, ia]
    b_a, b_b, b_r, b_q = w.a[ar, ib], w.b[ar, ib], w.r[ib], w.rot[ar, ib]

    if (ta, tb) == (SHAPE_SPHERE, SHAPE_SPHERE):
        out = np_ops.sphere_sphere_contact(a_a, a_r, b_a, b_r)
    elif (ta, tb) == (SHAPE_SPHERE, SHAPE_CAPSULE):
        out = np_ops.sphere_capsule_contact(a_a, a_r, b_a, b_b, b_r)
    elif (ta, tb) == (SHAPE_SPHERE, SHAPE_CYLINDER):
        out = np_ops.sphere_cylinder_contact(a_a, a_r, b_a, b_b, b_r)
    elif (ta, tb) == (SHAPE_SPHERE, SHAPE_BOX):
        out = np_ops.sphere_box_contact(a_a, a_r, b_a, b_b, b_q)
    elif (ta, tb) == (SHAPE_CAPSULE, SHAPE_CAPSULE):
        out = np_ops.capsule_capsule_contact(a_a, a_b, a_r, b_a, b_b, b_r)
    elif (ta, tb) == (SHAPE_CAPSULE, SHAPE_CYLINDER):
        out = np_ops.capsule_cylinder_contact(a_a, a_b, a_r, b_a, b_b, b_r)
    elif (ta, tb) == (SHAPE_CAPSULE, SHAPE_BOX):
        out = np_ops.capsule_box_contact(a_a, a_b, a_r, b_a, b_b, b_q)
    elif (ta, tb) == (SHAPE_CYLINDER, SHAPE_CYLINDER):
        out = np_ops.cylinder_cylinder_contact(a_a, a_b, a_r, b_a, b_b, b_r)
    elif (ta, tb) == (SHAPE_CYLINDER, SHAPE_BOX):
        out = np_ops.cylinder_box_contact(a_a, a_b, a_r, b_a, b_b, b_q)
    elif (ta, tb) == (SHAPE_BOX, SHAPE_BOX):
        out = np_ops.box_box_contact(a_a, a_b, a_q, b_a, b_b, b_q)
    elif tb == SHAPE_HULL:
        h = scene.hulls
        hid_b = w.hull_id.long()[ib]
        tb_tabs = _hull_tables(h, hid_b)
        hv, hm = tb_tabs[:2]
        tri = (h.face_normals[hid_b], h.face_offsets[hid_b],
               h.face_mask[hid_b])
        if ta == SHAPE_SPHERE:
            out = np_ops.sphere_hull_contact(a_a, a_r, b_a, b_q, hv, hm, *tri)
        elif ta == SHAPE_CAPSULE:
            out = np_ops.capsule_hull_contact(a_a, a_b, a_r, b_a, b_q, hv, hm,
                                              *tri)
        elif ta == SHAPE_CYLINDER:
            out = np_ops.cylinder_hull_contact(a_a, a_b, a_r, b_a, b_q,
                                               *tb_tabs)
        elif ta == SHAPE_BOX:
            out = np_ops.box_hull_contact(a_a, a_b, a_q, b_a, b_q, *tb_tabs)
        else:
            out = np_ops.hull_hull_contact(
                a_a, a_q, *_hull_tables(h, w.hull_id.long()[ia]),
                b_a, b_q, *tb_tabs)
    else:
        raise NotImplementedError(f"contact pair ({ta}, {tb}) not implemented")
    pts, dps, nrm, cnt, hit = out
    hit = hit & mask
    cnt = torch.where(hit, cnt, 0)
    return pts, dps, nrm, cnt, hit


def _overlap_interactions(scene, w, mn, mx):
    """Trigger and localized force-field overlaps with the rigid bodies
    (overlapCheck, collision_narrow.cpp:1593-1689): the AABB pre-filter,
    then the exact shape test of each type bucket (the contact recipes as
    boolean tests), scattered back to the order of scene.overlap_pairs by
    each bucket's baked flat_index. w: the step's world colliders, mn / mx
    (B, C, 3). Returns (trigger_overlap (B, Q) bool, the force-field force
    on each body (B, N+1, 3))."""
    from dxk_tpu_torch.ops.broadphase import aabb_overlap_mask
    pairs = scene.overlap_pairs.long()
    B, Q = mn.shape[0], pairs.shape[0]
    overlap = torch.zeros((B, Q), dtype=torch.bool, device=mn.device)
    for g in scene.overlap_groups:
        m = aabb_overlap_mask(mn, mx, g.pairs)
        hit = _contacts_for_group(scene, w, g,
                                  g.pairs[None].expand(B, -1, 2), m)[4]
        overlap[:, g.flat_index] = hit

    c = scene.colliders
    ia, ib = pairs[:, 0], pairs[:, 1]
    # which side is the trigger / force field, which the rigid body
    a_is_other = c.owner_type[ia] >= 2
    other = torch.where(a_is_other, ia, ib)
    rb_body = c.body[torch.where(a_is_other, ib, ia)].long()
    ff_type = c.owner_type[other] == 2
    is_ff = ff_type & overlap                                   # (B, Q)
    # a trigger's owner index counts triggers, not force-field slots
    slot = torch.where(ff_type, c.owner_index[other], 0).long()
    ff_force = scene.ff_forces[slot] * is_ff[..., None]         # (B, Q, 3)
    force = torch.zeros((B, scene.num_bodies + 1, 3), dtype=ff_force.dtype,
                        device=mn.device)
    force.index_add_(1, rb_body, ff_force)
    return (c.owner_type[other] == 3) & overlap, force


def _with_overlaps(scene, state, w, mn, mx):
    """The state with the localized force fields' forces added to its
    accumulators before the forces are integrated (physics.cpp:963-967),
    and the trigger mask; the state as it is and None for a scene without
    overlap pairs."""
    if scene.overlap_pairs is None or scene.overlap_pairs.shape[0] == 0:
        return state, None
    trigger, force = _overlap_interactions(scene, w, mn, mx)
    return state.replace(force_acc=state.force_acc + force), trigger


def reference_preps(scene, bodies, controls, dt32, contacts=None):
    """The Prepped of the solve: the contact prep `contacts` and the
    scene's joints prepared on the integrated `bodies`."""
    from dxk_tpu_torch.ops.solver import Prepped, prep_joints
    return Prepped(contacts=contacts, **dict(zip(
        scene.joint_types,
        prep_joints(scene, bodies, controls, dt32))))


def _physics_step_reference(scene, state, settings, dt, tracker=None):
    """The reference step: broadphase, narrowphase per type bucket,
    heightfield terrain rows, contact and joint prep and the solve as
    separate stages. `tracker` (utils/validate.StageTracker or None)
    checks each stage's output."""
    from dxk_tpu_torch.ops.broadphase import (aabb_overlap_mask,
                                              compact_pairs, is_dense,
                                              kselect_group_pairs)
    from dxk_tpu_torch.ops.kernels.broadphase_kernel import (
        aabb_overlap_matrix)
    from dxk_tpu_torch.ops.solver import prep_contacts, solve_constraints

    # "fused" / "fused_seq" on a scene the fused kernel does not take run
    # their semantics here
    mode = {"fused": "jacobi", "fused_seq": "scan"}.get(
        settings.solver_mode, settings.solver_mode)
    if mode not in ("scan", "jacobi", "colored"):
        raise ValueError(f"unknown solver_mode {settings.solver_mode!r}")
    if mode == "colored" and scene.pair_groups \
            and scene.num_contact_phases <= 1:
        warnings.warn(
            "solver_mode='colored' on a scene finalized without "
            "contact_phases>1: contacts degrade to averaged Jacobi. "
            "Pass contact_phases=4 (or more) to SceneBuilder.finalize "
            "for conflict-free Gauss-Seidel contact slices.",
            stacklevel=3)
    controls = state.controls if state.controls is not None \
        else scene.batched_controls(state.pos.shape[0])
    dt32 = float(np.float32(dt))
    B = state.pos.shape[0]
    dev = state.pos.device

    # 1-2: colliders -> AABBs -> candidate overlaps
    w = world_colliders(scene, state.pos, state.rot)
    mn, mx = collider_aabbs(scene, w)
    if tracker is not None:
        tracker.check("world_colliders", w)
        tracker.check("aabbs", (mn, mx))

    # groups in ascending contact-phase order, so the concatenated contact
    # rows are phase-contiguous for the solver's phase slices
    groups = scene.pair_groups
    order = sorted(range(len(groups)), key=lambda gi: groups[gi].phase)
    num_overlaps = torch.zeros(B, dtype=torch.int32, device=dev)
    num_dropped = torch.zeros(B, dtype=torch.int32, device=dev)

    kselect = None
    matrix = None
    if scene.broadphase_k > 0:
        kselect, num_overlaps, row_dropped = kselect_group_pairs(scene, mn, mx)
        num_dropped = num_dropped + row_dropped
    elif any(is_dense(g.pairs.shape[0], mn.shape[1]) for g in groups):
        # one overlap matrix serves every dense table of the step
        matrix = aabb_overlap_matrix(mn, mx)

    selected = []
    for gi in order:
        group = groups[gi]
        if kselect is not None:
            pairs, mask, dropped = kselect[gi]
        else:
            mask = aabb_overlap_mask(mn, mx, group.pairs, matrix)
            num_overlaps = num_overlaps + torch.sum(mask, dim=-1,
                                                    dtype=torch.int32)
            pairs, mask, dropped = compact_pairs(group.pairs, mask,
                                                 group.max_narrow)
        num_dropped = num_dropped + dropped
        selected.append((gi, group, pairs, mask))

    # 3: one narrowphase call per (typeA, typeB) bucket; the phase splits of
    # a bucket are concatenated and split back after
    buckets = {}
    for item in selected:
        buckets.setdefault((item[1].type_a, item[1].type_b), []).append(item)
    narrow = {}
    for items in buckets.values():
        cat_pairs = torch.cat([it[2] for it in items], dim=1)
        cat_mask = torch.cat([it[3] for it in items], dim=1)
        out = _contacts_for_group(scene, w, items[0][1], cat_pairs, cat_mask)
        ia, ib = cat_pairs[..., 0].long(), cat_pairs[..., 1].long()
        # friction/restitution combine
        fric = torch.clamp(sqrt(w.friction[ia] * w.friction[ib]),
                           0.0, 1.0)
        rest = torch.clamp(torch.maximum(w.restitution[ia],
                                         w.restitution[ib]), 0.0, 1.0)
        fields = (*out, w.body[ia].long(), w.body[ib].long(), fric, rest)
        off = 0
        for gi, _g, p, _m in items:
            n = p.shape[1]
            narrow[gi] = tuple(x[:, off:off + n] for x in fields)
            off += n

    # 3b: heightfield terrain contacts, a trailing phase slice of one row
    # per collider
    hf = None
    if scene.heightfield is not None:
        from dxk_tpu_torch.ops.heightmap import (heightfield_contacts,
                                                 heightfield_plan)
        hf = heightfield_contacts(scene.heightfield, w, w.body, mn, mx,
                                  scene.num_bodies,
                                  plan=heightfield_plan(scene))

    # 4: trigger / force-field overlaps, then integrate forces
    state, trigger_overlap = _with_overlaps(scene, state, w, mn, mx)
    bodies = integrate_forces(scene, state, dt32)

    # pair-major contact rows: (B, P, 4) points per pair, phases contiguous
    prepped_contacts = None
    contact_pairs = None
    contact_mask = None
    total_contacts = torch.zeros(B, dtype=torch.int32, device=dev)
    if selected or hf is not None:
        parts = []
        sizes = ()
        if selected:
            cols = [[] for _ in range(9)]
            phase_sizes = {}
            for gi, group, pairs, _mask in selected:
                for col, x in zip(cols, narrow[gi]):
                    col.append(x)
                phase_sizes[group.phase] = (phase_sizes.get(group.phase, 0)
                                            + pairs.shape[1])
            pts, dps, nrm, cnt, hit, body_a, body_b, fric, rest = (
                torch.cat(c, dim=1) for c in cols)
            P = pts.shape[1]
            nrm = nrm[:, :, None, :].expand(B, P, 4, 3)
            cmask = hit[..., None] & (torch.arange(4, device=dev)
                                      < cnt[..., None])
            # dead pairs point at the dummy static body, so they do not
            # count in the per-body degrees of the averaged solve
            live = torch.any(cmask, dim=-1)
            body_a = torch.where(live, body_a, scene.num_bodies)
            body_b = torch.where(live, body_b, scene.num_bodies)
            parts.append((pts, nrm, dps, body_a, body_b, fric, rest, cmask))
            sizes = tuple(phase_sizes[p] for p in sorted(phase_sizes))
        if hf is not None:
            hpts, hnrm, hdps, hba, hbb, hfr, hre, hcm = hf
            C = hpts.shape[1]
            parts.append((hpts, hnrm, hdps, hba, hbb,
                          hfr.expand(B, C), hre.expand(B, C), hcm))
            sizes = sizes + (C,)
        pts, nrm, dps, body_a, body_b, fric, rest, cmask = (
            torch.cat([p[i] for p in parts], dim=1) for i in range(8))
        total_contacts = torch.sum(cmask.flatten(1), dim=-1,
                                   dtype=torch.int32)
        contact_mask = torch.any(cmask, dim=-1)
        if selected:
            cpairs = [it[2] for it in selected]
            if hf is not None:
                cpairs.append(torch.full((B, hf[0].shape[1], 2), -1,
                                         dtype=cpairs[0].dtype, device=dev))
            contact_pairs = torch.cat(cpairs, dim=1)
        if tracker is not None:
            tracker.check("contacts", (pts, nrm, dps))
        prepped_contacts = prep_contacts(bodies, body_a, body_b, pts, nrm,
                                         dps, fric, rest,
                                         cmask.to(pts.dtype), dt32,
                                         phase_sizes=sizes)

    # 5: constraint prep + solve
    prepped = reference_preps(scene, bodies, controls, dt32,
                              prepped_contacts)
    if tracker is not None:
        tracker.check("body_velocities", (bodies.v, bodies.w))
        tracker.check("constraint_prep", prepped)
    bodies, contact_imp_n = solve_constraints(
        bodies, prepped, settings.num_rigid_solver_iterations, mode,
        settings.sor_omega)
    if tracker is not None:
        tracker.check("solved_velocities", (bodies.v, bodies.w))

    # 6: integrate velocities
    new_state = integrate_velocities(scene, bodies, state, dt32)
    if tracker is not None:
        tracker.check("integrated_state", (new_state.pos, new_state.rot))

    # 7: cloth, on this step's colliders
    if scene.cloth is not None and state.cloth is not None:
        new_state = _cloth_substep(scene, new_state, state, settings, dt32,
                                   w, bodies)

    info = StepInfo(
        num_broadphase_overlaps=num_overlaps,
        num_contacts=total_contacts,
        broadphase_overflow=num_dropped,
        trigger_overlap=trigger_overlap,
        contact_pairs=contact_pairs,
        contact_mask=contact_mask,
        contact_impulse=(torch.sum(contact_imp_n, dim=-1)
                         if contact_imp_n is not None else None),
        validate_stage=tracker.first_bad() if tracker is not None else None,
    )
    return new_state, info


def joint_inputs(scene, bodies, controls, dt32, prep_in_kernel):
    """What the fused step reads its joint rows from: the controls pack
    when the kernel preps the joints itself, else ops/solver.py's preps of
    the integrated `bodies`, each joint type packed into its table
    (batched_solver.pack_joint_type), in scene_joint_ab order."""
    if prep_in_kernel:
        return controls_pack(scene, controls, dt32)
    from dxk_tpu_torch.ops.kernels.batched_solver import pack_joint_type
    from dxk_tpu_torch.ops.solver import prep_joints
    preps = prep_joints(scene, bodies, controls, dt32)
    return tuple(pack_joint_type(name, prep) for name, prep
                 in zip(scene.joint_types, preps))


def terrain_inputs(scene, w, bodies, dt32):
    """The prep-passed contact rows the fused step reads for a scene with a
    heightfield: the terrain contacts of the colliders `w` (before the
    step), prepared by prep_contacts on the integrated `bodies`; None
    without a heightfield."""
    if scene.heightfield is None:
        return None
    from dxk_tpu_torch.ops.heightmap import (heightfield_contacts,
                                             heightfield_plan)
    from dxk_tpu_torch.ops.solver import prep_contacts
    mn, mx = collider_aabbs(scene, w)
    hpts, hnrm, hdps, hba, hbb, hfr, hre, hcm = heightfield_contacts(
        scene.heightfield, w, w.body, mn, mx, scene.num_bodies,
        plan=heightfield_plan(scene))
    return prep_contacts(bodies, hba, hbb, hpts, hnrm, hdps, hfr, hre,
                         hcm.to(hpts.dtype), dt32)


def _physics_step_fused(scene, state, settings, dt, tracker=None):
    """Fused-pipeline step: everything between force integration and
    velocity integration runs inside the fused-step kernel. The sequential
    solve (``"fused_seq"``) always takes joint rows prepared outside the
    kernel, as in the JAX package (its physics.py:66-72). Heightfield
    contacts are found on the colliders before the step and prepared on
    the integrated bodies, then passed in (the JAX package's
    physics.py:483-494)."""
    from dxk_tpu_torch.ops.kernels.fused_step import make_fused_step_solver

    controls = state.controls if state.controls is not None \
        else scene.batched_controls(state.pos.shape[0])
    dt32 = np.float32(dt)
    sequential = settings.solver_mode == "fused_seq"
    jp_in_kernel = settings.joint_prep_in_kernel and not sequential

    w = world_colliders(scene, state.pos, state.rot)
    trigger_overlap = None
    if tracker is not None or scene.overlap_groups:
        # the AABBs feed the trigger / force-field overlaps only here: the
        # kernel's narrowphase needs no pre-filter
        mn, mx = collider_aabbs(scene, w)
        if tracker is not None:
            tracker.check("world_colliders", w)
            tracker.check("aabbs", (mn, mx))
        state, trigger_overlap = _with_overlaps(scene, state, w, mn, mx)
    bodies = integrate_forces(scene, state, float(dt32))
    joints = joint_inputs(scene, bodies, controls, dt32, jp_in_kernel)

    passed = terrain_inputs(scene, w, bodies, dt32)
    if tracker is not None:
        tracker.check("body_velocities", (bodies.v, bodies.w))

    fused = make_fused_step_solver(
        scene, settings.num_rigid_solver_iterations, settings.sor_omega,
        sequential=sequential, joint_prep_in_kernel=jp_in_kernel)
    inv_dt = float(np.float32(1.0) / dt32)
    v_new, w_new, imp_n, point_mask = fused(bodies, w, joints, inv_dt,
                                            passed)
    live = point_mask != 0
    bodies = bodies.replace(v=v_new, w=w_new)
    if tracker is not None:
        tracker.check("solved_velocities", (bodies.v, bodies.w))

    new_state = integrate_velocities(scene, bodies, state, float(dt32))
    if tracker is not None:
        tracker.check("integrated_state", (new_state.pos, new_state.rot))

    if scene.cloth is not None and state.cloth is not None:
        new_state = _cloth_substep(scene, new_state, state, settings,
                                   float(dt32), w, bodies)

    order = sorted(range(len(scene.pair_groups)),
                   key=lambda gi: scene.pair_groups[gi].phase)
    pairs = [scene.pair_groups[gi].pairs for gi in order]
    if scene.heightfield is not None:
        # the terrain rows have no collider pair: (-1, -1) keeps
        # contact_pairs index-aligned with contact_mask and contact_impulse
        pairs.append(torch.full((scene.colliders.ctype.shape[0], 2), -1,
                                dtype=pairs[0].dtype, device=pairs[0].device))
    contact_pairs = torch.cat(pairs)
    n_live = torch.sum(live.to(torch.int32), dim=-1, dtype=torch.int32)
    info = StepInfo(
        num_broadphase_overlaps=n_live,
        num_contacts=n_live,
        broadphase_overflow=torch.zeros_like(n_live),
        trigger_overlap=trigger_overlap,
        contact_pairs=contact_pairs,
        contact_mask=live,
        contact_impulse=torch.sum(imp_n, dim=-1),
        validate_stage=tracker.first_bad() if tracker is not None else None,
    )
    return new_state, info


def apply_ray_impulse(scene: Scene, state: State, origin, direction,
                      strength=1000.0) -> State:
    """Cast one ray per env against all colliders owned by rigid bodies;
    apply `strength * direction` as a force (plus the induced torque) to the
    closest hit body's accumulators. origin, direction: (B, 3). The force
    persists until the next integration step."""
    from dxk_tpu_torch.ops import raycast as rc

    c = scene.colliders
    cbody = c.body.long()
    pos, rot = state.pos, state.rot
    B = pos.shape[0]
    bpos = pos[:, cbody]                                   # (B, C, 3)
    brot = rot[:, cbody]
    o_l = quat_inv_rotate(brot, origin[:, None, :] - bpos)
    d_l = quat_inv_rotate(brot, direction[:, None, :].expand_as(o_l))

    big = 3.4e38
    t_sph, _ = rc.ray_sphere(o_l, d_l, c.a, c.r)
    t_cap, _ = rc.ray_capsule(o_l, d_l, c.a, c.b, c.r)
    t_cyl, _ = rc.ray_cylinder(o_l, d_l, c.a, c.b, c.r)
    t_box, _ = rc.ray_box(o_l, d_l, c.a, c.b, c.rot)
    if scene.hulls is not None:
        h = scene.hulls
        hid = c.hull_id.long().clamp(min=0)    # -1 on the other types
        t_hull, _ = rc.ray_hull(o_l, d_l, c.a, c.rot, h.vertices[hid],
                                h.vertex_mask[hid], h.face_normals[hid],
                                h.face_offsets[hid], h.face_mask[hid])
    else:
        t_hull = torch.full_like(t_sph, big)

    t = torch.where(c.ctype == 0, t_sph,
        torch.where(c.ctype == 1, t_cap,
        torch.where(c.ctype == 2, t_cyl,
        torch.where(c.ctype == 3, t_box, t_hull))))
    # only colliders owned by dynamic rigid bodies are poke targets
    is_rb = c.body < scene.num_bodies
    t = torch.where(is_rb, t, big)

    best = torch.argmin(t, dim=1)                          # (B,)
    ar = torch.arange(B, device=pos.device)
    t_best = t[ar, best]
    hit_any = t_best < big
    body = cbody[best]                                     # (B,)

    hit_local = o_l[ar, best] + t_best[:, None] * d_l[ar, best]
    hit_world = quat_rotate(brot[ar, best], hit_local) + bpos[ar, best]
    cog_world = pos[ar, body] + quat_rotate(
        rot[ar, body], scene.body_params.local_cog[body])

    force = direction * strength
    torque = cross(hit_world - cog_world, force)
    scale = torch.where(hit_any, 1.0, 0.0)[:, None]
    force_acc = state.force_acc.clone()
    torque_acc = state.torque_acc.clone()
    force_acc[ar, body] += force * scale
    torque_acc[ar, body] += torque * scale
    return state.replace(force_acc=force_acc, torque_acc=torque_acc)
