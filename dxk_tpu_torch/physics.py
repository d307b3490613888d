"""Top-level physics step of the port.

Pipeline per substep, batched over environments (same order as the JAX
package's physics.py):
  1. world-space collider flattening + AABBs
  2. broadphase: static pair tables, K-select or sort-and-sweep
  3. narrowphase: per-bucket contact manifolds
  4. integrate forces (gravity, damping)
  5. contact prep + N solver iterations
  6. integrate velocities

Two branches, as in the JAX package: the fused step (``solver_mode=
"fused"`` or ``"fused_seq"`` on a scene the fused kernel takes), where 3
and 5 run inside one kernel (ops/kernels/fused_step.py), heightfield
terrain contacts prepared beside it and passed in; and the reference step
for every other scene, where "fused" falls back to "jacobi". The reference
step is ported for box-box contacts in the "jacobi" and "colored" modes;
"scan", the other contact buckets, joints, heightfields, overlaps and cloth
raise NotImplementedError there, and cloth raises on both branches.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from dxk_tpu_torch.core.maths import cross, quat_inv_rotate, quat_rotate, sqrt
from dxk_tpu_torch.ops.integrator import (integrate_forces,
                                          integrate_velocities)
from dxk_tpu_torch.ops.shapes import collider_aabbs, world_colliders
from dxk_tpu_torch.scene.scene import SHAPE_BOX, Scene, State, StepInfo

JOINT_TYPES = ("distance", "ball", "fixed", "hinge", "cone_twist", "slider")


@dataclass(frozen=True)
class PhysicsSettings:
    """Solver settings (the fields of the JAX package's PhysicsSettings
    that the ported path reads)."""

    num_rigid_solver_iterations: int = 30
    solver_mode: str = "fused"
    sor_omega: float = 1.0
    joint_prep_in_kernel: bool = True


def controls_pack(scene: Scene, controls, dt) -> torch.Tensor:
    """(B, R+1) controls pack for the fused step: per joint type in solve
    order, per joint, the type's control fields as float32 (distance, ball
    and fixed joints have none); dt last."""
    from dxk_tpu_torch.ops.kernels.batched_solver import scene_joint_types
    from dxk_tpu_torch.ops.kernels.cm_joint_prep import CTL_ATTRS, CTL_FIELDS
    like = controls.hinge_target                            # (B, Jh)
    cols = []
    for name in scene_joint_types(scene):
        per_field = [getattr(controls, CTL_ATTRS[name][f]).to(torch.float32)
                     for f in CTL_FIELDS[name]]             # each (B, J)
        if per_field:
            cols.append(torch.stack(per_field, dim=-1).flatten(1))
    cols.append(torch.full((like.shape[0], 1), float(np.float32(dt)),
                           dtype=torch.float32, device=like.device))
    return torch.cat(cols, dim=1).contiguous()


def physics_step(scene: Scene, state: State, settings: PhysicsSettings,
                 dt: float) -> Tuple[State, StepInfo]:
    """One fixed substep of a batch of environments."""
    if scene.cloth is not None:
        raise NotImplementedError("cloth is not ported yet")
    if scene.overlap_pairs is not None and scene.overlap_pairs.shape[0] > 0:
        raise NotImplementedError(
            "trigger / force-field overlaps are not ported yet")
    if settings.solver_mode in ("fused", "fused_seq"):
        from dxk_tpu_torch.ops.kernels.fused_step import fused2_eligible
        if fused2_eligible(scene):
            return _physics_step_fused(scene, state, settings, dt)
    if scene.heightfield is not None:
        raise NotImplementedError(
            "heightfield terrain on the reference step is not ported yet; "
            "the fused step takes it")
    return _physics_step_reference(scene, state, settings, dt)


def _pair_params(w, idx):
    """World box params (center, half extents, rotation) of one side of a
    (B, P) pair list."""
    ar = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return w.a[ar, idx], w.b[ar, idx], w.rot[ar, idx]


def _contacts_for_group(w, group, pairs, mask):
    """Contact manifolds of one (typeA, typeB) bucket. pairs (B, P, 2),
    mask (B, P). Returns (points (B, P, 4, 3), depths (B, P, 4),
    normal (B, P, 3), count (B, P), hit (B, P))."""
    from dxk_tpu_torch.ops import narrowphase as np_ops
    ta, tb = group.type_a, group.type_b
    if (ta, tb) != (SHAPE_BOX, SHAPE_BOX):
        raise NotImplementedError(
            f"contact pair ({ta}, {tb}) on the reference step is not ported "
            "to dxk_tpu_torch yet; only box-box")
    ia, ib = pairs[..., 0].long(), pairs[..., 1].long()
    a_a, a_b, a_q = _pair_params(w, ia)
    b_a, b_b, b_q = _pair_params(w, ib)
    pts, dps, nrm, cnt, hit = np_ops.box_box_contact(a_a, a_b, a_q,
                                                     b_a, b_b, b_q)
    hit = hit & mask
    cnt = torch.where(hit, cnt, 0)
    return pts, dps, nrm, cnt, hit


def _physics_step_reference(scene, state, settings, dt):
    """The reference step: broadphase, narrowphase per type bucket, contact
    prep and the phased contact solve as separate stages."""
    from dxk_tpu_torch.ops.broadphase import (aabb_overlap_mask,
                                              compact_pairs, is_dense,
                                              kselect_group_pairs)
    from dxk_tpu_torch.ops.kernels.broadphase_kernel import (
        aabb_overlap_matrix)
    from dxk_tpu_torch.ops.solver import prep_contacts, solve_constraints

    mode = {"fused": "jacobi", "fused_seq": "scan"}.get(
        settings.solver_mode, settings.solver_mode)
    if mode not in ("jacobi", "colored"):
        raise NotImplementedError(
            f"solver_mode={settings.solver_mode!r} on the reference step is "
            "not ported to dxk_tpu_torch yet; only 'jacobi', 'colored' and "
            "'fused' (which runs 'jacobi' here)")
    joints = [n for n in JOINT_TYPES if getattr(scene, n) is not None]
    if joints:
        raise NotImplementedError(
            f"joints ({', '.join(joints)}) on the reference step are not "
            "ported to dxk_tpu_torch yet")
    if mode == "colored" and scene.pair_groups \
            and scene.num_contact_phases <= 1:
        warnings.warn(
            "solver_mode='colored' on a scene finalized without "
            "contact_phases>1: contacts degrade to averaged Jacobi. "
            "Pass contact_phases=4 (or more) to SceneBuilder.finalize "
            "for conflict-free Gauss-Seidel contact slices.",
            stacklevel=3)
    dt32 = float(np.float32(dt))
    B = state.pos.shape[0]
    dev = state.pos.device

    # 1-2: colliders -> AABBs -> candidate overlaps
    w = world_colliders(scene, state.pos, state.rot)
    mn, mx = collider_aabbs(scene, w)

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
        out = _contacts_for_group(w, items[0][1], cat_pairs, cat_mask)
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

    # 4: integrate forces
    bodies = integrate_forces(scene, state, dt32)

    # pair-major contact rows: (B, P, 4) points per pair, phases contiguous
    prepped = None
    contact_pairs = None
    contact_mask = None
    total_contacts = torch.zeros(B, dtype=torch.int32, device=dev)
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
        # dead pairs point at the dummy static body, so they do not count
        # in the per-body degrees of the averaged solve
        live = torch.any(cmask, dim=-1)
        body_a = torch.where(live, body_a, scene.num_bodies)
        body_b = torch.where(live, body_b, scene.num_bodies)
        sizes = tuple(phase_sizes[p] for p in sorted(phase_sizes))
        total_contacts = torch.sum(cmask.flatten(1), dim=-1,
                                   dtype=torch.int32)
        contact_mask = live
        contact_pairs = torch.cat([it[2] for it in selected], dim=1)
        prepped = prep_contacts(bodies, body_a, body_b, pts, nrm, dps, fric,
                                rest, cmask.to(pts.dtype), dt32,
                                phase_sizes=sizes)

    # 5: contact solve
    bodies, contact_imp_n = solve_constraints(
        bodies, prepped, settings.num_rigid_solver_iterations, mode,
        settings.sor_omega)

    # 6: integrate velocities
    new_state = integrate_velocities(scene, bodies, state, dt32)

    info = StepInfo(
        num_broadphase_overlaps=num_overlaps,
        num_contacts=total_contacts,
        broadphase_overflow=num_dropped,
        trigger_overlap=None,
        contact_pairs=contact_pairs,
        contact_mask=contact_mask,
        contact_impulse=(torch.sum(contact_imp_n, dim=-1)
                         if contact_imp_n is not None else None),
        validate_stage=None,
    )
    return new_state, info


def joint_inputs(scene, bodies, controls, dt32, prep_in_kernel):
    """What the fused step reads its joint rows from: the controls pack
    when the kernel preps the joints itself, else ops/solver.py's preps of
    the integrated `bodies`, each joint type packed into its table
    (batched_solver.pack_joint_type), in scene_joint_ab order."""
    if prep_in_kernel:
        return controls_pack(scene, controls, dt32)
    from dxk_tpu_torch.ops.kernels.batched_solver import (pack_joint_type,
                                                          scene_joint_types)
    from dxk_tpu_torch.ops.solver import prep_joints
    preps = prep_joints(scene, bodies, controls, dt32)
    return tuple(pack_joint_type(name, prep) for name, prep
                 in zip(scene_joint_types(scene), preps))


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


def _physics_step_fused(scene, state, settings, dt):
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
    bodies = integrate_forces(scene, state, float(dt32))
    joints = joint_inputs(scene, bodies, controls, dt32, jp_in_kernel)

    passed = terrain_inputs(scene, w, bodies, dt32)

    fused = make_fused_step_solver(
        scene, settings.num_rigid_solver_iterations, settings.sor_omega,
        sequential=sequential, joint_prep_in_kernel=jp_in_kernel)
    inv_dt = float(np.float32(1.0) / dt32)
    v_new, w_new, imp_n, point_mask = fused(bodies, w, joints, inv_dt,
                                            passed)
    live = point_mask != 0
    bodies = bodies.replace(v=v_new, w=w_new)

    new_state = integrate_velocities(scene, bodies, state, float(dt32))

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
        trigger_overlap=None,
        contact_pairs=contact_pairs,
        contact_mask=live,
        contact_impulse=torch.sum(imp_n, dim=-1),
        validate_stage=None,
    )
    return new_state, info


def apply_ray_impulse(scene: Scene, state: State, origin, direction,
                      strength=1000.0) -> State:
    """Cast one ray per env against all colliders owned by rigid bodies;
    apply `strength * direction` as a force (plus the induced torque) to the
    closest hit body's accumulators. origin, direction: (B, 3). The force
    persists until the next integration step."""
    from dxk_tpu_torch.ops import raycast as rc
    if scene.hulls is not None:
        raise NotImplementedError("ray casts against hulls are not ported")

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
