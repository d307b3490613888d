"""Grid cloth, batched over environments: the JAX package's ops/cloth.py
(position-based dynamics after the reference's cloth_component::simulate,
cloth.cpp:137-318): per-triangle wind, gravity and external forces,
velocity, position and drift passes over the distance constraints, an
optional push-out of particles with a thickness from every collider and
the heightfield (with two-way coupling: the momentum a particle loses goes
to the body it touches), then 1/(1+dt*damping) damping.

Particles are (B, P, 3). Two solve modes, as in the JAX package:
  "scan"     the reference's sequential sweep, exactly: a constraint's level
             is one past that of the last earlier constraint sharing a
             particle with it, so the constraints of one level touch
             distinct particles and every particle sees its updates in
             constraint order; one vectorised update a level (127 levels
             for the 746 constraints of a 12 x 12 grid, 79 for 306 at 8 x 8)
             instead of one a constraint;
  "colored"  Gauss-Seidel across the build-time greedy colour groups (the
             JAX package's visiting order), all of a group at once: the
             same fixed point as the sweep, another order.
Within a group no particle appears twice, so a group is a gather of its
endpoints and one index_add_ a side, exact and deterministic on the card.
The groups are built at finalize (scene.ClothParams), so no step reads the
device back.

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from dxk_tpu_torch.core.maths import (cross, dot, normalize, quat_conj,
                                      quat_rotate, sqrt)
from dxk_tpu_torch.scene.scene import (SHAPE_BOX, SHAPE_CAPSULE,
                                       SHAPE_CYLINDER, SHAPE_HULL,
                                       SHAPE_SPHERE, ClothParams, ClothState)

GRAVITY = -9.81
EPS = 1e-12

# the branches of the particle SDF, by the collider types each serves
SDF_BRANCHES = (("sphere", (SHAPE_SPHERE,)), ("capsule", (SHAPE_CAPSULE,)),
                ("cylinder", (SHAPE_CYLINDER,)), ("box", (SHAPE_BOX,)),
                ("hull", (SHAPE_HULL,)))


def collider_groups(ctype: np.ndarray, has_hulls: bool, device) -> tuple:
    """(branch, collider indices (C_k,) int64 on `device`) for each SDF
    branch some collider takes, from the host's collider types. Without
    hull geometry a hull type takes the box branch, as in the JAX
    package."""
    out = []
    for name, types in SDF_BRANCHES:
        if not has_hulls:
            types = {"box": (SHAPE_BOX, SHAPE_HULL), "hull": ()}.get(
                name, types)
        idx = np.flatnonzero(np.isin(ctype, types))
        if len(idx):
            out.append((name, torch.from_numpy(idx.astype(np.int64))
                        .to(device)))
    return tuple(out)


def _sdf_segment(pe, a, b_seg, r):
    """Sphere (b_seg = a) and capsule: distance to the segment minus r."""
    ab = b_seg - a
    ab_sq = torch.clamp(torch.sum(ab * ab, -1), min=EPS)
    t01 = torch.clamp(torch.sum((pe - a) * ab, -1) / ab_sq, 0.0, 1.0)
    seg = a + ab * t01[..., None]
    d_seg = pe - seg
    dist = sqrt(torch.clamp(torch.sum(d_seg * d_seg, -1), min=EPS))
    return dist - r, d_seg / dist[..., None]


def _sdf_cylinder(pe, a, b, r):
    """Radial / axial SDF with flat caps."""
    ab = b - a
    ab_sq = torch.clamp(torch.sum(ab * ab, -1), min=EPS)
    length = sqrt(ab_sq)
    u = ab / length[..., None]
    t_raw = torch.sum((pe - a) * u, -1)
    radial = (pe - a) - u * t_raw[..., None]
    rd = sqrt(torch.clamp(torch.sum(radial * radial, -1), min=EPS))
    dxx = rd - r                                       # radial excess
    dyy = torch.maximum(-t_raw, t_raw - length)        # axial excess
    out_x = torch.clamp(dxx, min=0.0)
    out_y = torch.clamp(dyy, min=0.0)
    sd = (torch.clamp(torch.maximum(dxx, dyy), max=0.0)
          + sqrt(out_x * out_x + out_y * out_y))
    rad_dir = radial / rd[..., None]
    cap_dir = u * torch.where(t_raw > 0.5 * length, 1.0, -1.0)[..., None]
    n_out = rad_dir * out_x[..., None] + cap_dir * out_y[..., None]
    n_out = n_out / sqrt(torch.clamp(
        torch.sum(n_out * n_out, -1, keepdim=True), min=EPS))
    n_in = torch.where((dxx > dyy)[..., None], rad_dir, cap_dir)
    return sd, torch.where((sd > 0.0)[..., None], n_out, n_in)


def _sdf_box(pl, b, q):
    """Local-frame box SDF, b = half extents."""
    qv = torch.abs(pl) - b
    m = torch.clamp(qv, min=0.0)
    od = sqrt(torch.clamp(torch.sum(m * m, -1), min=EPS))
    qmax = torch.amax(qv, -1)
    mi = torch.clamp(qmax, max=0.0)
    sd = torch.where(torch.all(qv <= 0.0, -1), mi, od)
    sgn = torch.where(pl >= 0.0, 1.0, -1.0)
    face = (qv >= qmax[..., None] - 1e-9).to(pl.dtype)
    nl = torch.where((sd > 0.0)[..., None], m * sgn / od[..., None],
                     normalize(face * sgn + 1e-30))
    return sd, quat_rotate(q, nl)


def _sdf_hull(pl, q, hulls, hid):
    """Max over the hull's face planes (exact inside and near faces, an
    underestimate in edge and vertex regions); masked faces -3.4e38."""
    fn = hulls.face_normals[hid][None, :, None]       # (1, Ck, 1, F, 3)
    fo = hulls.face_offsets[hid][None, :, None]       # (1, Ck, 1, F)
    fm = hulls.face_mask[hid][None, :, None]
    sd_f = torch.sum(fn * pl[..., None, :], -1) + fo
    sd_f = torch.where(fm, sd_f, -3.4e38)
    sd = torch.amax(sd_f, -1)
    best = (sd_f >= sd[..., None] - 1e-9).to(pl.dtype)
    return sd, quat_rotate(q, normalize(
        torch.sum(fn * best[..., None], -2) + 1e-30))


def _particle_collider_sdf(w, hulls, p, groups):
    """Signed distance and outward unit normal from every collider to every
    particle. w: the step's WorldColliders, p: (B, P, 3), groups:
    collider_groups(...). Returns sd (B, C, P) and n (B, C, P, 3).

    Exact SDFs for spheres, capsules, cylinders and boxes; hulls take the
    max over their face planes. Each branch runs on its own colliders."""
    B, P = p.shape[:2]
    C = w.a.shape[1]
    sd = torch.empty((B, C, P), dtype=p.dtype, device=p.device)
    n = torch.empty((B, C, P, 3), dtype=p.dtype, device=p.device)
    pe = p[:, None]                                   # (B, 1, P, 3)
    for name, idx in groups:
        a = w.a[:, idx, None]                         # (B, Ck, 1, 3)
        if name == "sphere":
            sd_k, n_k = _sdf_segment(pe, a, a, w.r[idx, None])
        elif name == "capsule":
            sd_k, n_k = _sdf_segment(pe, a, w.b[:, idx, None],
                                     w.r[idx, None])
        elif name == "cylinder":
            sd_k, n_k = _sdf_cylinder(pe, a, w.b[:, idx, None],
                                      w.r[idx, None])
        else:
            q = w.rot[:, idx, None]                   # (B, Ck, 1, 4)
            pl = quat_rotate(quat_conj(q), pe - a)    # the collider's frame
            if name == "box":
                sd_k, n_k = _sdf_box(pl, w.b[:, idx, None], q)
            else:
                hid = torch.clamp(w.hull_id[idx].long(), min=0)
                sd_k, n_k = _sdf_hull(pl, q, hulls, hid)
        sd.index_copy_(1, idx, sd_k)
        n.index_copy_(1, idx, n_k)
    return sd, n


def _gather_bodies(x, bi):
    """x (B, N+1, 3) at body indices bi (B, P) -> (B, P, 3)."""
    return torch.gather(x, 1, bi[..., None].expand(*bi.shape, 3))


def collide_particles(params: ClothParams, world, hulls, heightfield,
                      pos, vel, bodies=None, colbody=None):
    """Cloth-vs-rigid collision: project each particle with a thickness
    out of the deepest collider (the first on ties) or the heightfield,
    whichever is deeper, and remove its approaching normal velocity.

    One-way without `bodies`. With `bodies` (the step's SolverBodies) and
    `colbody` (collider -> body index) the normal velocity removed is
    measured relative to the body's surface point, and the momentum each
    particle gains goes to that body as an opposite impulse at the contact
    point. Returns (pos, vel) or (pos, vel, jsum, tsum), the per-body
    impulse and torque-impulse sums (B, N+1, 3) (static colliders and the
    heightfield charge the dummy body, whose inverse mass is 0)."""
    th = params.thickness
    free = params.inv_masses > 0.0
    B, P = pos.shape[:2]
    normal = torch.zeros_like(pos)
    depth = torch.zeros((B, P), dtype=pos.dtype, device=pos.device)
    ci = torch.zeros((B, P), dtype=torch.int64, device=pos.device)
    if world is not None and world.a.shape[1] > 0:
        sd, n = _particle_collider_sdf(world, hulls, pos,
                                       params.collider_groups)
        dep = th - sd                                 # (B, C, P)
        ci = torch.argmax(dep, dim=1)
        depth = torch.amax(dep, dim=1)
        normal = torch.gather(
            n, 1, ci[:, None, :, None].expand(B, 1, P, 3))[:, 0]

    use_h = torch.zeros((B, P), dtype=torch.bool, device=pos.device)
    if heightfield is not None:
        from dxk_tpu_torch.ops.heightmap import height_at
        hdep = th - (pos[..., 1] - height_at(heightfield, pos[..., 0],
                                             pos[..., 2]))
        up = torch.zeros_like(pos)
        up[..., 1] = 1.0
        use_h = hdep > depth
        depth = torch.where(use_h, hdep, depth)
        normal = torch.where(use_h[..., None], up, normal)

    hit = (depth > 0.0) & free
    push = torch.where(hit[..., None], normal * depth[..., None], 0.0)
    pos = pos + push

    if bodies is not None:
        nb_dummy = bodies.v.shape[1] - 1
        bi = colbody.long()[ci] if colbody is not None \
            else torch.full_like(ci, nb_dummy)
        bi = torch.where(use_h, nb_dummy, bi)
        r = pos - _gather_bodies(bodies.pos_cog, bi)
        vb = _gather_bodies(bodies.v, bi) + cross(
            _gather_bodies(bodies.w, bi), r)
    else:
        vb = 0.0

    vn = torch.sum(normal * (vel - vb), -1)
    rem = torch.where(hit, torch.clamp(vn, max=0.0), 0.0)
    vel = vel - normal * rem[..., None]

    if bodies is None:
        return pos, vel

    # impulse on the particle = m_p dv; the opposite on the body at `pos`
    m_p = torch.where(free, 1.0 / torch.clamp(params.inv_masses, min=1e-12),
                      0.0)
    j_body = (m_p * rem)[..., None] * normal          # = -J_particle
    bi3 = bi[..., None].expand(B, P, 3)
    jsum = torch.zeros_like(bodies.v).scatter_add_(1, bi3, j_body)
    tsum = torch.zeros_like(bodies.w).scatter_add_(1, bi3, cross(r, j_body))
    return pos, vel, jsum, tsum


def apply_wind_force(params: ClothParams, state: ClothState, force):
    """applyWindForce (cloth.cpp:137-172): each grid quad's two triangles
    push 1/3 of the normal-projected `force` (3,) onto their vertices."""
    tris = params.triangles.long()
    p = state.positions
    a, b, c = p[:, tris[:, 0]], p[:, tris[:, 1]], p[:, tris[:, 2]]
    normal = cross(b - a, c - a)
    f = normal * dot(normalize(normal + 1e-30), force)[..., None] \
        * (1.0 / 3.0)
    forces = state.forces.clone()
    for k in range(3):
        forces.index_add_(1, tris[:, k], f)
    return state.replace(forces=forces)


def _solve_positions(params, positions, groups):
    """solvePositions (cloth.cpp:300-318) over `groups` of constraints in
    turn, all of a group's constraints at once: no particle is in a group
    twice, so a group is one gather of its endpoints and one index_add_ a
    side. groups: ClothParams.scan_levels ("scan") or .color_index
    ("colored")."""
    inv_mass = params.inv_masses
    pos = positions.clone()
    for idx, ia, ib in groups:
        rest_sq = params.rest_lengths[idx] ** 2
        ims = params.inv_mass_sums[idx]
        delta = pos[:, ib] - pos[:, ia]                # (B, M, 3)
        ln = torch.sum(delta * delta, -1)
        active = (ims > 0.0) & (rest_sq + ln > 1e-5)
        k = torch.where(active, (rest_sq - ln) / torch.clamp(
            ims * (rest_sq + ln), min=1e-30), 0.0)
        pos.index_add_(1, ia, -delta * (k * inv_mass[ia])[..., None])
        pos.index_add_(1, ib, delta * (k * inv_mass[ib])[..., None])
    return pos


def _solve_velocities(params, velocities, gradients, inv_scaled_grad_sq,
                      groups):
    """solveVelocities (cloth.cpp:288-298) over `groups` (see
    _solve_positions); gradients (B, K, 3), inv_scaled_grad_sq (B, K)."""
    inv_mass = params.inv_masses
    vel = velocities.clone()
    for idx, ia, ib in groups:
        g = gradients[:, idx]                          # (B, M, 3)
        j = -torch.sum(g * (vel[:, ia] - vel[:, ib]), -1) \
            * inv_scaled_grad_sq[:, idx]
        vel.index_add_(1, ia, g * (j * inv_mass[ia])[..., None])
        vel.index_add_(1, ib, -g * (j * inv_mass[ib])[..., None])
    return vel


def cloth_step(params: ClothParams, state: ClothState, settings,
               wind_force, dt, world=None, hulls=None,
               heightfield=None, bodies=None, colbody=None):
    """simulate (cloth.cpp:180-286) and, for particles with a thickness,
    the push-out of collide_particles. `dt` is a float32 value (the
    caller's step, rounded to float32 as physics_step does).

    Returns (ClothState, impulses): impulses is None, or, with
    `bodies` / `colbody` given (two-way coupling), the (jsum, tsum) pair
    of per-body impulse and torque-impulse sums the caller applies to the
    rigid velocities."""
    state = apply_wind_force(params, state, wind_force)

    dt32 = np.float32(dt)
    inv_mass = params.inv_masses
    gravity_v = float(np.float32(GRAVITY) * dt32) * params.gravity_factor

    vel = state.velocities.clone()
    vel[..., 1] += torch.where(inv_mass > 0.0, gravity_v, 0.0)
    vel = vel + state.forces * (inv_mass * float(dt32))[:, None]
    prev = state.positions
    pos = prev + vel * float(dt32)

    inv_dt = float(np.float32(1.0) / dt32) if dt32 > 1e-5 else 1.0

    mode = settings.cloth_solver_mode
    if mode not in ("scan", "colored"):
        raise ValueError(f"unknown cloth_solver_mode {mode!r}")
    groups = params.color_index if mode == "colored" else params.scan_levels

    if settings.num_cloth_velocity_iterations > 0:
        cons = params.constraints.long()
        grad = prev[:, cons[:, 1]] - prev[:, cons[:, 0]]     # (B, K, 3)
        denom = torch.sum(grad * grad, -1) * params.inv_mass_sums
        inv_sgsq = torch.where(params.inv_mass_sums == 0.0, 0.0,
                               1.0 / torch.clamp(denom, min=1e-30))
        for _ in range(settings.num_cloth_velocity_iterations):
            vel = _solve_velocities(params, vel, grad, inv_sgsq, groups)
        pos = prev + vel * float(dt32)

    if settings.num_cloth_position_iterations > 0:
        for _ in range(settings.num_cloth_position_iterations):
            pos = _solve_positions(params, pos, groups)
        vel = (pos - prev) * inv_dt

    if settings.num_cloth_drift_iterations > 0:
        drift_prev = pos
        for _ in range(settings.num_cloth_drift_iterations):
            pos = _solve_positions(params, pos, groups)
        vel = vel + (pos - drift_prev) * inv_dt

    impulses = None
    if params.collides and (world is not None or heightfield is not None):
        out = collide_particles(params, world, hulls, heightfield,
                                pos, vel, bodies=bodies, colbody=colbody)
        if bodies is not None:
            pos, vel, jsum, tsum = out
            impulses = (jsum, tsum)
        else:
            pos, vel = out

    vel = vel * (1.0 / (1.0 + float(dt32) * params.damping))[:, None]
    return ClothState(positions=pos, prev_positions=prev, velocities=vel,
                      forces=torch.zeros_like(state.forces)), impulses
