"""Constraint prep and the iterated constraint solve of the reference
(non-fused) step, batched over environments: the port's counterpart of the
JAX package's ops/solver.py.

Seven constraint types (distance, ball, fixed, hinge, cone-twist, slider,
contacts), each with a prep (effective masses, biases, limit and motor
activation computed once a step from the integrated bodies) and a solve of
one constraint, run for N iterations in the reference's type order. Three
modes, as there:

  - "scan": sequential impulses, constraint by constraint in order, each
    reading the body velocities its predecessor wrote (`_gs_pass`,
    `_contact_gs_pass`). The reference's exact semantics; the goldens are
    this mode. A pair's body indices differ per env after compaction, so a
    contact row gathers and writes with (B,) index tensors.
  - "jacobi": within each joint type all joints solve against the same
    velocities and per-body deltas are summed by `index_add_` and scaled by
    1/degree (`_jacobi_pass`).
  - "colored": joints in their build-time colours, colour after colour,
    each colour conflict-free (`_colored_pass`).

Contacts in "jacobi" and "colored" take the phased pass: pair-major rows
with their <= 4 points, static contact-phase slices in order, all rows of
a slice against the same velocities, deltas degree-averaged within the
slice (`_contact_phased_pass`).

Every prep field carries the env batch as its leading dimension ((B, J,
...); the joints' static parameters and body indices are (J, ...)). The
fused step's `fused_seq` mode and its `joint_prep_in_kernel=False` option
pack the joint preps into its joint tables (batched_solver.pack_joint_type).
3x3 products are written as broadcast-multiply-sums, never as matmuls, so
no float32 product on the card can run in TF32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from dxk_tpu_torch.core import fastmath as fm
from dxk_tpu_torch.core.maths import (const, cross, dot, get_tangents,
                                      length, noz, quat_conj,
                                      quat_from_axis_angle, quat_mul,
                                      quat_rotate, rotate_from_to, skew,
                                      solve_2x2, solve_3x3, sqrt,
                                      squared_length)
from dxk_tpu_torch.ops.integrator import SolverBodies, _mat3_mul
from dxk_tpu_torch.ops.kernels.cm_narrowphase import _clip

DISTANCE_BETA = 0.1
BALL_BETA = 0.1
SLIDER_BETA = 0.1
HINGE_ROTATION_BETA = 0.3
HINGE_LIMIT_BETA = 0.1
TWIST_LIMIT_BETA = 0.1
SLIDER_LIMIT_BETA = 0.1
DT_THRESHOLD = 1e-5


def _inv_or_zero(x):
    return torch.where(x != 0.0, 1.0 / torch.where(x != 0.0, x, 1.0), 0.0)


def _mat_vec(m, v):
    return torch.sum(m * v[..., None, :], dim=-1)


def _rows(table, idx):
    """table (B, N, ...), idx (B, P) -> (B, P, ...)."""
    ar = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[ar, idx]


@dataclass
class ContactPrep:
    """Per-pair manifold prep: B envs x P pairs x up to 4 points.
    `phase_sizes` are static, contiguous slice sizes over the pair axis."""

    body_a: torch.Tensor        # (B, P) int64
    body_b: torch.Tensor        # (B, P)
    inv_ma: torch.Tensor        # (B, P)
    inv_mb: torch.Tensor        # (B, P)
    rel_a: torch.Tensor         # (B, P, 4, 3)
    rel_b: torch.Tensor         # (B, P, 4, 3)
    normal: torch.Tensor        # (B, P, 4, 3)
    tangent: torch.Tensor       # (B, P, 4, 3)
    eff_mass_n: torch.Tensor    # (B, P, 4)
    eff_mass_t: torch.Tensor    # (B, P, 4)
    bias: torch.Tensor          # (B, P, 4)
    friction: torch.Tensor      # (B, P, 4)
    n_to_wa: torch.Tensor       # (B, P, 4, 3)
    n_to_wb: torch.Tensor
    t_to_wa: torch.Tensor
    t_to_wb: torch.Tensor
    phase_sizes: tuple = ()

    def slice(self, start, size):
        return ContactPrep(**{
            f.name: (getattr(self, f.name)[:, start:start + size]
                     if f.name != "phase_sizes" else ())
            for f in fields(self)})


def prep_contacts(bodies: SolverBodies, body_a, body_b, point, normal, depth,
                  friction, restitution, mask, dt,
                  phase_sizes=()) -> ContactPrep:
    """body_a/body_b/friction/restitution: (B, P); point/normal:
    (B, P, 4, 3); depth/mask: (B, P, 4). Masked points get zero effective
    mass (zero impulses); fully dead pairs should already point at the dummy
    body so they do not inflate per-body degrees."""
    inv_dt = float(np.float32(1.0) / np.float32(dt))
    pa = _rows(bodies.pos_cog, body_a)
    pb = _rows(bodies.pos_cog, body_b)
    rel_a = point - pa[:, :, None, :]
    rel_b = point - pb[:, :, None, :]

    bva = _rows(bodies.v, body_a)[:, :, None, :]
    bwa = _rows(bodies.w, body_a)[:, :, None, :]
    bvb = _rows(bodies.v, body_b)[:, :, None, :]
    bwb = _rows(bodies.w, body_b)[:, :, None, :]
    va = bva + cross(bwa, rel_a)
    vb = bvb + cross(bwb, rel_b)
    rel_v = vb - va
    tangent = noz(rel_v - dot(normal, rel_v)[..., None] * normal)

    inv_ia = _rows(bodies.inv_inertia, body_a)[:, :, None]
    inv_ib = _rows(bodies.inv_inertia, body_b)[:, :, None]
    inv_ma = bodies.inv_mass[body_a]
    inv_mb = bodies.inv_mass[body_b]
    inv_m_sum = (inv_ma + inv_mb)[..., None]

    cr_at = cross(rel_a, tangent)
    cr_bt = cross(rel_b, tangent)
    im_t = (inv_m_sum + dot(cr_at, _mat_vec(inv_ia, cr_at))
            + dot(cr_bt, _mat_vec(inv_ib, cr_bt)))
    eff_t = _inv_or_zero(im_t) * mask

    cr_an = cross(rel_a, normal)
    cr_bn = cross(rel_b, normal)
    im_n = (inv_m_sum + dot(cr_an, _mat_vec(inv_ia, cr_an))
            + dot(cr_bn, _mat_vec(inv_ib, cr_bn)))
    eff_n = _inv_or_zero(im_n) * mask

    # restitution + Baumgarte bias with slop
    v_rel_n = dot(normal, rel_v)
    slop = -0.001
    active = (-depth < slop) & (v_rel_n < 0.0)
    bias = torch.where(active, -restitution[..., None] * v_rel_n
                       - 0.1 * (-depth - slop) * inv_dt, 0.0)
    if not float(dt) > DT_THRESHOLD:
        bias = torch.zeros_like(bias)

    return ContactPrep(
        body_a=body_a, body_b=body_b, inv_ma=inv_ma, inv_mb=inv_mb,
        rel_a=rel_a, rel_b=rel_b,
        normal=normal, tangent=tangent, eff_mass_n=eff_n, eff_mass_t=eff_t,
        bias=bias, friction=friction[..., None] * mask,
        n_to_wa=_mat_vec(inv_ia, cr_an), n_to_wb=_mat_vec(inv_ib, cr_bn),
        t_to_wa=_mat_vec(inv_ia, cr_at), t_to_wb=_mat_vec(inv_ib, cr_bt),
        phase_sizes=tuple(phase_sizes))


class _PointView:
    """Point-k view over pair-major ContactPrep fields."""

    __slots__ = ("rel_a", "rel_b", "normal", "tangent", "eff_mass_n",
                 "eff_mass_t", "bias", "friction", "n_to_wa", "n_to_wb",
                 "t_to_wa", "t_to_wb")

    def __init__(self, c, k):
        for f in self.__slots__:
            x = getattr(c, f)
            setattr(self, f, x[..., k, :] if x.dim() > c.bias.dim()
                    else x[..., k])


def _contact_solve_point(ck, inv_ma, inv_mb, va, wa, vb, wb, imp_n, imp_t):
    """One contact point: friction, then normal."""
    # tangent
    av = va + cross(wa, ck.rel_a)
    bv = vb + cross(wb, ck.rel_b)
    vt = dot(bv - av, ck.tangent)
    lam = -ck.eff_mass_t * vt
    max_f = ck.friction * imp_n
    new_imp = torch.clamp(imp_t + lam, -max_f, max_f)
    lam = new_imp - imp_t
    imp_t = new_imp
    P = lam[..., None] * ck.tangent
    va = va - inv_ma[..., None] * P
    wa = wa - ck.t_to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + ck.t_to_wb * lam[..., None]

    # normal
    av = va + cross(wa, ck.rel_a)
    bv = vb + cross(wb, ck.rel_b)
    vn = dot(bv - av, ck.normal)
    lam = -ck.eff_mass_n * (vn - ck.bias)
    new_imp = torch.clamp(imp_n + lam, min=0.0)
    lam = new_imp - imp_n
    imp_n = new_imp
    P = lam[..., None] * ck.normal
    va = va - inv_ma[..., None] * P
    wa = wa - ck.n_to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + ck.n_to_wb * lam[..., None]
    return va, wa, vb, wb, imp_n, imp_t


def _contact_solve_one(points, inv_ma, inv_mb, va, wa, vb, wb, imp_n,
                       imp_t):
    """One pair: its <= 4 points (`_PointView`s) solved in order against the
    pair's gathered velocities. imp_n/imp_t: (..., 4)."""
    imp_n_out = []
    imp_t_out = []
    for k, ck in enumerate(points):
        va, wa, vb, wb, ik_n, ik_t = _contact_solve_point(
            ck, inv_ma, inv_mb, va, wa, vb, wb, imp_n[..., k], imp_t[..., k])
        imp_n_out.append(ik_n)
        imp_t_out.append(ik_t)
    return (va, wa, vb, wb, torch.stack(imp_n_out, -1),
            torch.stack(imp_t_out, -1))


def _phase_slices(prep):
    """Static (start, size) slices over the pair axis; a single full slice
    when the scene was built without contact phases."""
    sizes = prep.phase_sizes or (prep.body_a.shape[1],)
    starts, s = [], 0
    for sz in sizes:
        starts.append(s)
        s += sz
    return tuple(zip(starts, sizes))


def _flat_index(idx, num_rows):
    """(B, P) row indices -> indices into the (B * num_rows) flattened
    body axis."""
    off = torch.arange(idx.shape[0], device=idx.device)[:, None] * num_rows
    return (idx + off).reshape(-1)


def contact_phase_inv_degrees(prep: ContactPrep, num_rows: int):
    """1/degree per body per phase slice, (B, num_rows) each, where degree
    counts the pairs of that slice touching the body. Constant across
    solver iterations. Dead pairs must already point at the dummy row."""
    out = []
    B = prep.body_a.shape[0]
    for st, size in _phase_slices(prep):
        a = _flat_index(prep.body_a[:, st:st + size], num_rows)
        b = _flat_index(prep.body_b[:, st:st + size], num_rows)
        ones = torch.ones(a.shape[0], dtype=torch.float32,
                          device=a.device)
        deg = torch.zeros(B * num_rows, dtype=torch.float32, device=a.device)
        deg.index_add_(0, a, ones)
        deg.index_add_(0, b, ones)
        out.append((1.0 / torch.clamp(deg, min=1.0)).view(B, num_rows))
    return tuple(out)


def _phase_views(prep: ContactPrep, num_rows: int):
    """Per non-empty phase slice: (start, size, slice index, sliced prep,
    its point views, flat body indices of its a and b sides). Constant
    across solver iterations."""
    out = []
    for si, (st, size) in enumerate(_phase_slices(prep)):
        if size == 0:
            continue
        c = prep.slice(st, size)
        out.append((st, size, si, c,
                    [_PointView(c, k) for k in range(c.bias.shape[-1])],
                    _flat_index(c.body_a, num_rows),
                    _flat_index(c.body_b, num_rows)))
    return out


def _contact_phased_pass(views, v, w, accs, inv_deg_phases, omega=1.0):
    """One solver iteration over pair-major contacts (`views` from
    `_phase_views`): static phase slices in order; within a slice all pairs
    solve against the same velocities and per-body deltas are
    degree-averaged. Velocities are carried as one (B, N, 6) [v|w] array."""
    imp_n, imp_t = accs                                   # (B, P, 4)
    B, n = v.shape[0], v.shape[1]
    vw = torch.cat([v, w], dim=-1)
    imp_n_parts, imp_t_parts = [], []
    for st, size, si, c, points, fa, fb in views:
        ga = _rows(vw, c.body_a)
        gb = _rows(vw, c.body_b)
        va, wa = ga[..., :3], ga[..., 3:]
        vb, wb = gb[..., :3], gb[..., 3:]
        nva, nwa, nvb, nwb, ni, nt = _contact_solve_one(
            points, c.inv_ma, c.inv_mb, va, wa, vb, wb,
            imp_n[:, st:st + size], imp_t[:, st:st + size])
        imp_n_parts.append(ni)
        imp_t_parts.append(nt)
        da = torch.cat([nva - va, nwa - wa], dim=-1)
        db = torch.cat([nvb - vb, nwb - wb], dim=-1)
        delta = torch.zeros((B * n, 6), dtype=vw.dtype, device=vw.device)
        delta.index_add_(0, fa, da.reshape(-1, 6))
        delta.index_add_(0, fb, db.reshape(-1, 6))
        vw = vw + delta.view(B, n, 6) * (omega * inv_deg_phases[si])[..., None]
    if imp_n_parts:
        imp_n = torch.cat(imp_n_parts, dim=1)
        imp_t = torch.cat(imp_t_parts, dim=1)
    return vw[..., :3], vw[..., 3:], (imp_n, imp_t)


# ===========================================================================
# Joint preps (constraints.cpp:189-2845). Every function takes the
# integrated bodies, the joints of one type and, for the motorised types,
# the batched motor controls ((B, J) fields); dt is the float32 step.


def _get_axis_rotation_fm(q):
    """maths.get_axis_rotation with fastmath.acos (shared with the fused
    kernel's in-kernel joint prep)."""
    v = q[..., :3]
    sq = squared_length(v)
    ok = sq > 0.0
    angle = torch.where(ok, 2.0 * fm.acos(torch.clamp(q[..., 3], -1.0, 1.0)),
                        0.0)
    inv_len = torch.where(ok, 1.0 / sqrt(torch.where(ok, sq, 1.0)), 0.0)
    axis = torch.where(ok[..., None], v * inv_len[..., None],
                       const((1.0, 0.0, 0.0), q))
    return axis, angle


def _point_inv_effective_mass(inv_ia, inv_ib, inv_ma, inv_mb, ra, rb):
    """skewA * invIA * skewA^T + skewB * invIB * skewB^T + I*(ma+mb)
    (constraints.cpp:487-492)."""
    sa = skew(ra)
    sb = skew(rb)
    m = (_mat3_mul(_mat3_mul(sa, inv_ia), sa.transpose(-1, -2))
         + _mat3_mul(_mat3_mul(sb, inv_ib), sb.transpose(-1, -2)))
    eye = torch.eye(3, dtype=ra.dtype, device=ra.device)
    return m + eye * (inv_ma + inv_mb)[..., None, None]


class _Step:
    """dt of one step as the JAX package reads it: float32 dt and 1/dt,
    Baumgarte gains beta/dt rounded once to float32, and whether dt is
    above the degenerate-step guard."""

    def __init__(self, dt):
        self.dt = np.float32(dt)
        self.inv_dt = np.float32(1.0) / self.dt
        self.ok = bool(self.dt > DT_THRESHOLD)

    def gain(self, beta, scale=1.0):
        return float(np.float32(beta) * self.inv_dt * np.float32(scale))

    def gate(self, x):
        """x where dt passes the guard, else zeros."""
        return x if self.ok else torch.zeros_like(x)


def _joint_bodies(bodies: SolverBodies, j):
    """Per-joint gathers of both bodies: rotations, anchors relative to the
    centres of mass (rel_a/rel_b), world anchors, inverse inertias and
    inverse masses."""
    a, b = j.body_a.long(), j.body_b.long()
    rot_a, rot_b = bodies.rot[:, a], bodies.rot[:, b]
    rel_a = quat_rotate(rot_a, j.local_anchor_a - bodies.local_cog[a])
    rel_b = quat_rotate(rot_b, j.local_anchor_b - bodies.local_cog[b])
    ga = bodies.pos_cog[:, a] + rel_a
    gb = bodies.pos_cog[:, b] + rel_b
    return dict(a=a, b=b, rot_a=rot_a, rot_b=rot_b, rel_a=rel_a,
                rel_b=rel_b, ga=ga, gb=gb,
                inv_ia=bodies.inv_inertia[:, a],
                inv_ib=bodies.inv_inertia[:, b],
                inv_ma=bodies.inv_mass[a], inv_mb=bodies.inv_mass[b])


def _stack2(m00, m01, m10, m11):
    return torch.stack([torch.stack([m00, m01], -1),
                        torch.stack([m10, m11], -1)], -2)


def _rotation_error_bias(jb, j, st):
    """Vector part of q_b * initial_inv_rotation_difference * conj(q_a) as
    a Baumgarte bias (fixed and slider joints)."""
    rot_err = quat_mul(quat_mul(jb["rot_b"], j.initial_inv_rotation_difference),
                       quat_conj(jb["rot_a"]))
    return st.gate(rot_err[..., :3] * st.gain(SLIDER_BETA, 2.0))


@dataclass
class DistancePrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    rel_a: torch.Tensor
    rel_b: torch.Tensor
    u: torch.Tensor
    bias: torch.Tensor
    eff_mass: torch.Tensor
    to_wa: torch.Tensor
    to_wb: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def prep_distance(bodies: SolverBodies, j, dt) -> DistancePrep:
    """constraints.cpp:189-243 with the corrected torque arm
    invInertia * (relAnchor x u) of the JAX package (its solver.py
    explains why the reference's double cross is not copied)."""
    st = _Step(dt)
    jb = _joint_bodies(bodies, j)
    rel_a, rel_b = jb["rel_a"], jb["rel_b"]
    u = jb["gb"] - jb["ga"]
    l = length(u)
    u = torch.where((l > 0.001)[..., None],
                    u / torch.clamp(l, min=1e-12)[..., None], 0.0)
    cr_a = cross(rel_a, u)
    cr_b = cross(rel_b, u)
    inv_ia, inv_ib = jb["inv_ia"], jb["inv_ib"]
    im = (jb["inv_ma"] + dot(cr_a, _mat_vec(inv_ia, cr_a))
          + jb["inv_mb"] + dot(cr_b, _mat_vec(inv_ib, cr_b)))
    bias = st.gate((l - j.length) * st.gain(DISTANCE_BETA))
    return DistancePrep(
        body_a=jb["a"], body_b=jb["b"], color=j.color,
        num_colors=j.num_colors, rel_a=rel_a, rel_b=rel_b, u=u,
        bias=bias, eff_mass=_inv_or_zero(im),
        to_wa=_mat_vec(inv_ia, cr_a), to_wb=_mat_vec(inv_ib, cr_b))


@dataclass
class BallPrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    rel_a: torch.Tensor
    rel_b: torch.Tensor
    bias: torch.Tensor
    inv_eff_mass: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def prep_ball(bodies: SolverBodies, j, dt) -> BallPrep:
    """constraints.cpp:460-507."""
    st = _Step(dt)
    jb = _joint_bodies(bodies, j)
    m = _point_inv_effective_mass(jb["inv_ia"], jb["inv_ib"], jb["inv_ma"],
                                  jb["inv_mb"], jb["rel_a"], jb["rel_b"])
    bias = st.gate((jb["gb"] - jb["ga"]) * st.gain(BALL_BETA))
    return BallPrep(body_a=jb["a"], body_b=jb["b"], color=j.color,
                    num_colors=j.num_colors, rel_a=jb["rel_a"],
                    rel_b=jb["rel_b"], bias=bias, inv_eff_mass=m)


@dataclass
class FixedPrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    rel_a: torch.Tensor
    rel_b: torch.Tensor
    translation_bias: torch.Tensor
    inv_eff_trans_mass: torch.Tensor
    rotation_bias: torch.Tensor
    inv_eff_rot_mass: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def prep_fixed(bodies: SolverBodies, j, dt) -> FixedPrep:
    """constraints.cpp:736-786."""
    st = _Step(dt)
    jb = _joint_bodies(bodies, j)
    inv_ia, inv_ib = jb["inv_ia"], jb["inv_ib"]
    mt = _point_inv_effective_mass(inv_ia, inv_ib, jb["inv_ma"], jb["inv_mb"],
                                   jb["rel_a"], jb["rel_b"])
    return FixedPrep(
        body_a=jb["a"], body_b=jb["b"], color=j.color,
        num_colors=j.num_colors, rel_a=jb["rel_a"], rel_b=jb["rel_b"],
        translation_bias=st.gate((jb["gb"] - jb["ga"]) * st.gain(BALL_BETA)),
        inv_eff_trans_mass=mt,
        rotation_bias=_rotation_error_bias(jb, j, st),
        inv_eff_rot_mass=inv_ia + inv_ib)


@dataclass
class HingePrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    rel_a: torch.Tensor
    rel_b: torch.Tensor
    translation_bias: torch.Tensor
    inv_eff_trans_mass: torch.Tensor
    rotation_bias: torch.Tensor          # (B, J, 2)
    inv_eff_rot_mass: torch.Tensor       # (B, J, 2, 2)
    bxa: torch.Tensor
    cxa: torch.Tensor
    axis: torch.Tensor                   # global rotation axis
    eff_axial_mass: torch.Tensor
    solve_limit: torch.Tensor            # bool
    solve_motor: torch.Tensor            # bool
    limit_sign: torch.Tensor
    limit_bias: torch.Tensor
    motor_velocity: torch.Tensor
    max_motor_impulse: torch.Tensor
    ml_to_wa: torch.Tensor               # motorAndLimitImpulseToAngularVelocity
    ml_to_wb: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def prep_hinge(bodies: SolverBodies, j, controls, dt) -> HingePrep:
    """constraints.cpp:1079-1213."""
    st = _Step(dt)
    jb = _joint_bodies(bodies, j)
    rot_a, rot_b = jb["rot_a"], jb["rot_b"]
    inv_ia, inv_ib = jb["inv_ia"], jb["inv_ib"]
    mt = _point_inv_effective_mass(inv_ia, inv_ib, jb["inv_ma"], jb["inv_mb"],
                                   jb["rel_a"], jb["rel_b"])
    t_bias = st.gate((jb["gb"] - jb["ga"]) * st.gain(BALL_BETA))

    axis_a = quat_rotate(rot_a, j.local_axis_a)
    axis_b = quat_rotate(rot_b, j.local_axis_b)
    tan_b, bitan_b = get_tangents(axis_b)
    bxa = cross(tan_b, axis_a)
    cxa = cross(bitan_b, axis_a)
    ia_bxa = _mat_vec(inv_ia, bxa)
    ib_bxa = _mat_vec(inv_ib, bxa)
    ia_cxa = _mat_vec(inv_ia, cxa)
    ib_cxa = _mat_vec(inv_ib, cxa)
    mr = _stack2(dot(bxa, ia_bxa) + dot(bxa, ib_bxa),
                 dot(bxa, ia_cxa) + dot(bxa, ib_cxa),
                 dot(cxa, ia_bxa) + dot(cxa, ib_bxa),
                 dot(cxa, ia_cxa) + dot(cxa, ib_cxa))
    r_bias = st.gate(torch.stack([dot(axis_a, tan_b), dot(axis_a, bitan_b)],
                                 -1) * st.gain(HINGE_ROTATION_BETA))

    # limits & motor (constraints.cpp:1155-1205); fastmath.atan2, as the
    # fused kernel's in-kernel prep computes the same angle
    compare_a = quat_rotate(quat_conj(rot_a),
                            quat_rotate(rot_b, j.local_tangent_b))
    angle = fm.atan2(dot(compare_a, j.local_bitangent_a),
                     dot(compare_a, j.local_tangent_a))
    min_violated = (j.limit_min <= 0.0) & (angle <= j.limit_min)
    max_violated = (j.limit_max >= 0.0) & (angle >= j.limit_max)
    max_torque = controls.hinge_max_torque
    im_ax = (dot(axis_a, _mat_vec(inv_ia, axis_a))
             + dot(axis_a, _mat_vec(inv_ib, axis_a)))

    # position motor: reach the target angle in one frame, clamped later
    # (constraints.cpp:1189-1197)
    min_l = torch.where(j.limit_min <= 0.0, j.limit_min, -np.pi)
    max_l = torch.where(j.limit_max >= 0.0, j.limit_max, np.pi)
    target = _clip(controls.hinge_target, min_l, max_l)
    pos_motor_vel = st.gate((target - angle) * float(st.inv_dt))
    motor_vel = torch.where(controls.hinge_motor_type == 1, pos_motor_vel,
                            controls.hinge_target)
    d = torch.where(min_violated, angle - j.limit_min, j.limit_max - angle)
    return HingePrep(
        body_a=jb["a"], body_b=jb["b"], color=j.color,
        num_colors=j.num_colors, rel_a=jb["rel_a"], rel_b=jb["rel_b"],
        translation_bias=t_bias, inv_eff_trans_mass=mt,
        rotation_bias=r_bias, inv_eff_rot_mass=mr, bxa=bxa, cxa=cxa,
        axis=axis_a, eff_axial_mass=_inv_or_zero(im_ax),
        solve_limit=min_violated | max_violated,
        solve_motor=max_torque > 0.0,
        limit_sign=torch.where(min_violated, 1.0, -1.0),
        limit_bias=st.gate(d * HINGE_LIMIT_BETA * float(st.inv_dt)),
        motor_velocity=motor_vel,
        max_motor_impulse=torch.clamp(max_torque, min=0.0) * float(st.dt),
        ml_to_wa=_mat_vec(inv_ia, axis_a), ml_to_wb=_mat_vec(inv_ib, axis_a))


@dataclass
class ConeTwistPrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    rel_a: torch.Tensor
    rel_b: torch.Tensor
    bias: torch.Tensor
    inv_eff_mass: torch.Tensor
    # swing limit
    solve_swing_limit: torch.Tensor
    swing_axis: torch.Tensor
    eff_swing_limit_mass: torch.Tensor
    swing_limit_bias: torch.Tensor
    sl_to_wa: torch.Tensor
    sl_to_wb: torch.Tensor
    # twist limit
    solve_twist_limit: torch.Tensor
    twist_axis: torch.Tensor
    eff_twist_mass: torch.Tensor
    twist_limit_sign: torch.Tensor
    twist_limit_bias: torch.Tensor
    tw_to_wa: torch.Tensor
    tw_to_wb: torch.Tensor
    # swing motor
    solve_swing_motor: torch.Tensor
    swing_motor_axis: torch.Tensor
    eff_swing_motor_mass: torch.Tensor
    swing_motor_velocity: torch.Tensor
    max_swing_motor_impulse: torch.Tensor
    sm_to_wa: torch.Tensor
    sm_to_wb: torch.Tensor
    # twist motor
    solve_twist_motor: torch.Tensor
    twist_motor_velocity: torch.Tensor
    max_twist_motor_impulse: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def _axial_mass(axis, inv_ia, inv_ib):
    return _inv_or_zero(dot(axis, _mat_vec(inv_ia, axis))
                        + dot(axis, _mat_vec(inv_ib, axis)))


def prep_cone_twist(bodies: SolverBodies, j, controls, dt) -> ConeTwistPrep:
    """constraints.cpp:1782-1946. The swing limit is stored in limit_min,
    the twist limit in limit_max."""
    st = _Step(dt)
    inv_dt = float(st.inv_dt)
    jb = _joint_bodies(bodies, j)
    rot_a, rot_b = jb["rot_a"], jb["rot_b"]
    inv_ia, inv_ib = jb["inv_ia"], jb["inv_ib"]
    m = _point_inv_effective_mass(inv_ia, inv_ib, jb["inv_ma"], jb["inv_mb"],
                                  jb["rel_a"], jb["rel_b"])
    bias = st.gate((jb["gb"] - jb["ga"]) * st.gain(BALL_BETA))

    # relative rotation decomposition (constraints.cpp:1823-1846)
    btoa = quat_mul(quat_conj(rot_a), rot_b)
    axis_compare = quat_rotate(btoa, j.local_axis_b)
    swing_rotation = rotate_from_to(j.local_axis_a.expand_as(axis_compare),
                                    axis_compare)
    twist_tan_a = quat_rotate(swing_rotation, j.local_tangent_a)
    twist_bitan_a = quat_rotate(swing_rotation, j.local_bitangent_a)
    tan_compare = quat_rotate(btoa, j.local_tangent_b)
    twist_angle = fm.atan2(dot(tan_compare, twist_bitan_a),
                           dot(tan_compare, twist_tan_a))
    swing_axis_l, swing_angle = _get_axis_rotation_fm(swing_rotation)
    neg = swing_angle < 0.0
    swing_angle = torch.where(neg, -swing_angle, swing_angle)
    swing_axis_l = torch.where(neg[..., None], -swing_axis_l, swing_axis_l)
    swing_limit, twist_limit = j.limit_min, j.limit_max

    # swing limit (1848-1865)
    swing_axis = quat_rotate(rot_a, swing_axis_l)
    swing_limit_bias = st.gate((swing_limit - swing_angle)
                               * st.gain(HINGE_LIMIT_BETA))

    # swing motor (1867-1905): velocity motor about a tangent-plane axis,
    # or position motor toward the target direction
    ax_x = torch.cos(controls.ct_swing_axis_angle)
    ax_y = torch.sin(controls.ct_swing_axis_angle)
    local_sm_axis = (ax_x[..., None] * j.local_tangent_a
                     + ax_y[..., None] * j.local_bitangent_a)
    sm_axis_vel = quat_rotate(rot_a, local_sm_axis)
    target_angle = torch.where(
        swing_limit >= 0.0,
        _clip(controls.ct_swing_target, -swing_limit, swing_limit),
        controls.ct_swing_target)
    local_target_dir = quat_rotate(
        quat_from_axis_angle(local_sm_axis, target_angle), j.local_axis_a)
    local_sm_axis_pos = noz(cross(axis_compare, local_target_dir))
    sm_axis_pos = quat_rotate(rot_a, local_sm_axis_pos)
    cos_angle = dot(local_target_dir, axis_compare)
    delta_angle = fm.acos(torch.clamp(cos_angle, 0.0, 1.0))
    sm_vel_p = st.gate(delta_angle * inv_dt * 0.2)
    is_pos = controls.ct_swing_motor_type == 1
    sm_axis = torch.where(is_pos[..., None], sm_axis_pos, sm_axis_vel)
    sm_vel = torch.where(is_pos, sm_vel_p, controls.ct_swing_target)

    # twist limit & motor (1907-1946)
    min_tw = (twist_limit >= 0.0) & (twist_angle <= -twist_limit)
    max_tw = (twist_limit >= 0.0) & (twist_angle >= twist_limit)
    twist_axis = quat_rotate(rot_a, j.local_axis_a)
    limit = torch.where(twist_limit >= 0.0, twist_limit, np.pi)
    tw_target = _clip(controls.ct_twist_target, -limit, limit)
    tw_vel_p = st.gate((tw_target - twist_angle) * inv_dt)
    tw_vel = torch.where(controls.ct_twist_motor_type == 1, tw_vel_p,
                         controls.ct_twist_target)
    d = torch.where(min_tw, twist_limit + twist_angle,
                    twist_limit - twist_angle)
    return ConeTwistPrep(
        body_a=jb["a"], body_b=jb["b"], color=j.color,
        num_colors=j.num_colors, rel_a=jb["rel_a"], rel_b=jb["rel_b"],
        bias=bias, inv_eff_mass=m,
        solve_swing_limit=(swing_limit >= 0.0) & (swing_angle >= swing_limit),
        swing_axis=swing_axis,
        eff_swing_limit_mass=_axial_mass(swing_axis, inv_ia, inv_ib),
        swing_limit_bias=swing_limit_bias,
        sl_to_wa=_mat_vec(inv_ia, swing_axis),
        sl_to_wb=_mat_vec(inv_ib, swing_axis),
        solve_twist_limit=min_tw | max_tw, twist_axis=twist_axis,
        eff_twist_mass=_axial_mass(twist_axis, inv_ia, inv_ib),
        twist_limit_sign=torch.where(min_tw, 1.0, -1.0),
        twist_limit_bias=st.gate(d * TWIST_LIMIT_BETA * inv_dt),
        tw_to_wa=_mat_vec(inv_ia, twist_axis),
        tw_to_wb=_mat_vec(inv_ib, twist_axis),
        solve_swing_motor=controls.ct_swing_max_torque > 0.0,
        swing_motor_axis=sm_axis,
        eff_swing_motor_mass=_axial_mass(sm_axis, inv_ia, inv_ib),
        swing_motor_velocity=sm_vel,
        max_swing_motor_impulse=torch.clamp(controls.ct_swing_max_torque,
                                            min=0.0) * float(st.dt),
        sm_to_wa=_mat_vec(inv_ia, sm_axis), sm_to_wb=_mat_vec(inv_ib, sm_axis),
        solve_twist_motor=controls.ct_twist_max_torque > 0.0,
        twist_motor_velocity=tw_vel,
        max_twist_motor_impulse=torch.clamp(controls.ct_twist_max_torque,
                                            min=0.0) * float(st.dt))


@dataclass
class SliderPrep:
    body_a: torch.Tensor
    body_b: torch.Tensor
    r_au_x_t: torch.Tensor
    r_au_x_b: torch.Tensor
    r_b_x_t: torch.Tensor
    r_b_x_b: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    inv_eff_trans_mass: torch.Tensor   # (B, J, 2, 2)
    translation_bias: torch.Tensor     # (B, J, 2)
    inv_eff_rot_mass: torch.Tensor     # (B, J, 3, 3)
    rotation_bias: torch.Tensor        # (B, J, 3)
    axis: torch.Tensor
    solve_limit: torch.Tensor
    eff_axial_mass: torch.Tensor
    limit_bias: torch.Tensor
    limit_sign: torch.Tensor
    r_au_x_s: torch.Tensor
    r_b_x_s: torch.Tensor
    l_to_wa: torch.Tensor
    l_to_wb: torch.Tensor
    solve_motor: torch.Tensor
    motor_velocity: torch.Tensor
    max_motor_impulse: torch.Tensor
    color: torch.Tensor = None
    num_colors: int = 1


def prep_slider(bodies: SolverBodies, j, controls, dt) -> SliderPrep:
    """constraints.cpp:2638-2752."""
    st = _Step(dt)
    jb = _joint_bodies(bodies, j)
    rel_b = jb["rel_b"]
    inv_ia, inv_ib = jb["inv_ia"], jb["inv_ib"]
    axis = quat_rotate(jb["rot_a"], j.local_axis_a)
    tangent, bitangent = get_tangents(axis)
    u = jb["gb"] - jb["ga"]
    r_au = jb["rel_a"] + u
    rbxt = cross(rel_b, tangent)
    rbxb = cross(rel_b, bitangent)
    rauxt = cross(r_au, tangent)
    rauxb = cross(r_au, bitangent)
    ia_rauxt = _mat_vec(inv_ia, rauxt)
    ia_rauxb = _mat_vec(inv_ia, rauxb)
    ib_rbxt = _mat_vec(inv_ib, rbxt)
    ib_rbxb = _mat_vec(inv_ib, rbxb)
    inv_mass_sum = jb["inv_ma"] + jb["inv_mb"]
    mt = _stack2(dot(rauxt, ia_rauxt) + dot(rbxt, ib_rbxt) + inv_mass_sum,
                 dot(rauxt, ia_rauxb) + dot(rbxt, ib_rbxb),
                 dot(rauxb, ia_rauxt) + dot(rbxb, ib_rbxt),
                 dot(rauxb, ia_rauxb) + dot(rbxb, ib_rbxb) + inv_mass_sum)
    tb = st.gate(torch.stack([dot(u, tangent), dot(u, bitangent)], -1)
                 * st.gain(SLIDER_BETA))

    # limit (2702-2733)
    dist = dot(u, axis)
    min_v = (j.limit_min <= 0.0) & (dist < j.limit_min)
    max_v = (j.limit_max >= 0.0) & (dist > j.limit_max)
    rauxs = cross(r_au, axis)
    rbxs = cross(rel_b, axis)
    im_ax = (inv_mass_sum + dot(rauxs, _mat_vec(inv_ia, rauxs))
             + dot(rbxs, _mat_vec(inv_ib, rbxs)))
    err = torch.where(min_v, dist - j.limit_min, j.limit_max - dist)

    # motor (2735-2752)
    min_l = torch.where(j.limit_min <= 0.0, j.limit_min, -np.inf)
    max_l = torch.where(j.limit_max >= 0.0, j.limit_max, np.inf)
    target = _clip(controls.slider_target, min_l, max_l)
    vel_p = st.gate((target - dist) * float(st.inv_dt))
    return SliderPrep(
        body_a=jb["a"], body_b=jb["b"], color=j.color,
        num_colors=j.num_colors, r_au_x_t=rauxt, r_au_x_b=rauxb,
        r_b_x_t=rbxt, r_b_x_b=rbxb, tangent=tangent, bitangent=bitangent,
        inv_eff_trans_mass=mt, translation_bias=tb,
        inv_eff_rot_mass=inv_ia + inv_ib,
        rotation_bias=_rotation_error_bias(jb, j, st), axis=axis,
        solve_limit=min_v | max_v, eff_axial_mass=_inv_or_zero(im_ax),
        limit_bias=st.gate(err * st.gain(SLIDER_LIMIT_BETA)),
        limit_sign=torch.where(min_v, 1.0, -1.0),
        r_au_x_s=rauxs, r_b_x_s=rbxs,
        l_to_wa=_mat_vec(inv_ia, rauxs), l_to_wb=_mat_vec(inv_ib, rbxs),
        solve_motor=controls.slider_max_force > 0.0,
        motor_velocity=torch.where(controls.slider_motor_type == 1, vel_p,
                                   controls.slider_target),
        max_motor_impulse=torch.clamp(controls.slider_max_force, min=0.0)
        * float(st.dt))


def prep_joints(scene, bodies: SolverBodies, controls, dt):
    """The preps of every joint type present in `scene`, in
    reference solve order (Scene.joint_types)."""
    out = []
    for name in scene.joint_types:
        j = getattr(scene, name)
        if name in ("distance", "ball", "fixed"):
            out.append(_PREPS[name](bodies, j, dt))
        else:
            out.append(_PREPS[name](bodies, j, controls, dt))
    return tuple(out)


_PREPS = {"distance": prep_distance, "ball": prep_ball, "fixed": prep_fixed,
          "hinge": prep_hinge, "cone_twist": prep_cone_twist,
          "slider": prep_slider}


# ===========================================================================
# Joint solves (constraints.cpp:189-2845): one joint against its two bodies'
# velocities. Every argument broadcasts: a row of one joint type ((B, ...)
# fields) in the sequential pass, the whole type ((B, J, ...)) in the
# averaged and coloured passes. inv_ma / inv_mb are the static inverse
# masses, inv_ia / inv_ib the world inverse inertias.


def _distance_solve_one(c, inv_ma, inv_mb, va, wa, vb, wb):
    av = va + cross(wa, c.rel_a)
    bv = vb + cross(wb, c.rel_b)
    cdot = dot(c.u, bv - av) + c.bias
    lam = -c.eff_mass * cdot
    P = lam[..., None] * c.u
    va = va - inv_ma[..., None] * P
    wa = wa - c.to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + c.to_wb * lam[..., None]
    return va, wa, vb, wb


def _point_solve(c, bias, inv_eff_mass, inv_ma, inv_mb, inv_ia, inv_ib,
                 va, wa, vb, wb):
    """The shared point-to-point (position) part: ball, fixed, hinge and
    cone-twist joints."""
    av = va + cross(wa, c.rel_a)
    bv = vb + cross(wb, c.rel_b)
    cdot = bv - av + bias
    P = solve_3x3(inv_eff_mass, -cdot)
    va = va - inv_ma[..., None] * P
    wa = wa - _mat_vec(inv_ia, cross(c.rel_a, P))
    vb = vb + inv_mb[..., None] * P
    wb = wb + _mat_vec(inv_ib, cross(c.rel_b, P))
    return va, wa, vb, wb


def _ball_solve_one(c, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb):
    return _point_solve(c, c.bias, c.inv_eff_mass, inv_ma, inv_mb, inv_ia,
                        inv_ib, va, wa, vb, wb)


def _fixed_solve_one(c, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb):
    # rotation part
    cdot = wb - wa
    lam = solve_3x3(c.inv_eff_rot_mass, -(cdot + c.rotation_bias))
    wa = wa - _mat_vec(inv_ia, lam)
    wb = wb + _mat_vec(inv_ib, lam)
    # position part
    return _point_solve(c, c.translation_bias, c.inv_eff_trans_mass, inv_ma,
                        inv_mb, inv_ia, inv_ib, va, wa, vb, wb)


def _axial_impulse(lam, imp, solve, lo=None, hi=None):
    """A clamped accumulated axial impulse: (applied lam, new accumulator).
    With lo/hi the accumulator is clamped to [lo, hi] (motors), else to
    >= 0 (limits); rows whose `solve` flag is off apply nothing."""
    if lo is None:
        new_imp = torch.clamp(imp + lam, min=0.0)
    else:
        new_imp = _clip(imp + lam, lo, hi)
    return (torch.where(solve, new_imp - imp, 0.0),
            torch.where(solve, new_imp, imp))


def _hinge_solve_one(c, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
                     limit_imp, motor_imp):
    """Motor -> limit -> rotation -> position (constraints.cpp:1215-1306)."""
    axis = c.axis
    # motor
    rel_w = dot(axis, wb) - dot(axis, wa)
    lam = -c.eff_axial_mass * (rel_w - c.motor_velocity)
    lam, motor_imp = _axial_impulse(lam, motor_imp, c.solve_motor,
                                    -c.max_motor_impulse, c.max_motor_impulse)
    wa = wa - c.ml_to_wa * lam[..., None]
    wb = wb + c.ml_to_wb * lam[..., None]

    # limit
    rel_w = c.limit_sign * (dot(axis, wb) - dot(axis, wa))
    lam = -c.eff_axial_mass * (rel_w + c.limit_bias)
    lam, limit_imp = _axial_impulse(lam, limit_imp, c.solve_limit)
    lam = lam * c.limit_sign
    wa = wa - c.ml_to_wa * lam[..., None]
    wb = wb + c.ml_to_wb * lam[..., None]

    # rotation (2D)
    dw = wb - wa
    cdot2 = torch.stack([dot(c.bxa, dw), dot(c.cxa, dw)], dim=-1)
    lam2 = solve_2x2(c.inv_eff_rot_mass, -(cdot2 + c.rotation_bias))
    rot_p = c.bxa * lam2[..., 0:1] + c.cxa * lam2[..., 1:2]
    wa = wa - _mat_vec(inv_ia, rot_p)
    wb = wb + _mat_vec(inv_ib, rot_p)

    # position (3D)
    va, wa, vb, wb = _point_solve(c, c.translation_bias,
                                  c.inv_eff_trans_mass, inv_ma, inv_mb,
                                  inv_ia, inv_ib, va, wa, vb, wb)
    return va, wa, vb, wb, limit_imp, motor_imp


def _cone_twist_solve_one(c, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
                          swing_imp, twist_imp, sm_imp, tm_imp):
    """Twist motor -> swing motor -> twist limit -> swing limit -> position
    (constraints.cpp:1955-2068)."""
    # twist motor
    rel_w = dot(c.twist_axis, wb) - dot(c.twist_axis, wa)
    lam = -c.eff_twist_mass * (rel_w - c.twist_motor_velocity)
    lam, tm_imp = _axial_impulse(lam, tm_imp, c.solve_twist_motor,
                                 -c.max_twist_motor_impulse,
                                 c.max_twist_motor_impulse)
    wa = wa - c.tw_to_wa * lam[..., None]
    wb = wb + c.tw_to_wb * lam[..., None]

    # swing motor
    rel_w = dot(c.swing_motor_axis, wb) - dot(c.swing_motor_axis, wa)
    lam = -c.eff_swing_motor_mass * (rel_w - c.swing_motor_velocity)
    lam, sm_imp = _axial_impulse(lam, sm_imp, c.solve_swing_motor,
                                 -c.max_swing_motor_impulse,
                                 c.max_swing_motor_impulse)
    wa = wa - c.sm_to_wa * lam[..., None]
    wb = wb + c.sm_to_wb * lam[..., None]

    # twist limit
    rel_w = c.twist_limit_sign * (dot(c.twist_axis, wb)
                                  - dot(c.twist_axis, wa))
    lam = -c.eff_twist_mass * (rel_w + c.twist_limit_bias)
    lam, twist_imp = _axial_impulse(lam, twist_imp, c.solve_twist_limit)
    lam = lam * c.twist_limit_sign
    wa = wa - c.tw_to_wa * lam[..., None]
    wb = wb + c.tw_to_wb * lam[..., None]

    # swing limit (reversed signs: Cdot = aDotWA - aDotWB + bias,
    # wa += ..., wb -= ...; constraints.cpp:2035-2048)
    cdot = dot(c.swing_axis, wa) - dot(c.swing_axis, wb) + c.swing_limit_bias
    lam = -c.eff_swing_limit_mass * cdot
    lam, swing_imp = _axial_impulse(lam, swing_imp, c.solve_swing_limit)
    wa = wa + c.sl_to_wa * lam[..., None]
    wb = wb - c.sl_to_wb * lam[..., None]

    # position
    va, wa, vb, wb = _point_solve(c, c.bias, c.inv_eff_mass, inv_ma, inv_mb,
                                  inv_ia, inv_ib, va, wa, vb, wb)
    return va, wa, vb, wb, swing_imp, twist_imp, sm_imp, tm_imp


def _slider_solve_one(c, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
                      limit_imp, motor_imp):
    """Motor -> limit -> rotation -> position (constraints.cpp:2761-2845)."""
    # motor (linear along the axis)
    cdot = dot(vb, c.axis) - dot(va, c.axis) - c.motor_velocity
    mass = _inv_or_zero(inv_ma + inv_mb)
    lam = -mass * cdot
    lam, motor_imp = _axial_impulse(lam, motor_imp, c.solve_motor,
                                    -c.max_motor_impulse, c.max_motor_impulse)
    P = lam[..., None] * c.axis
    va = va - inv_ma[..., None] * P
    vb = vb + inv_mb[..., None] * P

    # limit
    cdot = (dot(vb, c.axis) + dot(wb, c.r_b_x_s)
            - dot(va, c.axis) - dot(wa, c.r_au_x_s))
    lam = -c.eff_axial_mass * (c.limit_sign * cdot + c.limit_bias)
    lam, limit_imp = _axial_impulse(lam, limit_imp, c.solve_limit)
    lam = lam * c.limit_sign
    P = lam[..., None] * c.axis
    va = va - inv_ma[..., None] * P
    wa = wa - c.l_to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + c.l_to_wb * lam[..., None]

    # rotation (3D)
    cdot = wb - wa
    lam3 = solve_3x3(c.inv_eff_rot_mass, -(cdot + c.rotation_bias))
    wa = wa - _mat_vec(inv_ia, lam3)
    wb = wb + _mat_vec(inv_ib, lam3)

    # position (2D in the plane normal to the slider axis)
    cx = (dot(c.tangent, vb) + dot(c.r_b_x_t, wb)
          - dot(c.tangent, va) - dot(c.r_au_x_t, wa))
    cy = (dot(c.bitangent, vb) + dot(c.r_b_x_b, wb)
          - dot(c.bitangent, va) - dot(c.r_au_x_b, wa))
    cdot2 = torch.stack([cx, cy], dim=-1)
    lam2 = solve_2x2(c.inv_eff_trans_mass, -(cdot2 + c.translation_bias))
    l0, l1 = lam2[..., 0:1], lam2[..., 1:2]
    tbv = c.tangent * l0 + c.bitangent * l1
    va = va - inv_ma[..., None] * tbv
    wa = wa - _mat_vec(inv_ia, c.r_au_x_t * l0 + c.r_au_x_b * l1)
    vb = vb + inv_mb[..., None] * tbv
    wb = wb + _mat_vec(inv_ib, c.r_b_x_t * l0 + c.r_b_x_b * l1)
    return va, wa, vb, wb, limit_imp, motor_imp


# ===========================================================================
# Orchestration


@dataclass
class Prepped:
    contacts: Optional[ContactPrep] = None
    distance: Optional[DistancePrep] = None
    ball: Optional[BallPrep] = None
    fixed: Optional[FixedPrep] = None
    hinge: Optional[HingePrep] = None
    cone_twist: Optional[ConeTwistPrep] = None
    slider: Optional[SliderPrep] = None


# per joint type: solve function and accumulators
_JOINT_SOLVES = {
    "distance": (_distance_solve_one, 0),
    "ball": (_ball_solve_one, 0),
    "fixed": (_fixed_solve_one, 0),
    "hinge": (_hinge_solve_one, 2),
    "cone_twist": (_cone_twist_solve_one, 4),
    "slider": (_slider_solve_one, 2),
}
_STATIC_FIELDS = ("body_a", "body_b", "color", "num_colors")


class _Row:
    """Row i of a joint prep: every batched field (B, J, ...) -> (B, ...);
    body indices as Python ints."""

    def __init__(self, prep, i):
        for f in fields(prep):
            if f.name not in _STATIC_FIELDS:
                setattr(self, f.name, getattr(prep, f.name)[:, i])


def joint_rows(prep):
    """(row views, body_a ints, body_b ints) of a joint prep, made once a
    step for the sequential pass."""
    a = prep.body_a.tolist()
    b = prep.body_b.tolist()
    return [_Row(prep, i) for i in range(len(a))], a, b


def _gs_pass(prep, solve_fn, n_acc, v, w, inv_mass, inv_inertia, accs,
             rows=None):
    """Sequential impulses over one joint type, joint by joint in order;
    each joint writes body a's velocities, then body b's. v, w (B, N, 3);
    accs: n_acc (B, J) accumulators. `rows` (joint_rows) may be passed in
    when the pass is repeated."""
    count = prep.body_a.shape[0]
    if count == 0:
        return v, w, accs
    rows, ia, ib = rows if rows is not None else joint_rows(prep)
    inertia = solve_fn is not _distance_solve_one
    v, w = v.clone(), w.clone()
    cols = [list(acc.unbind(1)) for acc in accs]
    for i, (c, a, b) in enumerate(zip(rows, ia, ib)):
        args = [c, inv_mass[a], inv_mass[b]]
        if inertia:
            args += [inv_inertia[:, a], inv_inertia[:, b]]
        args += [v[:, a], w[:, a], v[:, b], w[:, b]]
        args += [col[i] for col in cols]
        out = solve_fn(*args)
        v[:, a] = out[0]
        v[:, b] = out[2]
        w[:, a] = out[1]
        w[:, b] = out[3]
        for col, val in zip(cols, out[4:]):
            col[i] = val
    return v, w, tuple(torch.stack(col, dim=1) for col in cols)


def _jacobi_pass(prep, solve_fn, v, w, inv_mass, inv_inertia, accs,
                 omega=1.0):
    """Averaged Jacobi over one joint type: all joints against the same
    body velocities, per-body deltas summed and scaled by omega / degree."""
    count = prep.body_a.shape[0]
    if count == 0:
        return v, w, accs
    a, b = prep.body_a, prep.body_b
    args = [prep, inv_mass[a], inv_mass[b]]
    if solve_fn is not _distance_solve_one:
        args += [inv_inertia[:, a], inv_inertia[:, b]]
    va, wa = v[:, a], w[:, a]
    vb, wb = v[:, b], w[:, b]
    out = solve_fn(*args, va, wa, vb, wb, *accs)
    nva, nwa, nvb, nwb = out[:4]

    n = v.shape[1]
    ones = torch.ones(count, dtype=v.dtype, device=v.device)
    deg = torch.zeros(n, dtype=v.dtype, device=v.device)
    deg.index_add_(0, a, ones)
    deg.index_add_(0, b, ones)
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)

    dv = torch.zeros_like(v).index_add_(1, a, nva - va).index_add_(
        1, b, nvb - vb)
    dw = torch.zeros_like(w).index_add_(1, a, nwa - wa).index_add_(
        1, b, nwb - wb)
    scale = (omega * inv_deg)[:, None]
    return v + dv * scale, w + dw * scale, tuple(out[4:])


def _colored_pass(prep, solve_fn, v, w, inv_mass, inv_inertia, accs):
    """Coloured Gauss-Seidel over one joint type: colours in order, the
    joints of a colour (which share no body) in parallel."""
    count = prep.body_a.shape[0]
    if count == 0:
        return v, w, accs
    a, b = prep.body_a, prep.body_b
    inertia = solve_fn is not _distance_solve_one
    for col in range(prep.num_colors):
        mask = prep.color == col
        args = [prep, inv_mass[a], inv_mass[b]]
        if inertia:
            args += [inv_inertia[:, a], inv_inertia[:, b]]
        va, wa = v[:, a], w[:, a]
        vb, wb = v[:, b], w[:, b]
        out = solve_fn(*args, va, wa, vb, wb, *accs)
        nva, nwa, nvb, nwb = out[:4]
        mf = mask.to(v.dtype)[:, None]
        dv = torch.zeros_like(v).index_add_(1, a, (nva - va) * mf).index_add_(
            1, b, (nvb - vb) * mf)
        dw = torch.zeros_like(w).index_add_(1, a, (nwa - wa) * mf).index_add_(
            1, b, (nwb - wb) * mf)
        v = v + dv
        w = w + dw
        accs = tuple(torch.where(mask, new, old)
                     for new, old in zip(out[4:], accs))
    return v, w, accs


_YZX = (1, 2, 0)
_ZXY = (2, 0, 1)


def live_points(prep: ContactPrep, accs):
    """(P, 4) numpy bool: the points that a sequential pass from the
    accumulators `accs` can change in some env: a non-zero effective mass,
    or an accumulated impulse outside its clamp (a negative normal impulse,
    a friction impulse past friction x normal impulse). Any other point
    solves to zero impulses and leaves every velocity and accumulator as it
    was (up to the sign of a zero), so `_contact_gs_pass` skips it, and a
    row without a live point (its gathers and writes too). Each point's
    accumulators change only in its own solve, so the test at the start of
    a pass holds for the whole pass. One copy to the host a pass."""
    imp_n, imp_t = accs
    live = ((prep.eff_mass_n != 0.0) | (prep.eff_mass_t != 0.0)
            | (imp_n < 0.0) | (imp_t.abs() > prep.friction * imp_n))
    return torch.any(live, dim=0).cpu().numpy()


def contact_rows(prep: ContactPrep, num_rows: int):
    """Per pair row of a contact prep, the constants of its sequential
    solve, made once a step: both sides stacked on a leading axis of 2
    (side a, side b), so that one operation serves both, with the signs of
    side a's updates folded in (a - x == a + (-x) exactly); per point the
    anchors and their component rotations for the cross product, the
    direction, the negated effective masses and the impulse-to-angular-
    velocity factors; the flat (B * num_rows) indices of the two bodies."""
    idx = [_flat_index(x, num_rows).view(x.shape)
           for x in (prep.body_a, prep.body_b)]
    m = torch.stack([-prep.inv_ma, prep.inv_mb])[..., None]  # (2, B, P, 1)
    rel = torch.stack([prep.rel_a, prep.rel_b])              # (2, B, P, 4, 3)
    rel_yzx, rel_zxy = rel[..., _YZX], rel[..., _ZXY]
    t2w = torch.stack([-prep.t_to_wa, prep.t_to_wb])
    n2w = torch.stack([-prep.n_to_wa, prep.n_to_wb])
    neg_t, neg_n = -prep.eff_mass_t, -prep.eff_mass_n
    rows = []
    for i in range(prep.body_a.shape[1]):
        points = [(k, dict(ryzx=rel_yzx[:, :, i, k], rzxy=rel_zxy[:, :, i, k],
                       t=prep.tangent[:, i, k], n=prep.normal[:, i, k],
                       neg_t=neg_t[:, i, k], neg_n=neg_n[:, i, k],
                       bias=prep.bias[:, i, k],
                       friction=prep.friction[:, i, k],
                       t2w=t2w[:, :, i, k], n2w=n2w[:, :, i, k]))
                  for k in range(prep.bias.shape[-1])]
        rows.append((i, points, m[:, :, i], idx[0][:, i], idx[1][:, i]))
    return rows


def _cross_rows(w, p):
    """cross(w, r) of stacked rows from r's component rotations p: the
    components of maths.cross, each the same two products and difference."""
    return w[..., _YZX] * p["rzxy"] - w[..., _ZXY] * p["ryzx"]


def _contact_row(points, m, v, w, imp_n, imp_t):
    """One pair row of the sequential pass: its <= 4 points in order,
    friction then normal, on the stacked velocities v, w (2, B, 3) of its
    two bodies; the operations of _contact_solve_point, both sides at
    once. points: (point index, constants); imp_n / imp_t: lists of the
    row's per-point (B,) impulses."""
    for k, p in points:
        # tangent
        x = v + _cross_rows(w, p)
        vt = torch.sum((x[1] - x[0]) * p["t"], dim=-1)
        lam = p["neg_t"] * vt
        max_f = p["friction"] * imp_n[k]
        new_imp = torch.clamp(imp_t[k] + lam, -max_f, max_f)
        lam = new_imp - imp_t[k]
        imp_t[k] = new_imp
        v = v + m * (lam[:, None] * p["t"])
        w = w + p["t2w"] * lam[:, None]
        # normal
        x = v + _cross_rows(w, p)
        vn = torch.sum((x[1] - x[0]) * p["n"], dim=-1)
        lam = p["neg_n"] * (vn - p["bias"])
        new_imp = torch.clamp(imp_n[k] + lam, min=0.0)
        lam = new_imp - imp_n[k]
        imp_n[k] = new_imp
        v = v + m * (lam[:, None] * p["n"])
        w = w + p["n2w"] * lam[:, None]
    return v, w


def _contact_gs_pass(prep: ContactPrep, v, w, accs, rows=None):
    """Sequential impulses over contacts: pair rows in order, each row's
    <= 4 points in order, each row reading the velocities its predecessor
    wrote and writing body a's, then body b's (a dead row's two bodies are
    both the dummy row); points that cannot change anything are skipped
    (live_points). accs: (imp_n, imp_t), (B, P, 4) each. `rows`
    (contact_rows) may be passed in when the pass is repeated."""
    count = prep.body_a.shape[1]
    if count == 0:
        return v, w, accs
    B, n = v.shape[0], v.shape[1]
    rows = rows if rows is not None else contact_rows(prep, n)
    live = live_points(prep, accs)
    vw = torch.cat([v, w], dim=-1).view(B * n, 6)
    imp_n = [list(x.unbind(-1)) for x in accs[0].unbind(1)]
    imp_t = [list(x.unbind(-1)) for x in accs[1].unbind(1)]
    for i, points, m, fa, fb in rows:
        points = [(k, p) for k, p in points if live[i, k]]
        if not points:
            continue
        g = torch.stack([vw[fa], vw[fb]])                # (2, B, 6)
        rv, rw = _contact_row(points, m, g[..., :3], g[..., 3:],
                              imp_n[i], imp_t[i])
        out = torch.cat([rv, rw], dim=-1)
        vw.index_copy_(0, fa, out[0])
        vw.index_copy_(0, fb, out[1])
    vw = vw.view(B, n, 6)
    return (vw[..., :3], vw[..., 3:],
            (torch.stack([torch.stack(x, -1) for x in imp_n], 1),
             torch.stack([torch.stack(x, -1) for x in imp_t], 1)))


def solve_constraints(bodies: SolverBodies, prepped: Prepped,
                      num_iterations: int, mode: str = "scan",
                      omega: float = 1.0):
    """Run `num_iterations` rounds over all constraint types in the
    reference's order: distance, ball, fixed, hinge, cone-twist, slider,
    contacts. Contacts take the sequential pass in "scan" and the phased
    pass otherwise; joints take the sequential pass in "scan", the
    coloured pass in "colored" (where the prep has colours) and the
    averaged pass otherwise.

    Returns (bodies, contact_imp_n): the accumulated normal impulses per
    pair point, (B, P, 4), or None without contacts."""
    if mode not in ("scan", "jacobi", "colored"):
        raise ValueError(f"unknown solver mode {mode!r}")
    v, w = bodies.v, bodies.w
    inv_m, inv_i = bodies.inv_mass, bodies.inv_inertia
    n = v.shape[1]
    p = prepped
    joints = [(name, getattr(p, name)) for name in _JOINT_SOLVES
              if getattr(p, name) is not None]

    accs = {}
    for name, prep in joints:
        z = torch.zeros(v.shape[0], prep.body_a.shape[0], dtype=v.dtype,
                        device=v.device)
        accs[name] = tuple(z for _ in range(_JOINT_SOLVES[name][1]))
    if p.contacts is not None:
        z = torch.zeros(p.contacts.bias.shape, dtype=v.dtype, device=v.device)
        accs["contacts"] = (z, z)

    # constant across iterations: the sequential passes' row views, the
    # phased pass's slices and per-body 1/degree
    if mode == "scan":
        rows = {name: joint_rows(prep) for name, prep in joints}
        if p.contacts is not None:
            rows["contacts"] = contact_rows(p.contacts, n)
    elif p.contacts is not None:
        inv_deg_phases = contact_phase_inv_degrees(p.contacts, n)
        views = _phase_views(p.contacts, n)

    for _ in range(num_iterations):
        for name, prep in joints:
            fn, n_acc = _JOINT_SOLVES[name]
            if mode == "scan":
                v, w, accs[name] = _gs_pass(prep, fn, n_acc, v, w, inv_m,
                                            inv_i, accs[name], rows[name])
            elif mode == "colored" and prep.color is not None:
                v, w, accs[name] = _colored_pass(prep, fn, v, w, inv_m,
                                                 inv_i, accs[name])
            else:
                v, w, accs[name] = _jacobi_pass(prep, fn, v, w, inv_m,
                                                inv_i, accs[name], omega)
        if p.contacts is not None:
            if mode == "scan":
                v, w, accs["contacts"] = _contact_gs_pass(
                    p.contacts, v, w, accs["contacts"], rows["contacts"])
            else:
                v, w, accs["contacts"] = _contact_phased_pass(
                    views, v, w, accs["contacts"], inv_deg_phases, omega)
    contact_imp_n = accs["contacts"][0] if p.contacts is not None else None
    return bodies.replace(v=v, w=w), contact_imp_n
