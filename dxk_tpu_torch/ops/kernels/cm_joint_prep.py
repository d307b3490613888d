"""Joint constraint prep on component-major lanes — the plain PyTorch
form of the joint prep that ``csrc/fused_step.cu`` runs in-kernel.

Formulas follow the JAX package's ``ops/pallas/cm_joint_prep.py`` operation
for operation. Where that module unrolls one joint at a time with the
joint's static parameters as Python floats, this one evaluates all joints
of a type at once: every lane is a (B, J) tensor and the static parameters
are (J,) tensors read from a per-scene table, which is also how the CUDA
kernel reads them. The inverse-trig calls use core/fastmath.py.

Each `*_rows` function returns the packed row list in the layout
batched_solver's `_*_field_rows` readers consume.

All six joint types of the JAX package are ported: distance, ball, fixed,
hinge, cone-twist, slider.
"""

from __future__ import annotations

import numpy as np
import torch

from dxk_tpu_torch.core import fastmath as fm
from dxk_tpu_torch.core.maths import sqrt
from dxk_tpu_torch.ops.kernels.cm_narrowphase import (_add, _clip, _cross,
                                                      _dot, _max, _muls,
                                                      _neg, _sqlen, _sub,
                                                      _where, get_tangent_cm,
                                                      quat_rotate_cm)

# Baumgarte factors and the degenerate-dt guard of the constraint preps
# (the JAX package's ops/solver.py:46-53)
DISTANCE_BETA = 0.1
BALL_BETA = 0.1
SLIDER_BETA = 0.1
HINGE_ROTATION_BETA = 0.3
HINGE_LIMIT_BETA = 0.1
TWIST_LIMIT_BETA = 0.1
SLIDER_LIMIT_BETA = 0.1
DT_THRESHOLD = 1e-5

# ---------------------------------------------------------------------------
# cm quaternion / mat3 helpers (ports of core/maths.py, same op order)


def quat_mul_cm(a, b):
    """maths.quat_mul: w = aw*bw - av.bv ; v = av*bw + bv*aw + av x bv."""
    av = (a[0], a[1], a[2])
    bv = (b[0], b[1], b[2])
    w = a[3] * b[3] - _dot(av, bv)
    c = _cross(av, bv)
    v = _add(_add(_muls(av, b[3]), _muls(bv, a[3])), c)
    return (v[0], v[1], v[2], w)


def quat_conj_cm(q):
    return (-q[0], -q[1], -q[2], q[3])


def quat_normalize_cm(q):
    n = sqrt(_max(
        q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30))
    inv = 1.0 / n
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def quat_from_axis_angle_cm(axis, angle):
    half = angle * 0.5
    s = torch.sin(half)
    return (axis[0] * s, axis[1] * s, axis[2] * s, torch.cos(half))


def normalize_cm(v):
    inv = 1.0 / sqrt(_max(_sqlen(v), 1e-30))
    return _muls(v, inv)


def noz_cm(v):
    sq = _sqlen(v)
    ok = sq > 1e-12
    inv = sqrt(1.0 / torch.where(ok, sq, 1.0))
    return tuple(torch.where(ok, c * inv, 0.0) for c in v)


def rotate_from_to_cm(f, t):
    """maths.rotate_from_to. `f` is the static joint axis, already
    normalized when the static table was built (static_params,
    "local_axis_a_unit"); `t` is normalized here."""
    t = normalize_cm(t)
    d = _dot(f, t)
    s = sqrt(_max((1.0 + d) * 2.0, 1e-30))
    invs = 1.0 / s
    c = _cross(f, t)
    qg = quat_normalize_cm((c[0] * invs, c[1] * invs, c[2] * invs, s * 0.5))
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    ax1 = _cross((one, zero, zero), f)
    ax2 = _cross((zero, one, zero), f)
    use2 = _sqlen(ax1) < 1e-12
    axr = _where(use2, ax2, ax1)
    axis = normalize_cm(_add(axr, (torch.full_like(d, 1e-30),) * 3))
    anti = d < (1e-6 - 1.0)
    q = tuple(torch.where(anti, p, g)
              for p, g in zip((axis[0], axis[1], axis[2], zero), qg))
    ident = (zero, zero, zero, one)
    return tuple(torch.where(d >= 1.0, i, x) for i, x in zip(ident, q))


def get_axis_rotation_cm(q):
    """maths.get_axis_rotation with fastmath.acos."""
    v = (q[0], q[1], q[2])
    sq = _sqlen(v)
    ok = sq > 0.0
    angle = torch.where(ok, 2.0 * fm.acos(_clip(q[3], -1.0, 1.0)), 0.0)
    inv_len = torch.where(ok, 1.0 / sqrt(torch.where(ok, sq, 1.0)), 0.0)
    one = torch.ones_like(sq)
    zero = torch.zeros_like(sq)
    axis = _where(ok, _muls(v, inv_len), (one, zero, zero))
    return axis, angle


def skew_matvec(inv_i, v):
    """inv_i: 9-tuple row-major mat3; v: v3 -> mat*vec, same sum order as
    solver._mat_vec (einsum j-ascending)."""
    return (inv_i[0] * v[0] + inv_i[1] * v[1] + inv_i[2] * v[2],
            inv_i[3] * v[0] + inv_i[4] * v[1] + inv_i[5] * v[2],
            inv_i[6] * v[0] + inv_i[7] * v[1] + inv_i[8] * v[2])


def _matmul3(a, b):
    """9-tuple row-major mat3 product, k-ascending sums."""
    out = []
    for i in range(3):
        for j in range(3):
            out.append(a[3 * i + 0] * b[0 + j] + a[3 * i + 1] * b[3 + j]
                       + a[3 * i + 2] * b[6 + j])
    return tuple(out)


def _mat_t(a):
    return (a[0], a[3], a[6], a[1], a[4], a[7], a[2], a[5], a[8])


def _skew(r):
    z = torch.zeros_like(r[0])
    return (z, -r[2], r[1],
            r[2], z, -r[0],
            -r[1], r[0], z)


def point_inv_eff_mass_cm(ia, ib, inv_ma, inv_mb, ra, rb):
    """solver._point_inv_effective_mass: sa Ia sa^T + sb Ib sb^T +
    I (ma+mb). Returns a 9-tuple."""
    sa = _skew(ra)
    sb = _skew(rb)
    m = tuple(x + y for x, y in zip(_matmul3(_matmul3(sa, ia), _mat_t(sa)),
                                    _matmul3(_matmul3(sb, ib), _mat_t(sb))))
    s = inv_ma + inv_mb
    m = list(m)
    m[0] = m[0] + s
    m[4] = m[4] + s
    m[8] = m[8] + s
    return tuple(m)


def _inv_nz(x):
    return torch.where(x != 0.0, 1.0 / torch.where(x != 0.0, x, 1.0), 0.0)


def _b2f(x):
    return torch.where(x, 1.0, 0.0)



# ---------------------------------------------------------------------------
# per-joint row builders. `bd` carries the two bodies' lanes:
#   qa, qb (4-tuples), pa, pb (v3 world COG), ia, ib (9-tuples world inverse
#   inertia), inv_ma, inv_mb (lanes).
# `js` carries the joint's STATIC params as python floats (anchors already
# have local_cog subtracted). `ctl` carries the joint's control lanes.
# dt/inv_dt are lanes (broadcast scalars).


def _anchors(js, bd):
    rel_a = quat_rotate_cm(bd["qa"], js["anchor_a"])
    rel_b = quat_rotate_cm(bd["qb"], js["anchor_b"])
    ga = _add(bd["pa"], rel_a)
    gb = _add(bd["pb"], rel_b)
    return rel_a, rel_b, ga, gb


def distance_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_distance (constraints.cpp:189-243)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    u = _sub(gb, ga)
    l = sqrt(_max(_sqlen(u), 0.0))
    ok = l > 0.001
    u = tuple(torch.where(ok, c / _max(l, 1e-12), 0.0) for c in u)
    cr_a = _cross(rel_a, u)
    cr_b = _cross(rel_b, u)
    im = (bd["inv_ma"] + _dot(cr_a, skew_matvec(bd["ia"], cr_a))
          + bd["inv_mb"] + _dot(cr_b, skew_matvec(bd["ib"], cr_b)))
    bias = torch.where(dt > DT_THRESHOLD,
                       (l - js["length"]) * (DISTANCE_BETA * inv_dt), 0.0)
    to_wa = skew_matvec(bd["ia"], cr_a)
    to_wb = skew_matvec(bd["ib"], cr_b)
    rows = list(rel_a) + list(rel_b) + list(u) + list(to_wa) + list(to_wb)
    rows += [bias, _inv_nz(im)]
    return rows


def ball_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_ball (constraints.cpp:460-507)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    m = point_inv_eff_mass_cm(bd["ia"], bd["ib"], bd["inv_ma"],
                              bd["inv_mb"], rel_a, rel_b)
    bias = tuple(torch.where(dt > DT_THRESHOLD,
                             c * (BALL_BETA * inv_dt), 0.0)
                 for c in _sub(gb, ga))
    return list(rel_a) + list(rel_b) + list(bias) + list(m)


def _rotation_bias(js, bd, dt, inv_dt):
    """Fixed and slider rotation error q_b * init_inv_rot * conj(q_a),
    vector part, as a Baumgarte bias."""
    q0 = js["init_inv_rot"]
    rot_err = quat_mul_cm(quat_mul_cm(bd["qb"], q0), quat_conj_cm(bd["qa"]))
    return tuple(torch.where(dt > DT_THRESHOLD,
                             rot_err[i] * (SLIDER_BETA * inv_dt * 2.0), 0.0)
                 for i in range(3))


def fixed_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_fixed (constraints.cpp:736-786)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    mt = point_inv_eff_mass_cm(bd["ia"], bd["ib"], bd["inv_ma"],
                               bd["inv_mb"], rel_a, rel_b)
    mr = tuple(x + y for x, y in zip(bd["ia"], bd["ib"]))
    t_bias = tuple(torch.where(dt > DT_THRESHOLD,
                               c * (BALL_BETA * inv_dt), 0.0)
                   for c in _sub(gb, ga))
    r_bias = _rotation_bias(js, bd, dt, inv_dt)
    return (list(rel_a) + list(rel_b) + list(t_bias) + list(r_bias)
            + list(mt) + list(mr))


def hinge_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_hinge (constraints.cpp:1079-1213)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    ia, ib = bd["ia"], bd["ib"]
    mt = point_inv_eff_mass_cm(ia, ib, bd["inv_ma"], bd["inv_mb"],
                               rel_a, rel_b)
    t_bias = tuple(torch.where(dt > DT_THRESHOLD,
                             c * (BALL_BETA * inv_dt), 0.0)
                   for c in _sub(gb, ga))

    axis_a = quat_rotate_cm(bd["qa"], js["local_axis_a"])
    axis_b = quat_rotate_cm(bd["qb"], js["local_axis_b"])
    tan_b = get_tangent_cm(axis_b)
    bitan_b = _cross(axis_b, tan_b)

    bxa = _cross(tan_b, axis_a)
    cxa = _cross(bitan_b, axis_a)
    ia_bxa = skew_matvec(ia, bxa)
    ib_bxa = skew_matvec(ib, bxa)
    ia_cxa = skew_matvec(ia, cxa)
    ib_cxa = skew_matvec(ib, cxa)
    m00 = _dot(bxa, ia_bxa) + _dot(bxa, ib_bxa)
    m01 = _dot(bxa, ia_cxa) + _dot(bxa, ib_cxa)
    m10 = _dot(cxa, ia_bxa) + _dot(cxa, ib_bxa)
    m11 = _dot(cxa, ia_cxa) + _dot(cxa, ib_cxa)

    rb0 = torch.where(dt > DT_THRESHOLD,
                    _dot(axis_a, tan_b) * (HINGE_ROTATION_BETA * inv_dt),
                    0.0)
    rb1 = torch.where(dt > DT_THRESHOLD,
                    _dot(axis_a, bitan_b) * (HINGE_ROTATION_BETA * inv_dt),
                    0.0)

    # limits & motor (constraints.cpp:1155-1205)
    compare_a = quat_rotate_cm(
        quat_conj_cm(bd["qa"]),
        quat_rotate_cm(bd["qb"], js["local_tangent_b"]))
    angle = fm.atan2(_dot(compare_a, js["local_bitangent_a"]),
                     _dot(compare_a, js["local_tangent_a"]))
    lmin, lmax = js["limit_min"], js["limit_max"]
    min_violated = (lmin <= 0.0) & (angle <= lmin)
    max_violated = (lmax >= 0.0) & (angle >= lmax)
    max_torque = ctl["max_torque"]
    solve_limit = min_violated | max_violated
    solve_motor = max_torque > 0.0

    im_ax = (_dot(axis_a, skew_matvec(ia, axis_a))
             + _dot(axis_a, skew_matvec(ib, axis_a)))
    eff_ax = _inv_nz(im_ax)
    limit_sign = torch.where(min_violated, 1.0, -1.0)

    min_l = torch.where(lmin <= 0.0, lmin, -3.14159265358979)
    max_l = torch.where(lmax >= 0.0, lmax, 3.14159265358979)
    target = _clip(ctl["target"], min_l, max_l)
    pos_motor_vel = torch.where(dt > DT_THRESHOLD,
                              (target - angle) * inv_dt, 0.0)
    motor_vel = torch.where(ctl["motor_type"] == 1.0, pos_motor_vel,
                          ctl["target"])

    d = torch.where(min_violated, angle - lmin, lmax - angle)
    limit_bias = torch.where(dt > DT_THRESHOLD,
                           d * HINGE_LIMIT_BETA * inv_dt, 0.0)

    rows = (list(rel_a) + list(rel_b) + list(t_bias) + list(bxa)
            + list(cxa) + list(axis_a)
            + list(skew_matvec(ia, axis_a)) + list(skew_matvec(ib, axis_a))
            + list(mt) + [m00, m01, m10, m11] + [rb0, rb1])
    rows += [eff_ax, _b2f(solve_limit), _b2f(solve_motor), limit_sign,
             limit_bias, motor_vel, _max(max_torque, 0.0) * dt]
    return rows


def cone_twist_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_cone_twist (constraints.cpp:1782-1946)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    ia, ib = bd["ia"], bd["ib"]
    m = point_inv_eff_mass_cm(ia, ib, bd["inv_ma"], bd["inv_mb"],
                              rel_a, rel_b)
    bias = tuple(torch.where(dt > DT_THRESHOLD,
                           c * (BALL_BETA * inv_dt), 0.0)
                 for c in _sub(gb, ga))

    btoa = quat_mul_cm(quat_conj_cm(bd["qa"]), bd["qb"])
    axis_compare = quat_rotate_cm(btoa, js["local_axis_b"])
    swing_rotation = rotate_from_to_cm(js["local_axis_a_unit"], axis_compare)

    twist_tan_a = quat_rotate_cm(swing_rotation, js["local_tangent_a"])
    twist_bitan_a = quat_rotate_cm(swing_rotation, js["local_bitangent_a"])
    tan_compare = quat_rotate_cm(btoa, js["local_tangent_b"])
    twist_angle = fm.atan2(_dot(tan_compare, twist_bitan_a),
                           _dot(tan_compare, twist_tan_a))

    swing_axis_l, swing_angle = get_axis_rotation_cm(swing_rotation)
    neg = swing_angle < 0.0
    swing_angle = torch.where(neg, -swing_angle, swing_angle)
    swing_axis_l = _where(neg, _neg(swing_axis_l), swing_axis_l)

    swing_limit = js["limit_min"]      # swingLimit stored in limit_min
    twist_limit = js["limit_max"]      # twistLimit stored in limit_max

    # swing limit (1848-1865)
    solve_swing = ((swing_limit >= 0.0)
                   & (swing_angle >= swing_limit))
    swing_axis = quat_rotate_cm(bd["qa"], swing_axis_l)
    im_sl = (_dot(swing_axis, skew_matvec(ia, swing_axis))
             + _dot(swing_axis, skew_matvec(ib, swing_axis)))
    eff_sl = _inv_nz(im_sl)
    swing_limit_bias = torch.where(
        dt > DT_THRESHOLD,
        (swing_limit - swing_angle) * (HINGE_LIMIT_BETA * inv_dt), 0.0)

    # swing motor (1867-1905)
    solve_swing_motor = ctl["swing_max_torque"] > 0.0
    ax_x = torch.cos(ctl["swing_axis_angle"])
    ax_y = torch.sin(ctl["swing_axis_angle"])
    local_sm_axis = _add(_muls(js["local_tangent_a"], ax_x),
                         _muls(js["local_bitangent_a"], ax_y))
    sm_axis_vel = quat_rotate_cm(bd["qa"], local_sm_axis)
    sm_vel_v = ctl["swing_target"]
    # a disabled swing limit (< 0) leaves the target unclamped; the
    # per-joint select replaces the JAX package's trace-time branch
    target_angle = torch.where(
        swing_limit >= 0.0,
        _clip(ctl["swing_target"], -torch.abs(swing_limit),
              torch.abs(swing_limit)),
        ctl["swing_target"])
    local_target_dir = quat_rotate_cm(
        quat_from_axis_angle_cm(local_sm_axis, target_angle),
        js["local_axis_a"])
    local_sm_axis_pos = noz_cm(_cross(axis_compare, local_target_dir))
    sm_axis_pos = quat_rotate_cm(bd["qa"], local_sm_axis_pos)
    cos_angle = _dot(local_target_dir, axis_compare)
    delta_angle = fm.acos(_clip(cos_angle, 0.0, 1.0))
    sm_vel_p = torch.where(dt > DT_THRESHOLD, delta_angle * inv_dt * 0.2, 0.0)

    is_pos = ctl["swing_motor_type"] == 1.0
    sm_axis = _where(is_pos, sm_axis_pos, sm_axis_vel)
    sm_vel = torch.where(is_pos, sm_vel_p, sm_vel_v)
    im_sm = (_dot(sm_axis, skew_matvec(ia, sm_axis))
             + _dot(sm_axis, skew_matvec(ib, sm_axis)))
    eff_sm = _inv_nz(im_sm)

    # twist limit & motor (1907-1946)
    min_tw = (twist_limit >= 0.0) & (twist_angle <= -twist_limit)
    max_tw = (twist_limit >= 0.0) & (twist_angle >= twist_limit)
    solve_twist_limit = min_tw | max_tw
    solve_twist_motor = ctl["twist_max_torque"] > 0.0
    twist_axis = quat_rotate_cm(bd["qa"], js["local_axis_a"])
    im_tw = (_dot(twist_axis, skew_matvec(ia, twist_axis))
             + _dot(twist_axis, skew_matvec(ib, twist_axis)))
    eff_tw = _inv_nz(im_tw)
    twist_limit_sign = torch.where(min_tw, 1.0, -1.0)

    limit = torch.where(twist_limit >= 0.0, twist_limit, 3.14159265358979)
    tw_target = _clip(ctl["twist_target"], -limit, limit)
    tw_vel_p = torch.where(dt > DT_THRESHOLD,
                         (tw_target - twist_angle) * inv_dt, 0.0)
    tw_vel = torch.where(ctl["twist_motor_type"] == 1.0, tw_vel_p,
                       ctl["twist_target"])

    d = torch.where(min_tw, twist_limit + twist_angle,
                  twist_limit - twist_angle)
    twist_limit_bias = torch.where(dt > DT_THRESHOLD,
                                 d * TWIST_LIMIT_BETA * inv_dt, 0.0)

    rows = (list(rel_a) + list(rel_b) + list(bias) + list(swing_axis)
            + list(skew_matvec(ia, swing_axis))
            + list(skew_matvec(ib, swing_axis))
            + list(twist_axis)
            + list(skew_matvec(ia, twist_axis))
            + list(skew_matvec(ib, twist_axis))
            + list(sm_axis)
            + list(skew_matvec(ia, sm_axis))
            + list(skew_matvec(ib, sm_axis))
            + list(m))
    rows += [_b2f(solve_swing), eff_sl, swing_limit_bias,
             _b2f(solve_twist_limit), eff_tw, twist_limit_sign,
             twist_limit_bias, _b2f(solve_swing_motor), eff_sm, sm_vel,
             _max(ctl["swing_max_torque"], 0.0) * dt,
             _b2f(solve_twist_motor), tw_vel,
             _max(ctl["twist_max_torque"], 0.0) * dt]
    return rows

def slider_rows(js, ctl, bd, dt, inv_dt):
    """solver.prep_slider (constraints.cpp:2638-2752)."""
    rel_a, rel_b, ga, gb = _anchors(js, bd)
    ia, ib = bd["ia"], bd["ib"]
    inv_ma, inv_mb = bd["inv_ma"], bd["inv_mb"]

    axis = quat_rotate_cm(bd["qa"], js["local_axis_a"])
    tangent = get_tangent_cm(axis)
    bitangent = _cross(axis, tangent)
    u = _sub(gb, ga)
    r_au = _add(rel_a, u)
    rbxt = _cross(rel_b, tangent)
    rbxb = _cross(rel_b, bitangent)
    rauxt = _cross(r_au, tangent)
    rauxb = _cross(r_au, bitangent)

    ia_rauxt = skew_matvec(ia, rauxt)
    ia_rauxb = skew_matvec(ia, rauxb)
    ib_rbxt = skew_matvec(ib, rbxt)
    ib_rbxb = skew_matvec(ib, rbxb)
    inv_mass_sum = inv_ma + inv_mb

    m00 = _dot(rauxt, ia_rauxt) + _dot(rbxt, ib_rbxt) + inv_mass_sum
    m01 = _dot(rauxt, ia_rauxb) + _dot(rbxt, ib_rbxb)
    m10 = _dot(rauxb, ia_rauxt) + _dot(rbxb, ib_rbxt)
    m11 = _dot(rauxb, ia_rauxb) + _dot(rbxb, ib_rbxb) + inv_mass_sum

    mr = tuple(x + y for x, y in zip(ia, ib))
    tb0 = torch.where(dt > DT_THRESHOLD,
                      _dot(u, tangent) * (SLIDER_BETA * inv_dt), 0.0)
    tb1 = torch.where(dt > DT_THRESHOLD,
                      _dot(u, bitangent) * (SLIDER_BETA * inv_dt), 0.0)
    r_bias = _rotation_bias(js, bd, dt, inv_dt)

    # limit (2702-2733)
    lmin, lmax = js["limit_min"], js["limit_max"]
    dist = _dot(u, axis)
    min_v = (lmin <= 0.0) & (dist < lmin)
    max_v = (lmax >= 0.0) & (dist > lmax)
    solve_limit = min_v | max_v
    rauxs = _cross(r_au, axis)
    rbxs = _cross(rel_b, axis)
    im_ax = (inv_mass_sum + _dot(rauxs, skew_matvec(ia, rauxs))
             + _dot(rbxs, skew_matvec(ib, rbxs)))
    eff_ax = _inv_nz(im_ax)
    limit_sign = torch.where(min_v, 1.0, -1.0)
    err = torch.where(min_v, dist - lmin, lmax - dist)
    limit_bias = torch.where(dt > DT_THRESHOLD,
                             err * (SLIDER_LIMIT_BETA * inv_dt), 0.0)

    # motor (2735-2752); a disabled limit leaves the target unclamped
    # (+-3.4e38): the per-joint select replaces the JAX package's
    # trace-time branch
    solve_motor = ctl["max_force"] > 0.0
    min_l = torch.where(lmin <= 0.0, lmin, -3.4e38)
    max_l = torch.where(lmax >= 0.0, lmax, 3.4e38)
    target = _clip(ctl["target"], min_l, max_l)
    vel_p = torch.where(dt > DT_THRESHOLD, (target - dist) * inv_dt, 0.0)
    motor_vel = torch.where(ctl["motor_type"] == 1.0, vel_p, ctl["target"])

    rows = (list(rauxt) + list(rauxb) + list(rbxt) + list(rbxb)
            + list(tangent) + list(bitangent) + list(axis)
            + list(rauxs) + list(rbxs)
            + list(skew_matvec(ia, rauxs)) + list(skew_matvec(ib, rbxs))
            + list(r_bias)
            + [m00, m01, m10, m11] + [tb0, tb1] + list(mr))
    rows += [_b2f(solve_limit), eff_ax, limit_bias, limit_sign,
             _b2f(solve_motor), motor_vel,
             _max(ctl["max_force"], 0.0) * dt]
    return rows


ROW_BUILDERS = {
    "distance": distance_rows,
    "ball": ball_rows,
    "fixed": fixed_rows,
    "hinge": hinge_rows,
    "cone_twist": cone_twist_rows,
    "slider": slider_rows,
}

# controls lanes each type consumes, in the order they are packed into the
# kernel's controls table
CTL_FIELDS = {
    "distance": (),
    "ball": (),
    "fixed": (),
    "hinge": ("motor_type", "target", "max_torque"),
    "cone_twist": ("swing_motor_type", "swing_target", "swing_axis_angle",
                   "swing_max_torque", "twist_motor_type", "twist_target",
                   "twist_max_torque"),
    "slider": ("motor_type", "target", "max_force"),
}

# MotorControls attribute per type and field
CTL_ATTRS = {
    "hinge": {"motor_type": "hinge_motor_type", "target": "hinge_target",
              "max_torque": "hinge_max_torque"},
    "cone_twist": {
        "swing_motor_type": "ct_swing_motor_type",
        "swing_target": "ct_swing_target",
        "swing_axis_angle": "ct_swing_axis_angle",
        "swing_max_torque": "ct_swing_max_torque",
        "twist_motor_type": "ct_twist_motor_type",
        "twist_target": "ct_twist_target",
        "twist_max_torque": "ct_twist_max_torque"},
    "slider": {"motor_type": "slider_motor_type", "target": "slider_target",
               "max_force": "slider_max_force"},
}

# static per-joint parameter table, one layout for every type (the CUDA
# kernel indexes it by these offsets; a field a type lacks is zero).
# `length` and `init_inv_rot` come last, so the offsets of the fields before
# them are those of the hinge / cone-twist-only layout.
STATIC_FIELDS = (("anchor_a", 3), ("anchor_b", 3), ("local_axis_a", 3),
                 ("local_axis_b", 3), ("local_tangent_a", 3),
                 ("local_bitangent_a", 3), ("local_tangent_b", 3),
                 ("limit_min", 1), ("limit_max", 1),
                 ("local_axis_a_unit", 3), ("length", 1),
                 ("init_inv_rot", 4))
STATIC_WIDTH = sum(n for _f, n in STATIC_FIELDS)

# JointsOfType attribute behind each static field that is copied as it is
_STATIC_ATTRS = {"local_axis_a": "local_axis_a",
                 "local_axis_b": "local_axis_b",
                 "local_tangent_a": "local_tangent_a",
                 "local_bitangent_a": "local_bitangent_a",
                 "local_tangent_b": "local_tangent_b",
                 "limit_min": "limit_min", "limit_max": "limit_max",
                 "length": "length",
                 "init_inv_rot": "initial_inv_rotation_difference"}


def static_table(scene, name):
    """(J, STATIC_WIDTH) float32 numpy table of one joint type's static
    parameters (anchors with local_cog pre-subtracted — both are scene
    constants), in STATIC_FIELDS order; zero where the type has no such
    field."""
    if name not in ROW_BUILDERS:
        raise ValueError(f"unknown joint type {name!r}")
    j = getattr(scene, name)
    f32 = lambda x: x.detach().cpu().numpy().astype(np.float32)
    lc = f32(scene.body_params.local_cog)
    body_a = j.body_a.cpu().numpy()
    body_b = j.body_b.cpu().numpy()
    J = len(body_a)
    cols = {"anchor_a": f32(j.local_anchor_a) - lc[body_a],
            "anchor_b": f32(j.local_anchor_b) - lc[body_b]}
    for f, attr in _STATIC_ATTRS.items():
        if getattr(j, attr) is not None:
            cols[f] = f32(getattr(j, attr))
    if "local_axis_a" in cols:
        # normalize the static axis the way the JAX package's trace does:
        # the squared length in double precision, everything after in
        # float32
        axis_a = cols["local_axis_a"]
        sq = np.maximum((axis_a.astype(np.float64) ** 2).sum(-1), 1e-30)
        inv = np.float32(1.0) / np.sqrt(sq.astype(np.float32))
        cols["local_axis_a_unit"] = axis_a * inv[:, None]
    return np.concatenate(
        [cols[f].reshape(J, n) if f in cols else np.zeros((J, n), np.float32)
         for f, n in STATIC_FIELDS], axis=1)


def static_params(scene, name, device=None):
    """Static parameter dict for one joint type: vec fields as 3-tuples of
    (J,) tensors, limits as (J,) tensors — what `*_rows` takes as `js`."""
    tab = torch.from_numpy(static_table(scene, name)).to(
        device if device is not None else scene.device)
    out, c = {}, 0
    for f, n in STATIC_FIELDS:
        out[f] = (tab[:, c] if n == 1
                  else tuple(tab[:, c + i] for i in range(n)))
        c += n
    return out
