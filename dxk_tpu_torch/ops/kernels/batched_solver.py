"""Shared solve machinery of the fused step: per-type joint solves, the
contact point solve, packed row layouts — the plain PyTorch form of what
``csrc/fused_step.cu`` runs per iteration.

Solver semantics (those of the JAX package's ``ops/pallas/batched_solver.py``
in its averaged mode): per-type averaged-Jacobi joint passes in the
reference's type order, degree-averaged per body; contact manifolds solved
point-sequential in-row against the slice-start velocities.

Lanes are (B, rows) tensors: env batch leading, constraint rows minor.
All joints of one type are solved at once (one lane per joint), which is
the same arithmetic as the JAX package's joint-by-joint unrolled loop
because the averaged mode reads every joint's velocities before any
write-back.

The sequential mode (`_solve_joint_type_seq`, the JAX package's
``_solve_joint_type(sequential=True)``) solves one joint at a time on
(B,) lanes and stores both bodies' new velocity rows before the next
joint reads them: reference Gauss-Seidel. `pack_joint_type` packs a joint
prep of ops/solver.py into the (B, J * ROWS) table the fused step takes
when its joint rows are prepared outside the kernel.

Ported: contacts and all six joint types, averaged and sequential.
"""

from __future__ import annotations

import numpy as np
import torch

from dxk_tpu_torch.ops.kernels.cm_narrowphase import _clip, _max
from dxk_tpu_torch.scene.scene import JOINT_TYPES

# max contact points a narrowphase recipe can emit, by sorted (typeA,typeB)
# (ops/narrowphase.py: sphere* analytic single point; capsule-capsule /
# capsule-box / cylinder segment clips <=2; box-box Sutherland-Hodgman +
# 4-point reduction; hulls single EPA contact)
# type ids: 0=sphere 1=capsule 2=cylinder 3=box 4=hull
TYPE_MAX_POINTS = {
    (0, 0): 1, (0, 1): 1, (0, 2): 1, (0, 3): 1, (0, 4): 1,
    (1, 1): 2, (1, 2): 2, (1, 3): 2, (1, 4): 1,
    # cylinder pairs emit 4-point cap rings (cap-on-cap / cap-on-face,
    # narrowphase.cylinder_{cylinder,box}_contact) — K=2 would silently
    # truncate the ring in the fused prep-passed path (_pack_passed)
    (2, 2): 4, (2, 3): 4, (2, 4): 1,
    # box-hull and hull-hull emit clipped <=4-point manifolds
    # (cm_polytope SAT+clip, round 3)
    (3, 3): 4, (3, 4): 4,
    (4, 4): 4,
}

VEC_FIELDS = ("rel_a", "rel_b", "normal", "tangent",
              "n_to_wa", "n_to_wb", "t_to_wa", "t_to_wb")
SCAL_FIELDS = ("eff_mass_n", "eff_mass_t", "bias", "friction")

HINGE_VECS = ("rel_a", "rel_b", "translation_bias", "bxa", "cxa", "axis",
              "ml_to_wa", "ml_to_wb")
HINGE_SCALS = ("eff_axial_mass", "solve_limit", "solve_motor", "limit_sign",
               "limit_bias", "motor_velocity", "max_motor_impulse")
CT_VECS = ("rel_a", "rel_b", "bias", "swing_axis", "sl_to_wa", "sl_to_wb",
           "twist_axis", "tw_to_wa", "tw_to_wb", "swing_motor_axis",
           "sm_to_wa", "sm_to_wb")
CT_SCALS = ("solve_swing_limit", "eff_swing_limit_mass", "swing_limit_bias",
            "solve_twist_limit", "eff_twist_mass", "twist_limit_sign",
            "twist_limit_bias", "solve_swing_motor", "eff_swing_motor_mass",
            "swing_motor_velocity", "max_swing_motor_impulse",
            "solve_twist_motor", "twist_motor_velocity",
            "max_twist_motor_impulse")

# packed rows per joint: vec fields + mt(9) + mr(4) + rot_bias(2) + scalars
HINGE_ROWS = len(HINGE_VECS) * 3 + 9 + 4 + 2 + len(HINGE_SCALS)
CT_ROWS = len(CT_VECS) * 3 + 9 + len(CT_SCALS)

# distance / ball / fixed / slider layouts (reference SIMD paths
# constraints.cpp:189-459, 460-735, 736-1078, 2638-3306)
DIST_VECS = ("rel_a", "rel_b", "u", "to_wa", "to_wb")
DIST_SCALS = ("bias", "eff_mass")
DIST_ROWS = len(DIST_VECS) * 3 + len(DIST_SCALS)
BALL_VECS = ("rel_a", "rel_b", "bias")
BALL_SCALS = ()
BALL_ROWS = len(BALL_VECS) * 3 + 9                       # + inv_eff_mass
FIXED_VECS = ("rel_a", "rel_b", "translation_bias", "rotation_bias")
FIXED_SCALS = ()
FIXED_ROWS = len(FIXED_VECS) * 3 + 9 + 9                 # + mt + mr
SLIDER_VECS = ("r_au_x_t", "r_au_x_b", "r_b_x_t", "r_b_x_b", "tangent",
               "bitangent", "axis", "r_au_x_s", "r_b_x_s", "l_to_wa",
               "l_to_wb", "rotation_bias")
SLIDER_SCALS = ("solve_limit", "eff_axial_mass", "limit_bias", "limit_sign",
                "solve_motor", "motor_velocity", "max_motor_impulse")
SLIDER_ROWS = len(SLIDER_VECS) * 3 + 4 + 2 + 9 + len(SLIDER_SCALS)


# reference solve order within one iteration (constraints.cpp:3748-3772);
# contacts come after all joint types
JOINT_ORDER = JOINT_TYPES


def phase_partition(phases):
    """Group indices by ascending phase value (input already sorted):
    [[g, ...], ...] — contact phases run as sequential Gauss-Seidel slices
    (solver._contact_phased_pass semantics)."""
    out, last = [], None
    for g, ph in enumerate(phases):
        if ph != last:
            out.append([])
            last = ph
        out[-1].append(g)
    return out


# ===========================================================================
# component-math helpers on (B, rows)-shaped lanes


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _muls(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _matvec(m, v):
    """m: 9-tuple row-major, v: v3."""
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])


def _inv_nz(x):
    return torch.where(x != 0.0, 1.0 / torch.where(x != 0.0, x, 1.0), 0.0)


def _solve_2x2(a11, a12, a21, a22, b0, b1):
    det = a11 * a22 - a12 * a21
    inv = _inv_nz(det)
    return inv * (a22 * b0 - a12 * b1), inv * (a11 * b1 - a21 * b0)


def _solve_3x3(m, b):
    """Cramer's rule on columns (math.cpp:1356-1372). m 9-tuple row-major."""
    ex = (m[0], m[3], m[6])
    ey = (m[1], m[4], m[7])
    ez = (m[2], m[5], m[8])
    det = _dot(ex, _cross(ey, ez))
    inv = _inv_nz(det)
    return (inv * _dot(b, _cross(ey, ez)),
            inv * _dot(ex, _cross(b, ez)),
            inv * _dot(ex, _cross(ey, b)))



# ===========================================================================
# per-constraint solves on component lanes


def _contact_point(cv, cs, inv_ma, inv_mb, va, wa, vb, wb, imp_n, imp_t):
    """Friction then normal (constraints.cpp:3404-3442); all args
    (B, Pg)-shaped lanes / v3 tuples of them."""
    rel_a, rel_b, nrm, tan, twa_n, twb_n, twa_t, twb_t = cv
    eff_n, eff_t, bias, fric = cs

    av = _add(va, _cross(wa, rel_a))
    bv = _add(vb, _cross(wb, rel_b))
    vt = _dot(tan, _sub(bv, av))
    lam = -eff_t * vt
    max_f = fric * imp_n
    new = _clip(imp_t + lam, -max_f, max_f)
    lam = new - imp_t
    imp_t = new
    va = _sub(va, _muls(tan, inv_ma * lam))
    wa = _sub(wa, _muls(twa_t, lam))
    vb = _add(vb, _muls(tan, inv_mb * lam))
    wb = _add(wb, _muls(twb_t, lam))

    av = _add(va, _cross(wa, rel_a))
    bv = _add(vb, _cross(wb, rel_b))
    vn = _dot(nrm, _sub(bv, av))
    lam = -eff_n * (vn - bias)
    new = _max(imp_n + lam, 0.0)
    lam = new - imp_n
    imp_n = new
    va = _sub(va, _muls(nrm, inv_ma * lam))
    wa = _sub(wa, _muls(twa_n, lam))
    vb = _add(vb, _muls(nrm, inv_mb * lam))
    wb = _add(wb, _muls(twb_n, lam))
    return va, wa, vb, wb, imp_n, imp_t


def _hinge_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
               limit_imp, motor_imp):
    """Motor -> limit -> rotation -> position (constraints.cpp:1215-1306).
    f: dict of (B, J)-shaped fields; inv_i*: 9-tuples."""
    axis = f["axis"]
    # motor
    rel_w = _dot(axis, wb) - _dot(axis, wa)
    cdot = rel_w - f["motor_velocity"]
    lam = -f["eff_axial_mass"] * cdot
    new = _clip(motor_imp + lam, -f["max_motor_impulse"],
                   f["max_motor_impulse"])
    on = f["solve_motor"] > 0.5
    lam = torch.where(on, new - motor_imp, 0.0)
    motor_imp = torch.where(on, new, motor_imp)
    wa = _sub(wa, _muls(f["ml_to_wa"], lam))
    wb = _add(wb, _muls(f["ml_to_wb"], lam))

    # limit
    rel_w = f["limit_sign"] * (_dot(axis, wb) - _dot(axis, wa))
    cdot = rel_w + f["limit_bias"]
    lam = -f["eff_axial_mass"] * cdot
    imp = _max(limit_imp + lam, 0.0)
    on = f["solve_limit"] > 0.5
    lam = torch.where(on, imp - limit_imp, 0.0)
    limit_imp = torch.where(on, imp, limit_imp)
    lam = lam * f["limit_sign"]
    wa = _sub(wa, _muls(f["ml_to_wa"], lam))
    wb = _add(wb, _muls(f["ml_to_wb"], lam))

    # rotation (2D)
    dw = _sub(wb, wa)
    c0 = _dot(f["bxa"], dw) + f["rot_bias0"]
    c1 = _dot(f["cxa"], dw) + f["rot_bias1"]
    l0, l1 = _solve_2x2(f["mr00"], f["mr01"], f["mr10"], f["mr11"],
                        -c0, -c1)
    rot_p = _add(_muls(f["bxa"], l0), _muls(f["cxa"], l1))
    wa = _sub(wa, _matvec(inv_ia, rot_p))
    wb = _add(wb, _matvec(inv_ib, rot_p))

    # position (3D)
    av = _add(va, _cross(wa, f["rel_a"]))
    bv = _add(vb, _cross(wb, f["rel_b"]))
    cdot3 = _add(_sub(bv, av), f["translation_bias"])
    P = _solve_3x3(f["mt"], tuple(-c for c in cdot3))
    va = _sub(va, _muls(P, inv_ma))
    wa = _sub(wa, _matvec(inv_ia, _cross(f["rel_a"], P)))
    vb = _add(vb, _muls(P, inv_mb))
    wb = _add(wb, _matvec(inv_ib, _cross(f["rel_b"], P)))
    return va, wa, vb, wb, limit_imp, motor_imp


def _cone_twist_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
                    swing_imp, twist_imp, sm_imp, tm_imp):
    """Twist motor -> swing motor -> twist limit -> swing limit -> position
    (constraints.cpp:1955-2068)."""
    # twist motor
    rel_w = _dot(f["twist_axis"], wb) - _dot(f["twist_axis"], wa)
    cdot = rel_w - f["twist_motor_velocity"]
    lam = -f["eff_twist_mass"] * cdot
    new = _clip(tm_imp + lam, -f["max_twist_motor_impulse"],
                   f["max_twist_motor_impulse"])
    on = f["solve_twist_motor"] > 0.5
    lam = torch.where(on, new - tm_imp, 0.0)
    tm_imp = torch.where(on, new, tm_imp)
    wa = _sub(wa, _muls(f["tw_to_wa"], lam))
    wb = _add(wb, _muls(f["tw_to_wb"], lam))

    # swing motor
    rel_w = _dot(f["swing_motor_axis"], wb) - _dot(f["swing_motor_axis"], wa)
    cdot = rel_w - f["swing_motor_velocity"]
    lam = -f["eff_swing_motor_mass"] * cdot
    new = _clip(sm_imp + lam, -f["max_swing_motor_impulse"],
                   f["max_swing_motor_impulse"])
    on = f["solve_swing_motor"] > 0.5
    lam = torch.where(on, new - sm_imp, 0.0)
    sm_imp = torch.where(on, new, sm_imp)
    wa = _sub(wa, _muls(f["sm_to_wa"], lam))
    wb = _add(wb, _muls(f["sm_to_wb"], lam))

    # twist limit
    rel_w = f["twist_limit_sign"] * (_dot(f["twist_axis"], wb)
                                     - _dot(f["twist_axis"], wa))
    cdot = rel_w + f["twist_limit_bias"]
    lam = -f["eff_twist_mass"] * cdot
    imp = _max(twist_imp + lam, 0.0)
    on = f["solve_twist_limit"] > 0.5
    lam = torch.where(on, imp - twist_imp, 0.0)
    twist_imp = torch.where(on, imp, twist_imp)
    lam = lam * f["twist_limit_sign"]
    wa = _sub(wa, _muls(f["tw_to_wa"], lam))
    wb = _add(wb, _muls(f["tw_to_wb"], lam))

    # swing limit (reversed signs, constraints.cpp:2035-2048)
    cdot = (_dot(f["swing_axis"], wa) - _dot(f["swing_axis"], wb)
            + f["swing_limit_bias"])
    lam = -f["eff_swing_limit_mass"] * cdot
    imp = _max(swing_imp + lam, 0.0)
    on = f["solve_swing_limit"] > 0.5
    lam = torch.where(on, imp - swing_imp, 0.0)
    swing_imp = torch.where(on, imp, swing_imp)
    wa = _add(wa, _muls(f["sl_to_wa"], lam))
    wb = _sub(wb, _muls(f["sl_to_wb"], lam))

    # position
    av = _add(va, _cross(wa, f["rel_a"]))
    bv = _add(vb, _cross(wb, f["rel_b"]))
    cdot3 = _add(_sub(bv, av), f["bias"])
    P = _solve_3x3(f["m"], tuple(-c for c in cdot3))
    va = _sub(va, _muls(P, inv_ma))
    wa = _sub(wa, _matvec(inv_ia, _cross(f["rel_a"], P)))
    vb = _add(vb, _muls(P, inv_mb))
    wb = _add(wb, _matvec(inv_ib, _cross(f["rel_b"], P)))
    return va, wa, vb, wb, swing_imp, twist_imp, sm_imp, tm_imp


def _distance_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb):
    """_distance_solve_one (constraints.cpp:244-263 with the corrected
    torque arm). Inertia args unused (uniform joint-solve signature)."""
    av = _add(va, _cross(wa, f["rel_a"]))
    bv = _add(vb, _cross(wb, f["rel_b"]))
    cdot = _dot(f["u"], _sub(bv, av)) + f["bias"]
    lam = -f["eff_mass"] * cdot
    va = _sub(va, _muls(f["u"], inv_ma * lam))
    wa = _sub(wa, _muls(f["to_wa"], lam))
    vb = _add(vb, _muls(f["u"], inv_mb * lam))
    wb = _add(wb, _muls(f["to_wb"], lam))
    return va, wa, vb, wb


def _ball_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb):
    """_ball_solve_one (constraints.cpp:508-527)."""
    av = _add(va, _cross(wa, f["rel_a"]))
    bv = _add(vb, _cross(wb, f["rel_b"]))
    cdot = _add(_sub(bv, av), f["bias"])
    P = _solve_3x3(f["m"], tuple(-c for c in cdot))
    va = _sub(va, _muls(P, inv_ma))
    wa = _sub(wa, _matvec(inv_ia, _cross(f["rel_a"], P)))
    vb = _add(vb, _muls(P, inv_mb))
    wb = _add(wb, _matvec(inv_ib, _cross(f["rel_b"], P)))
    return va, wa, vb, wb


def _fixed_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb):
    """_fixed_solve_one (constraints.cpp:787-822): rotation then
    position."""
    cdot = _sub(wb, wa)
    rhs = tuple(-(c + rb) for c, rb in zip(cdot, f["rotation_bias"]))
    lam = _solve_3x3(f["mr"], rhs)
    wa = _sub(wa, _matvec(inv_ia, lam))
    wb = _add(wb, _matvec(inv_ib, lam))

    av = _add(va, _cross(wa, f["rel_a"]))
    bv = _add(vb, _cross(wb, f["rel_b"]))
    cdot = _add(_sub(bv, av), f["translation_bias"])
    P = _solve_3x3(f["mt"], tuple(-c for c in cdot))
    va = _sub(va, _muls(P, inv_ma))
    wa = _sub(wa, _matvec(inv_ia, _cross(f["rel_a"], P)))
    vb = _add(vb, _muls(P, inv_mb))
    wb = _add(wb, _matvec(inv_ib, _cross(f["rel_b"], P)))
    return va, wa, vb, wb


def _slider_one(f, inv_ma, inv_mb, inv_ia, inv_ib, va, wa, vb, wb,
                limit_imp, motor_imp):
    """_slider_solve_one (constraints.cpp:2761-2845): motor -> limit ->
    rotation -> position."""
    axis = f["axis"]
    # motor (pure linear along axis)
    cdot = _dot(vb, axis) - _dot(va, axis) - f["motor_velocity"]
    mass = _inv_nz(inv_ma + inv_mb)
    lam = -mass * cdot
    new = _clip(motor_imp + lam, -f["max_motor_impulse"],
                f["max_motor_impulse"])
    on = f["solve_motor"] > 0.5
    lam = torch.where(on, new - motor_imp, 0.0)
    motor_imp = torch.where(on, new, motor_imp)
    va = _sub(va, _muls(axis, inv_ma * lam))
    vb = _add(vb, _muls(axis, inv_mb * lam))

    # limit
    cdot = (_dot(vb, axis) + _dot(wb, f["r_b_x_s"])
            - _dot(va, axis) - _dot(wa, f["r_au_x_s"]))
    lam = -f["eff_axial_mass"] * (f["limit_sign"] * cdot + f["limit_bias"])
    imp = _max(limit_imp + lam, 0.0)
    on = f["solve_limit"] > 0.5
    lam = torch.where(on, imp - limit_imp, 0.0)
    limit_imp = torch.where(on, imp, limit_imp)
    lam = lam * f["limit_sign"]
    va = _sub(va, _muls(axis, inv_ma * lam))
    wa = _sub(wa, _muls(f["l_to_wa"], lam))
    vb = _add(vb, _muls(axis, inv_mb * lam))
    wb = _add(wb, _muls(f["l_to_wb"], lam))

    # rotation (3D)
    cdot = _sub(wb, wa)
    rhs = tuple(-(c + rb) for c, rb in zip(cdot, f["rotation_bias"]))
    lam3 = _solve_3x3(f["mr"], rhs)
    wa = _sub(wa, _matvec(inv_ia, lam3))
    wb = _add(wb, _matvec(inv_ib, lam3))

    # position (2D in the plane normal to the slider axis)
    cx = (_dot(f["tangent"], vb) + _dot(f["r_b_x_t"], wb)
          - _dot(f["tangent"], va) - _dot(f["r_au_x_t"], wa))
    cy = (_dot(f["bitangent"], vb) + _dot(f["r_b_x_b"], wb)
          - _dot(f["bitangent"], va) - _dot(f["r_au_x_b"], wa))
    l0, l1 = _solve_2x2(f["mt00"], f["mt01"], f["mt10"], f["mt11"],
                        -(cx + f["tb0"]), -(cy + f["tb1"]))
    tbv = _add(_muls(f["tangent"], l0), _muls(f["bitangent"], l1))
    va = _sub(va, _muls(tbv, inv_ma))
    wa = _sub(wa, _matvec(
        inv_ia, _add(_muls(f["r_au_x_t"], l0), _muls(f["r_au_x_b"], l1))))
    vb = _add(vb, _muls(tbv, inv_mb))
    wb = _add(wb, _matvec(
        inv_ib, _add(_muls(f["r_b_x_t"], l0), _muls(f["r_b_x_b"], l1))))
    return va, wa, vb, wb, limit_imp, motor_imp


# ===========================================================================
# packed joint rows -> field dicts (layout shared with cm_joint_prep's row
# builders and with the CUDA kernel's shared-memory joint tables)


def _vec_fields(rows, names, f):
    """Read len(names) 3-lane vectors from the front of `rows` into `f`;
    returns the next row."""
    r = 0
    for name in names:
        f[name] = (rows[r], rows[r + 1], rows[r + 2])
        r += 3
    return r


def _dist_field_rows(rows):
    f = {}
    r = _vec_fields(rows, DIST_VECS, f)
    for name in DIST_SCALS:
        f[name] = rows[r]
        r += 1
    return f


def _ball_field_rows(rows):
    f = {}
    r = _vec_fields(rows, BALL_VECS, f)
    f["m"] = tuple(rows[r + i] for i in range(9))
    return f


def _fixed_field_rows(rows):
    f = {}
    r = _vec_fields(rows, FIXED_VECS, f)
    f["mt"] = tuple(rows[r + i] for i in range(9)); r += 9
    f["mr"] = tuple(rows[r + i] for i in range(9))
    return f


def _slider_field_rows(rows):
    f = {}
    r = _vec_fields(rows, SLIDER_VECS, f)
    f["mt00"], f["mt01"], f["mt10"], f["mt11"] = rows[r:r + 4]
    r += 4
    f["tb0"], f["tb1"] = rows[r], rows[r + 1]
    r += 2
    f["mr"] = tuple(rows[r + i] for i in range(9)); r += 9
    for name in SLIDER_SCALS:
        f[name] = rows[r]
        r += 1
    return f


def _hinge_field_rows(rows):
    """Field dict of the hinges from their packed row list (HINGE_ROWS
    lanes)."""
    f = {}
    r = _vec_fields(rows, HINGE_VECS, f)
    f["mt"] = tuple(rows[r + i] for i in range(9)); r += 9
    f["mr00"], f["mr01"], f["mr10"], f["mr11"] = rows[r:r + 4]
    r += 4
    f["rot_bias0"] = rows[r]; r += 1
    f["rot_bias1"] = rows[r]; r += 1
    for name in HINGE_SCALS:
        f[name] = rows[r]
        r += 1
    return f


def _ct_field_rows(rows):
    f = {}
    r = _vec_fields(rows, CT_VECS, f)
    f["m"] = tuple(rows[r + i] for i in range(9)); r += 9
    for name in CT_SCALS:
        f[name] = rows[r]
        r += 1
    return f


# name -> (rows, reader, solve, n_acc)
JOINT_SPECS = {
    "distance": (DIST_ROWS, _dist_field_rows, _distance_one, 0),
    "ball": (BALL_ROWS, _ball_field_rows, _ball_one, 0),
    "fixed": (FIXED_ROWS, _fixed_field_rows, _fixed_one, 0),
    "hinge": (HINGE_ROWS, _hinge_field_rows, _hinge_one, 2),
    "cone_twist": (CT_ROWS, _ct_field_rows, _cone_twist_one, 4),
    "slider": (SLIDER_ROWS, _slider_field_rows, _slider_one, 2),
}


def joint_rows(name):
    return JOINT_SPECS[name][0]


def _solve_joint_type(name, idx_a, idx_b, rows, vw, inv_mass, inv_inertia,
                      inv_deg, omega, accs):
    """One averaged-Jacobi pass over all joints of one type.

    vw (B, NB, 6); idx_a/idx_b (J,) int64 body indices; rows: packed field
    lanes, each (B, J); inv_mass (NB,); inv_inertia (B, NB, 3, 3);
    inv_deg (NB,) static inverse degrees of this type; accs: tuple of
    (B, J) accumulated impulses. Every joint reads the pass-start
    velocities; the per-body sums of the deltas are scaled by
    omega * inv_deg. Returns (vw, new_accs)."""
    _rows, reader, solve, _n_acc = JOINT_SPECS[name]
    ua = vw[:, idx_a]                                   # (B, J, 6)
    ub = vw[:, idx_b]
    va = tuple(ua[..., c] for c in range(3))
    wa = tuple(ua[..., c + 3] for c in range(3))
    vb = tuple(ub[..., c] for c in range(3))
    wb = tuple(ub[..., c + 3] for c in range(3))
    ia = inv_inertia[:, idx_a].reshape(vw.shape[0], -1, 9)
    ib = inv_inertia[:, idx_b].reshape(vw.shape[0], -1, 9)
    inv_ia = tuple(ia[..., i] for i in range(9))
    inv_ib = tuple(ib[..., i] for i in range(9))
    out = solve(reader(rows), inv_mass[idx_a], inv_mass[idx_b],
                inv_ia, inv_ib, va, wa, vb, wb, *accs)
    nva, nwa, nvb, nwb = out[:4]
    da = torch.stack(list(_sub(nva, va)) + list(_sub(nwa, wa)), dim=-1)
    db = torch.stack(list(_sub(nvb, vb)) + list(_sub(nwb, wb)), dim=-1)
    # per-body sums in joint order, a-side before b-side
    d = torch.stack([da, db], dim=2).reshape(vw.shape[0], -1, 6)
    idx = torch.stack([idx_a, idx_b], dim=1).reshape(-1)
    delta = torch.zeros_like(vw).index_add_(1, idx, d)
    vw = vw + delta * (omega * inv_deg)[None, :, None]
    return vw, tuple(out[4:])


def _solve_joint_type_seq(name, ab, fields, vw, inv_mass, inv_inertia, accs):
    """One sequential pass over the joints of one type, in order: each
    joint solves against the current velocities and its two bodies' new
    [v|w] rows are stored into `vw` (B, NB, 6), in place, before the next
    joint reads them.

    ab: [(a, b), ...] body indices; fields[j]: joint j's field dict of
    (B,) lanes; accs: tuple of per-joint lists of (B,) accumulated
    impulses. Returns the new accs."""
    _rows, _reader, solve, n_acc = JOINT_SPECS[name]
    B = vw.shape[0]
    new = tuple([] for _ in range(n_acc))
    for j, (a, b) in enumerate(ab):
        ua, ub = vw[:, a], vw[:, b]
        ia = inv_inertia[:, a].reshape(B, 9)
        ib = inv_inertia[:, b].reshape(B, 9)
        out = solve(fields[j], inv_mass[a], inv_mass[b],
                    tuple(ia[:, i] for i in range(9)),
                    tuple(ib[:, i] for i in range(9)),
                    tuple(ua[:, c] for c in range(3)),
                    tuple(ua[:, c] for c in range(3, 6)),
                    tuple(ub[:, c] for c in range(3)),
                    tuple(ub[:, c] for c in range(3, 6)),
                    *[acc[j] for acc in accs])
        row_a = torch.stack(list(out[0]) + list(out[1]), dim=-1)
        row_b = torch.stack(list(out[2]) + list(out[3]), dim=-1)
        vw[:, a] = row_a
        vw[:, b] = row_b
        for lst, val in zip(new, out[4:]):
            lst.append(val)
    return new


# ===========================================================================
# joint preps (ops/solver.py) -> packed tables


def _joint_extra_hinge(h):
    extra = [h.inv_eff_trans_mass[..., i, j]
             for i in range(3) for j in range(3)]
    extra += [h.inv_eff_rot_mass[..., 0, 0], h.inv_eff_rot_mass[..., 0, 1],
              h.inv_eff_rot_mass[..., 1, 0], h.inv_eff_rot_mass[..., 1, 1]]
    extra += [h.rotation_bias[..., 0], h.rotation_bias[..., 1]]
    return extra


def _joint_extra_ct(c):
    return [c.inv_eff_mass[..., i, j] for i in range(3) for j in range(3)]


def _joint_extra_dist(_d):
    return []


def _joint_extra_ball(b):
    return [b.inv_eff_mass[..., i, j] for i in range(3) for j in range(3)]


def _joint_extra_fixed(x):
    extra = [x.inv_eff_trans_mass[..., i, j]
             for i in range(3) for j in range(3)]
    extra += [x.inv_eff_rot_mass[..., i, j]
              for i in range(3) for j in range(3)]
    return extra


def _joint_extra_slider(s):
    extra = [s.inv_eff_trans_mass[..., 0, 0], s.inv_eff_trans_mass[..., 0, 1],
             s.inv_eff_trans_mass[..., 1, 0], s.inv_eff_trans_mass[..., 1, 1]]
    extra += [s.translation_bias[..., 0], s.translation_bias[..., 1]]
    extra += [s.inv_eff_rot_mass[..., i, j]
              for i in range(3) for j in range(3)]
    return extra


# name -> (vec fields, scalar fields, extra rows) of the packed layout; the
# row order is the one the _*_field_rows readers above consume
PACK_SPECS = {
    "distance": (DIST_VECS, DIST_SCALS, _joint_extra_dist),
    "ball": (BALL_VECS, BALL_SCALS, _joint_extra_ball),
    "fixed": (FIXED_VECS, FIXED_SCALS, _joint_extra_fixed),
    "hinge": (HINGE_VECS, HINGE_SCALS, _joint_extra_hinge),
    "cone_twist": (CT_VECS, CT_SCALS, _joint_extra_ct),
    "slider": (SLIDER_VECS, SLIDER_SCALS, _joint_extra_slider),
}


def _pack_joint(prep, vec_names, scal_names, extra):
    """(B, J*R) with column j*R + r (row r of joint j)."""
    rows = []
    for name in vec_names:
        v = getattr(prep, name)                  # (B, J, 3)
        rows.extend([v[..., i] for i in range(3)])
    rows.extend(extra)
    for name in scal_names:
        rows.append(getattr(prep, name).to(torch.float32))
    shape = torch.broadcast_shapes(*[r.shape for r in rows])
    t = torch.stack([r.expand(shape) for r in rows], dim=2)   # (B, J, R)
    return t.reshape(t.shape[0], -1)


def pack_joint_type(name, prep):
    """(B, J * ROWS) packed table of one joint type's prep (ops/solver.py),
    joint-major: column j * ROWS + r is row r of joint j."""
    vecs, scals, extra_fn = PACK_SPECS[name]
    return _pack_joint(prep, vecs, scals, extra_fn(prep))


def static_joint_invdeg(scene, nbody):
    """(6, nbody) 1/degree per joint type — scene constants (wiring is
    static)."""
    out = np.ones((len(JOINT_ORDER), nbody), np.float32)
    for row, name in enumerate(JOINT_ORDER):
        joint = getattr(scene, name)
        if joint is None:
            continue
        deg = np.zeros(nbody, np.float32)
        for n in joint.body_a.cpu().numpy():
            deg[n] += 1
        for n in joint.body_b.cpu().numpy():
            deg[n] += 1
        out[row] = 1.0 / np.maximum(deg, 1.0)
    return out


def scene_joint_ab(scene):
    """[(name, [(a, b), ...])] for every joint type present in the scene,
    in reference solve order."""
    out = []
    for name in JOINT_ORDER:
        joint = getattr(scene, name)
        if joint is not None and joint.body_a.shape[0] > 0:
            out.append((name, list(zip(joint.body_a.cpu().tolist(),
                                       joint.body_b.cpu().tolist()))))
    return out
