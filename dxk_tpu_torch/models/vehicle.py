"""Gear-driven vehicle — the same construction as the JAX package's
models/vehicle.py (the reference engine's vehicle.cpp): a 16-body
contraption built ONLY from standard colliders (capsule gear teeth,
cylinder wheels) plus hinge (motor + steering), fixed, slider, and ball
constraints. It exercises every constraint type and the cylinder/capsule
contact paths, which is exactly why the reference keeps it around
(BASELINE config 4).

Bodies: motor block, motor gear, drive axis, front axis, steering wheel,
steering (rack) axis, 2 wheel suspensions, 2 front wheels, differential sun
gear, differential spider gear, 2 rear wheel axes, 2 steering arms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from dxk_tpu_torch.scene.builder import (SceneBuilder,
                                         _np_quat_from_axis_angle,
                                         _np_quat_mul, _np_quat_rotate,
                                         _np_rotate_from_to)

DENSITY = 2000.0           # vehicle.cpp:305
WOOD_RESTITUTION = 0.2


def _d2r(d):
    return math.radians(d)


@dataclass
class GearDesc:
    height: float
    cylinder_radius: float
    cylinder_inner_radius: float
    num_teeth: int
    tooth_length: float
    tooth_width: float
    friction: float
    density: float


@dataclass
class WheelDesc:
    height: float
    radius: float
    inner_radius: float
    friction: float
    density: float


@dataclass
class Vehicle:
    parts: Dict[str, int]
    motor_hinge: int            # per-type hinge index of the motor constraint
    steering_hinge: int         # per-type hinge index of the steering wheel


def _add_gear_colliders(b: SceneBuilder, body: int, desc: GearDesc,
                        rod_offset: float):
    """Capsule teeth of a gear (attach(), vehicle.cpp:87-108); the gear's
    cylinder body itself has no collider in the reference either."""
    for i in range(desc.num_teeth):
        angle = i * 2.0 * math.pi / desc.num_teeth
        rot = _np_quat_from_axis_angle([0.0, 1.0, 0.0], angle)
        center = _np_quat_rotate(rot, np.array(
            [desc.cylinder_radius + desc.tooth_length * 0.5, 0.0, 0.0]))
        off = np.array([0.0, rod_offset, 0.0])
        half = _np_quat_rotate(rot, np.array([desc.tooth_length * 0.5, 0, 0]))
        b.add_capsule_collider(body, center + off - half, center + off + half,
                               desc.tooth_width * 0.5,
                               friction=desc.friction,
                               restitution=WOOD_RESTITUTION,
                               density=desc.density)


def _add_wheel_collider(b: SceneBuilder, body: int, desc: WheelDesc,
                        rod_offset: float = 0.0):
    b.add_cylinder_collider(
        body, (0.0, rod_offset - desc.height * 0.5, 0.0),
        (0.0, rod_offset + desc.height * 0.5, 0.0), desc.radius,
        friction=desc.friction, restitution=WOOD_RESTITUTION,
        density=desc.density)


def add_vehicle(b: SceneBuilder, initial_position=(0.0, 0.0, 0.0),
                initial_rotation: float = 0.0) -> Vehicle:
    """vehicle::initialize (vehicle.cpp:303-499). Returns part body ids and
    the per-type hinge indices of the motor and steering constraints (drive
    them through MotorControls)."""
    rot_q = _np_quat_from_axis_angle([0, 1, 0], initial_rotation)
    base = np.asarray(initial_position, np.float64)

    def place(pos, rot=(0.0, 0.0, 0.0, 1.0)):
        pos = _np_quat_rotate(rot_q, np.asarray(pos, np.float64)) + base
        rot = _np_quat_mul(rot_q, np.asarray(rot, np.float64))
        return pos, rot

    def gp(p):     # global point in final frame
        return _np_quat_rotate(rot_q, np.asarray(p, np.float64)) + base

    def gdir(d):
        return _np_quat_rotate(rot_q, np.asarray(d, np.float64))

    parts: Dict[str, int] = {}

    def body_at(name, pos, rot=(0.0, 0.0, 0.0, 1.0)):
        p, r = place(pos, rot)
        parts[name] = b.add_body(position=p, rotation=r)
        return parts[name]

    motor_gear_desc = GearDesc(0.1, 0.2, 0.0, 8, 0.07, 0.1, 0.0, DENSITY)
    steering_wheel_desc = GearDesc(0.1, 0.4, 0.2, 0, 0.07, 0.1, 0.0, DENSITY)
    wheel_desc = WheelDesc(0.3, 0.7, 0.28, 1.0, 50.0)
    rod_thickness = 0.05

    # motor block (vehicle.cpp:314-317)
    motor = body_at("motor", (0, 0, 0))
    b.add_box_collider(motor, (0, 0, 0), (0.6, 0.1, 1.0), friction=0.0,
                       restitution=WOOD_RESTITUTION, density=DENSITY)

    motor_gear_y = 0.25
    gear_offset = 0.26

    # motor gear + motor hinge (365-370)
    mg = body_at("motor_gear", (0, motor_gear_y, 0))
    _add_gear_colliders(b, mg, motor_gear_desc, 0.0)
    motor_hinge = b.add_hinge_constraint(motor, mg, gp((0, motor_gear_y, 0)),
                                         gdir((0, 1, 0)))

    # drive axis (372-377): gear + far-end gear attachment
    drive_axis_length = 4.5
    da_rot = _np_quat_from_axis_angle([-1, 0, 0], _d2r(90))
    da = body_at("drive_axis", (0, motor_gear_y + gear_offset, gear_offset),
                 da_rot)
    _add_gear_colliders(b, da, motor_gear_desc, 0.0)
    _add_gear_colliders(b, da, motor_gear_desc,
                        drive_axis_length * 0.57 - 1.1)
    b.add_hinge_constraint(motor, da,
                           gp((0, motor_gear_y + gear_offset, gear_offset)),
                           gdir((0, 0, 1)))

    # front axis rod (380-386)
    axis_length = 1.5
    suspension_length = 0.4
    front_axis_off_z = -drive_axis_length * 0.5 + gear_offset * 2.0
    front_axis_pos = np.array([0.0, motor_gear_y + gear_offset, front_axis_off_z])
    _add_rod(b, parts, "front_axis",
             front_axis_pos + np.array([axis_length, 0, 0]),
             front_axis_pos - np.array([axis_length, 0, 0]), place)
    b.add_fixed_constraint(motor, parts["front_axis"], gp(front_axis_pos))

    # steering wheel (388-399): position-motor hinge
    sw_rot = _np_quat_from_axis_angle([-1, 0, 0], _d2r(-80))
    sw_pos = np.array([0.0, 1.12, 0.81])
    sw = body_at("steering_wheel", sw_pos, sw_rot)
    # hollow gear: no teeth; rod attachment has no collider
    steering_hinge = b.add_hinge_constraint(
        motor, sw, gp(sw_pos), gdir(_np_quat_rotate(sw_rot, [0, -1, 0])))

    # steering rack axis (401-406): 8 capsule teeth on a slider
    sa_pos = np.array([0.0, motor_gear_y + gear_offset + 0.06,
                       front_axis_off_z + 0.49])
    sa_len = axis_length * 1.05
    sa = body_at("steering_axis", sa_pos, sw_rot)
    n_teeth = 8
    tooth_w = motor_gear_desc.tooth_width
    tooth_l = motor_gear_desc.tooth_length
    stride = (sa_len - tooth_w) / (n_teeth - 1)
    left_off = -0.5 * sa_len + 0.5 * tooth_w
    for i in range(n_teeth):
        x = left_off + i * stride
        c = np.array([x, tooth_w * 0.5, 0.0])
        b.add_capsule_collider(sa, c + np.array([0, tooth_l * 0.5, 0]),
                               c - np.array([0, tooth_l * 0.5, 0]),
                               tooth_w * 0.5, friction=0.0,
                               restitution=WOOD_RESTITUTION, density=DENSITY)
    b.add_slider_constraint(motor, sa, gp(sa_pos), gdir((1, 0, 0)),
                            -4.0, 4.0)

    left_sa_attach = sa_pos - np.array([sa_len * 0.5, 0, 0])
    right_sa_attach = sa_pos + np.array([sa_len * 0.5, 0, 0])

    # wheel suspensions (411-421): collider-less bodies on limited hinges
    l_susp_pos = front_axis_pos - np.array([axis_length, 0, 0])
    r_susp_pos = front_axis_pos + np.array([axis_length, 0, 0])
    l_susp_attach = l_susp_pos + np.array([0, 0, suspension_length])
    r_susp_attach = r_susp_pos + np.array([0, 0, suspension_length])
    body_at("left_suspension", l_susp_pos)
    body_at("right_suspension", r_susp_pos)
    b.add_hinge_constraint(motor, parts["left_suspension"], gp(l_susp_pos),
                           gdir((0, 1, 0)), _d2r(-45), _d2r(45))
    b.add_hinge_constraint(motor, parts["right_suspension"], gp(r_susp_pos),
                           gdir((0, 1, 0)), _d2r(-45), _d2r(45))

    # front wheels (424-433)
    wheel_rot = _np_quat_from_axis_angle([0, 0, 1], _d2r(90))
    l_wheel_pos = l_susp_pos - np.array([suspension_length * 0.5, 0, 0])
    r_wheel_pos = r_susp_pos + np.array([suspension_length * 0.5, 0, 0])
    lw = body_at("left_front_wheel", l_wheel_pos, wheel_rot)
    rw = body_at("right_front_wheel", r_wheel_pos, wheel_rot)
    _add_wheel_collider(b, lw, wheel_desc)
    _add_wheel_collider(b, rw, wheel_desc)
    b.add_hinge_constraint(lw, parts["left_suspension"], gp(l_wheel_pos),
                           gdir((1, 0, 0)))
    b.add_hinge_constraint(rw, parts["right_suspension"], gp(r_wheel_pos),
                           gdir((1, 0, 0)))

    # steering arms: rods + ball joints (436-443)
    _add_rod(b, parts, "left_wheel_arm", left_sa_attach, l_susp_attach, place)
    _add_rod(b, parts, "right_wheel_arm", right_sa_attach, r_susp_attach, place)
    b.add_ball_constraint(parts["left_suspension"], parts["left_wheel_arm"],
                          gp(l_susp_attach))
    b.add_ball_constraint(sa, parts["left_wheel_arm"], gp(left_sa_attach))
    b.add_ball_constraint(parts["right_suspension"], parts["right_wheel_arm"],
                          gp(r_susp_attach))
    b.add_ball_constraint(sa, parts["right_wheel_arm"], gp(right_sa_attach))

    # rear: differential (449-485)
    rear_gear_desc = GearDesc(0.1, 0.5, 0.4, 17, 0.07, 0.1, 0.0, DENSITY)
    rear_off_z = drive_axis_length * 0.505
    rear_off_x = -gear_offset
    sun_rot = _np_quat_from_axis_angle([0, 0, -1], _d2r(90))
    sun_pos = np.array([rear_off_x, motor_gear_y + gear_offset, rear_off_z])
    sun = body_at("diff_sun_gear", sun_pos, sun_rot)
    _add_gear_colliders(b, sun, rear_gear_desc, 0.0)
    b.add_hinge_constraint(motor, sun, gp(sun_pos), gdir((1, 0, 0)))

    spider_pos = np.array([0.11, motor_gear_y + gear_offset * 2.0, rear_off_z])
    spider = body_at("diff_spider_gear", spider_pos)
    _add_gear_colliders(b, spider, motor_gear_desc, 0.0)
    b.add_hinge_constraint(sun, spider, gp(spider_pos), gdir((0, 1, 0)))

    l_rear_pos = spider_pos + np.array([-gear_offset, -gear_offset, 0.0])
    r_rear_pos = spider_pos + np.array([gear_offset, -gear_offset, 0.0])
    rear_axis_rot = _np_quat_from_axis_angle([0, 0, -1], _d2r(90))
    lr = body_at("left_rear_wheel", l_rear_pos, rear_axis_rot)
    rr = body_at("right_rear_wheel", r_rear_pos, rear_axis_rot)
    _add_gear_colliders(b, lr, motor_gear_desc, 0.0)
    _add_wheel_collider(b, lr, wheel_desc,
                        rod_offset=axis_length + spider_pos[0])
    _add_gear_colliders(b, rr, motor_gear_desc, 0.0)
    _add_wheel_collider(b, rr, wheel_desc,
                        rod_offset=-(axis_length - spider_pos[0]))
    b.add_hinge_constraint(motor, lr, gp(l_rear_pos), gdir((1, 0, 0)))
    b.add_hinge_constraint(motor, rr, gp(r_rear_pos), gdir((1, 0, 0)))

    return Vehicle(parts=parts, motor_hinge=motor_hinge,
                   steering_hinge=steering_hinge)


def _add_rod(b: SceneBuilder, parts: Dict[str, int], name, frm, to, place):
    """createRod (vehicle.cpp:278-301): a collider-less body oriented along
    from->to (its mass defaults to 1, like the reference ctor)."""
    frm = np.asarray(frm, np.float64)
    to = np.asarray(to, np.float64)
    pos = (frm + to) * 0.5
    axis = (to - frm) / np.linalg.norm(to - frm)
    rot = _np_rotate_from_to([0.0, 1.0, 0.0], axis)
    p, r = place(pos, rot)
    parts[name] = b.add_body(position=p, rotation=r)
    return parts[name]
