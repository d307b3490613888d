"""Host-side scene construction.

`SceneBuilder` describes bodies, colliders and joints imperatively, then
`finalize()` bakes everything into static tensors — collider tables,
per-body mass properties, pre-pruned candidate-pair buckets and joint
parameter arrays. Everything up to `finalize` is plain numpy (float64, as
in the JAX package, so both builders round the same values to float32);
`finalize(device=...)` converts to tensors on the requested device.

Ported so far: rigid bodies, statics, sphere/capsule/cylinder/box colliders,
convex hull geometry (from triangle faces or a point cloud) and hull
colliders, heightfield terrain, all six joint types, grid cloths, global
and localized force fields, trigger volumes and their overlap tables,
static pair tables (capped or not, in contact phases or not, pruned by
`candidate_margin` or `orbit_margin` or not) and the K-select /
sort-and-sweep broadphase settings: everything the JAX package's builder
does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dxk_tpu_torch.ops.heightmap import make_heightfield
from dxk_tpu_torch.scene.scene import (
    SHAPE_SPHERE, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_BOX, SHAPE_HULL,
    OWNER_RIGID_BODY, OWNER_STATIC, OWNER_FORCE_FIELD, OWNER_TRIGGER,
    BodyParams, ClothParams, Colliders, HullGeometry, JointsOfType,
    MotorControls, PairGroup, Scene, resolve_device,
)

GRAVITY = -9.81


# ---------------------------------------------------------------------------
# numpy quaternion helpers (host side)

def _np_quat_mul(a, b):
    av, aw = a[:3], a[3]
    bv, bw = b[:3], b[3]
    w = aw * bw - np.dot(av, bv)
    v = av * bw + bv * aw + np.cross(av, bv)
    return np.array([*v, w], np.float64)


def _np_quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float64)


def _np_quat_rotate(q, v):
    u, w = np.asarray(q[:3], np.float64), q[3]
    uv = np.cross(u, v)
    return np.asarray(v) + 2.0 * (w * uv + np.cross(u, uv))


def _np_quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    h = angle * 0.5
    return np.array([*(axis * math.sin(h)), math.cos(h)], np.float64)


def _np_rotate_from_to(f, t):
    f = np.asarray(f, np.float64); f = f / np.linalg.norm(f)
    t = np.asarray(t, np.float64); t = t / np.linalg.norm(t)
    d = float(np.dot(f, t))
    if d >= 1.0:
        return np.array([0.0, 0.0, 0.0, 1.0])
    if d < 1e-6 - 1.0:
        axis = np.cross([1.0, 0.0, 0.0], f)
        if np.dot(axis, axis) == 0.0:
            axis = np.cross([0.0, 1.0, 0.0], f)
        axis = axis / np.linalg.norm(axis)
        return np.array([*axis, 0.0])
    s = math.sqrt((1.0 + d) * 2.0)
    c = np.cross(f, t) / s
    q = np.array([*c, s * 0.5])
    return q / np.linalg.norm(q)


def _np_quat_to_mat3(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _np_get_tangents(n):
    n = np.asarray(n, np.float64)
    if abs(n[0]) >= 0.57735:
        t = np.array([n[1], -n[0], 0.0])
    else:
        t = np.array([0.0, n[2], -n[1]])
    t = t / np.linalg.norm(t)
    return t, np.cross(n, t)


@dataclass
class _Collider:
    ctype: int
    a: np.ndarray
    b: np.ndarray
    r: float
    rot: np.ndarray
    friction: float
    restitution: float
    density: float
    body: int          # -1 = no body
    owner_type: int
    owner_index: int
    hull_id: int


@dataclass
class _Body:
    position: np.ndarray
    rotation: np.ndarray
    kinematic: bool
    gravity_factor: float
    linear_damping: float
    angular_damping: float
    colliders: List[int] = field(default_factory=list)


@dataclass
class _Joint:
    kind: str
    body_a: int
    body_b: int
    params: dict


class SceneBuilder:
    """Imperative scene description -> baked `Scene`."""

    def __init__(self):
        self._bodies: List[_Body] = []
        self._colliders: List[_Collider] = []
        self._joints: List[_Joint] = []
        self._hull_geoms: List[np.ndarray] = []
        self._hull_props: list = []     # (mass, cog, inertia) per density
        self._hull_faces: list = []     # (normals, offsets) per hull
        self._heightfield: Optional[dict] = None
        self._cloths: list = []         # add_cloth's arguments per cloth
        self._force_fields: list = []   # {"force", "owner"} per field
        self._num_triggers = 0
        self.max_narrow_pairs_per_group: Optional[int] = None

    # -- bodies --------------------------------------------------------

    def add_body(self, position=(0, 0, 0), rotation=(0, 0, 0, 1),
                 kinematic=False, gravity_factor=1.0,
                 linear_damping=0.4, angular_damping=0.4) -> int:
        """Create a rigid body (reference rigid_body_component ctor,
        rigid_body.cpp:6-27; default dampings rigid_body.h:21)."""
        self._bodies.append(_Body(
            np.asarray(position, np.float64),
            np.asarray(rotation, np.float64),
            kinematic, gravity_factor, linear_damping, angular_damping))
        return len(self._bodies) - 1

    def add_static(self, position=(0, 0, 0), rotation=(0, 0, 0, 1)) -> int:
        """A static collider owner (no rigid_body_component)."""
        self._bodies.append(_Body(
            np.asarray(position, np.float64), np.asarray(rotation, np.float64),
            True, 0.0, 0.0, 0.0))
        self._bodies[-1].kinematic = None  # marker: not a body at all
        return len(self._bodies) - 1

    # -- colliders ------------------------------------------------------

    def _add_collider(self, owner, c: _Collider):
        self._colliders.append(c)
        self._bodies[owner].colliders.append(len(self._colliders) - 1)

    def add_sphere_collider(self, owner, center, radius,
                            friction=1.0, restitution=0.2, density=1000.0):
        self._add_collider(owner, _Collider(
            SHAPE_SPHERE, np.asarray(center, np.float64), np.zeros(3),
            float(radius), np.array([0, 0, 0, 1.0]),
            friction, restitution, density, owner, OWNER_RIGID_BODY, 0, -1))

    def add_capsule_collider(self, owner, a, b, radius,
                             friction=1.0, restitution=0.2, density=1000.0):
        self._add_collider(owner, _Collider(
            SHAPE_CAPSULE, np.asarray(a, np.float64), np.asarray(b, np.float64),
            float(radius), np.array([0, 0, 0, 1.0]),
            friction, restitution, density, owner, OWNER_RIGID_BODY, 0, -1))

    def add_cylinder_collider(self, owner, a, b, radius,
                              friction=1.0, restitution=0.2, density=1000.0):
        """Cylinder between the local cap centres a and b."""
        self._add_collider(owner, _Collider(
            SHAPE_CYLINDER, np.asarray(a, np.float64),
            np.asarray(b, np.float64), float(radius), np.array([0, 0, 0, 1.0]),
            friction, restitution, density, owner, OWNER_RIGID_BODY, 0, -1))

    def add_box_collider(self, owner, center, half_extents,
                         rotation=(0, 0, 0, 1),
                         friction=1.0, restitution=0.2, density=1000.0):
        """AABB collider if rotation is identity, OBB otherwise
        (the distinction is resolved at world-flattening like
        physics.cpp:722-740)."""
        self._add_collider(owner, _Collider(
            SHAPE_BOX, np.asarray(center, np.float64),
            np.asarray(half_extents, np.float64), 0.0,
            np.asarray(rotation, np.float64),
            friction, restitution, density, owner, OWNER_RIGID_BODY, 0, -1))

    def add_hull_geometry(self, vertices: np.ndarray,
                          faces: Optional[np.ndarray] = None) -> int:
        """Register convex hull geometry. `faces` (T, 3), outward wound,
        give the mass, centre of gravity and inertia per unit density by
        the covariance method over the triangles, and the face planes.
        Returns the hull id."""
        vertices = np.asarray(vertices, np.float64)
        if faces is None:
            raise ValueError("hull geometry requires triangle faces for "
                             "inertia")
        s60, s120 = 1.0 / 60.0, 1.0 / 120.0
        Cc = np.array([[s60, s120, s120], [s120, s60, s120],
                       [s120, s120, s60]])
        total_mass = 0.0
        total_cov = np.zeros((3, 3))
        total_cog = np.zeros(3)
        for (ia, ib, ic) in np.asarray(faces, np.int64):
            w1, w2, w3 = vertices[ia], vertices[ib], vertices[ic]
            A = np.stack([w1, w2, w3], axis=1)
            detA = np.linalg.det(A)
            total_cov += detA * A @ Cc @ A.T
            m = detA / 6.0
            total_mass += m
            total_cog += (w1 + w2 + w3) * 0.25 * m
        total_cog /= total_mass
        Cp = total_cov - total_mass * np.outer(total_cog, total_cog)
        inertia_per_density = np.eye(3) * np.trace(Cp) - Cp
        self._hull_geoms.append(vertices)
        self._hull_props.append((total_mass, total_cog, inertia_per_density))
        fa = np.asarray(faces, np.int64)
        n = np.cross(vertices[fa[:, 1]] - vertices[fa[:, 0]],
                     vertices[fa[:, 2]] - vertices[fa[:, 0]])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        d = -np.sum(n * vertices[fa[:, 0]], axis=-1)
        self._hull_faces.append((n, d))
        return len(self._hull_geoms) - 1

    def add_hull_geometry_from_mesh(self, vertices: np.ndarray) -> int:
        """Convex hull geometry of a point cloud or mesh vertex set: the
        hull's vertices and outward-wound triangles from qhull
        (scipy.spatial.ConvexHull). Returns the hull id."""
        from scipy.spatial import ConvexHull
        pts = np.asarray(vertices, np.float64).reshape(-1, 3)
        hull = ConvexHull(pts)
        used = hull.vertices                      # indices of hull vertices
        remap = -np.ones(len(pts), np.int64)
        remap[used] = np.arange(len(used))
        verts = pts[used]
        faces = []
        for simplex, eq in zip(hull.simplices, hull.equations):
            a, b, c = (remap[i] for i in simplex)
            n = np.cross(verts[b] - verts[a], verts[c] - verts[a])
            # orient outward using qhull's facet equation normal
            if np.dot(n, eq[:3]) < 0.0:
                b, c = c, b
            faces.append((a, b, c))
        return self.add_hull_geometry(verts, np.asarray(faces, np.int64))

    def add_hull_collider(self, owner, hull_id, position=(0, 0, 0),
                          rotation=(0, 0, 0, 1),
                          friction=1.0, restitution=0.2, density=1000.0):
        self._add_collider(owner, _Collider(
            SHAPE_HULL, np.asarray(position, np.float64), np.zeros(3), 0.0,
            np.asarray(rotation, np.float64),
            friction, restitution, density, owner, OWNER_RIGID_BODY, 0,
            int(hull_id)))

    def add_force_field(self, force, owner=None):
        """A global force field if `owner` is None: `force` acts on every
        rigid body and, as wind, on every cloth. Otherwise a localized
        one: the owner's colliders bound it, and `force`, turned by the
        owner's rotation, acts on the bodies that overlap them
        (physics.cpp:759-787). Returns its index."""
        idx = len(self._force_fields)
        self._force_fields.append({"force": np.asarray(force, np.float64),
                                   "owner": owner})
        if owner is not None:
            for ci in self._bodies[owner].colliders:
                self._colliders[ci].owner_type = OWNER_FORCE_FIELD
                self._colliders[ci].owner_index = idx
        return idx

    def mark_trigger(self, owner):
        """Mark an owner's colliders as a trigger volume; the bodies that
        overlap it are reported as a boolean mask in
        StepInfo.trigger_overlap (the events-as-data form of the
        reference's trigger callbacks). Returns the trigger's index."""
        idx = self._num_triggers
        self._num_triggers += 1
        for ci in self._bodies[owner].colliders:
            self._colliders[ci].owner_type = OWNER_TRIGGER
            self._colliders[ci].owner_index = idx
        return idx

    # -- joints ----------------------------------------------------------

    def _body_transform(self, i):
        b = self._bodies[i]
        return b.position, b.rotation

    def _inv_tp(self, i, p):
        pos, rot = self._body_transform(i)
        return _np_quat_rotate(_np_quat_conj(rot), np.asarray(p, np.float64) - pos)

    def _inv_td(self, i, d):
        _, rot = self._body_transform(i)
        return _np_quat_rotate(_np_quat_conj(rot), np.asarray(d, np.float64))

    def _joint_index(self, kind):
        """Index of the just-added joint within its type's baked array
        (joints are baked per type in creation order)."""
        return sum(1 for j in self._joints if j.kind == kind) - 1


    def add_distance_constraint(self, a, b, global_anchor_a, global_anchor_b,
                                distance=None):
        """physics.cpp:128-156."""
        if distance is None:
            distance = float(np.linalg.norm(
                np.asarray(global_anchor_a, np.float64)
                - np.asarray(global_anchor_b, np.float64)))
        self._joints.append(_Joint("distance", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor_a),
            local_anchor_b=self._inv_tp(b, global_anchor_b),
            length=distance)))
        return self._joint_index("distance")

    def add_ball_constraint(self, a, b, global_anchor):
        """physics.cpp:158-184."""
        self._joints.append(_Joint("ball", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor),
            local_anchor_b=self._inv_tp(b, global_anchor))))
        return self._joint_index("ball")

    def add_fixed_constraint(self, a, b, global_anchor):
        """physics.cpp:204-225."""
        ra = self._bodies[a].rotation
        rb = self._bodies[b].rotation
        self._joints.append(_Joint("fixed", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor),
            local_anchor_b=self._inv_tp(b, global_anchor),
            initial_inv_rotation_difference=_np_quat_mul(_np_quat_conj(rb),
                                                         ra))))
        return self._joint_index("fixed")

    def add_hinge_constraint(self, a, b, global_anchor, global_axis,
                             min_limit=1.0, max_limit=-1.0):
        """physics.cpp:227-261. min_limit in [-pi,0] / max_limit in [0,pi]
        enable the limits; out-of-range values disable them."""
        la = self._inv_td(a, global_axis)
        lb = self._inv_td(b, global_axis)
        ta, bta = _np_get_tangents(la)
        ra = self._bodies[a].rotation
        rb = self._bodies[b].rotation
        tb = _np_quat_rotate(_np_quat_conj(rb), _np_quat_rotate(ra, ta))
        self._joints.append(_Joint("hinge", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor),
            local_anchor_b=self._inv_tp(b, global_anchor),
            local_axis_a=la, local_axis_b=lb,
            local_tangent_a=ta, local_bitangent_a=bta, local_tangent_b=tb,
            limit_min=float(min_limit), limit_max=float(max_limit))))
        return self._joint_index("hinge")

    def add_cone_twist_constraint(self, a, b, global_anchor, global_axis,
                                  swing_limit, twist_limit):
        """physics.cpp:263-302. Negative limits disable them."""
        la = self._inv_td(a, global_axis)
        lb = self._inv_td(b, global_axis)
        ta, bta = _np_get_tangents(la)
        ra = self._bodies[a].rotation
        rb = self._bodies[b].rotation
        tb = _np_quat_rotate(_np_quat_conj(rb), _np_quat_rotate(ra, ta))
        self._joints.append(_Joint("cone_twist", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor),
            local_anchor_b=self._inv_tp(b, global_anchor),
            local_axis_a=la, local_axis_b=lb,
            local_tangent_a=ta, local_bitangent_a=bta, local_tangent_b=tb,
            limit_min=float(swing_limit), limit_max=float(twist_limit))))
        return self._joint_index("cone_twist")

    def add_slider_constraint(self, a, b, global_anchor, global_axis,
                              min_limit=1.0, max_limit=-1.0):
        """physics.cpp:304-333. min_limit <= 0 / max_limit >= 0 enable."""
        ra = self._bodies[a].rotation
        rb = self._bodies[b].rotation
        self._joints.append(_Joint("slider", a, b, dict(
            local_anchor_a=self._inv_tp(a, global_anchor),
            local_anchor_b=self._inv_tp(b, global_anchor),
            local_axis_a=self._inv_td(a, global_axis),
            initial_inv_rotation_difference=_np_quat_mul(_np_quat_conj(rb),
                                                         ra),
            limit_min=float(min_limit), limit_max=float(max_limit))))
        return self._joint_index("slider")

    def set_heightfield(self, heights, cell_size, min_corner=(0.0, 0.0, 0.0),
                        friction=1.0, restitution=0.0, window=8):
        """Attach a heightfield terrain collider (reference
        heightmap_collider_component; heights already in world units,
        indexed [z, x])."""
        self._heightfield = dict(
            heights=np.array(heights, np.float32), cell_size=cell_size,
            min_corner=min_corner, friction=friction,
            restitution=restitution, window=window)

    def add_cloth(self, width, height, grid_x, grid_y, total_mass,
                  stiffness=1.0, damping=0.5, gravity_factor=1.0,
                  transform_pos=(0, 0, 0), transform_rot=(0, 0, 0, 1),
                  thickness=0.0):
        """Grid cloth with the reference's constraint topology and particle
        layout; its top row (y == 0) is pinned. May be called more than
        once: all cloths bake into one flat particle and constraint system
        (each one's particle range in scene.cloth.grids). Returns the
        cloth's index."""
        self._cloths.append(dict(
            width=width, height=height, grid_x=grid_x,
            grid_y=grid_y, total_mass=total_mass,
            stiffness=stiffness, damping=damping,
            gravity_factor=gravity_factor, thickness=thickness,
            pos=np.asarray(transform_pos, np.float64),
            rot=np.asarray(transform_rot, np.float64)))
        return len(self._cloths) - 1

    # -- mass properties (physics.cpp:1416-1588) ---------------------------

    def _collider_mass_properties(self, c: _Collider):
        """Returns (mass, cog, inertia) about the COG in the owning entity's
        local space — collider_union::calculatePhysicsProperties."""
        rho = c.density
        if c.ctype == SHAPE_SPHERE:
            r = c.r
            mass = (4.0 / 3.0) * math.pi * r ** 3 * rho
            inertia = np.eye(3) * (2.0 / 5.0 * mass * r * r)
            return mass, c.a.copy(), inertia
        if c.ctype == SHAPE_CAPSULE:
            axis = c.a - c.b
            if axis[1] < 0:
                axis = -axis
            h = float(np.linalg.norm(axis))
            axis = axis / h
            rot = _np_quat_to_mat3(_np_rotate_from_to([0, 1, 0], axis))
            r = c.r
            sq_r = r * r
            sq_r_pi = math.pi * sq_r
            mass = (4.0 / 3.0 * sq_r_pi * r + sq_r_pi * h) * rho
            cyl_m = rho * sq_r_pi * h
            hemi_m = rho * 2.0 / 3.0 * sq_r_pi * r
            sq_h = h * h
            I = np.zeros((3, 3))
            I[1, 1] = sq_r * cyl_m * 0.5
            I[0, 0] = I[2, 2] = I[1, 1] * 0.5 + cyl_m * sq_h / 12.0
            t0 = hemi_m * 2.0 * sq_r / 5.0
            I[1, 1] += t0 * 2.0
            t1 = h * 0.5
            t2 = t0 + hemi_m * (t1 * t1 + 3.0 / 8.0 * sq_h)
            I[0, 0] += t2 * 2.0
            I[2, 2] += t2 * 2.0
            I = rot.T @ I @ rot
            return mass, (c.a + c.b) * 0.5, I
        if c.ctype == SHAPE_CYLINDER:
            axis = c.a - c.b
            if axis[1] < 0:
                axis = -axis
            h = float(np.linalg.norm(axis))
            axis = axis / h
            rot = _np_quat_to_mat3(_np_rotate_from_to([0, 1, 0], axis))
            r = c.r
            mass = math.pi * r * r * h * rho
            I = np.zeros((3, 3))
            I[1, 1] = r * r * mass * 0.5
            I[0, 0] = I[2, 2] = mass * (3 * r * r + h * h) / 12.0
            I = rot.T @ I @ rot
            return mass, (c.a + c.b) * 0.5, I
        if c.ctype == SHAPE_BOX:
            d = 2.0 * c.b
            mass = d[0] * d[1] * d[2] * rho
            I = np.zeros((3, 3))
            I[0, 0] = mass * (d[1] ** 2 + d[2] ** 2) / 12.0
            I[1, 1] = mass * (d[0] ** 2 + d[2] ** 2) / 12.0
            I[2, 2] = mass * (d[0] ** 2 + d[1] ** 2) / 12.0
            rot = _np_quat_to_mat3(c.rot)
            I = rot.T @ I @ rot  # note: reference applies R^T I R (physics.cpp:1516-1517)
            return mass, c.a.copy(), I
        if c.ctype == SHAPE_HULL:
            m_per_rho, cog, I_per_rho = self._hull_props[c.hull_id]
            # the collider's local pose transforms the hull's own mass
            # properties; the parallel-axis shift happens in _aggregate_body
            rot = _np_quat_to_mat3(c.rot)
            I = rot @ I_per_rho @ rot.T * rho
            cog_l = _np_quat_rotate(c.rot, cog) + c.a
            return m_per_rho * rho, cog_l, I
        raise ValueError(f"unknown shape type {c.ctype}")

    def _aggregate_body(self, body: _Body):
        """rigid_body_component::recalculateProperties (rigid_body.cpp:29-81)."""
        if body.kinematic or body.kinematic is None:
            return 0.0, np.zeros(3), np.zeros((3, 3))
        if not body.colliders:
            # ctor default for a dynamic body before any collider is added:
            # mass 1, identity inertia (rigid_body.cpp:15-16)
            return 1.0, np.zeros(3), np.eye(3)
        props = [self._collider_mass_properties(self._colliders[ci])
                 for ci in body.colliders]
        mass = sum(p[0] for p in props)
        cog = sum(p[0] * p[1] for p in props) / mass
        inertia = np.zeros((3, 3))
        for m, c, I in props:
            r = c - cog
            inertia += I + (np.dot(r, r) * np.eye(3) - np.outer(r, r)) * m
        inv_mass = 1.0 / mass
        inv_inertia = np.linalg.inv(inertia)
        return inv_mass, cog, inv_inertia

    # -- finalize ----------------------------------------------------------

    def _bake_hulls(self, dtype, tens) -> Optional[HullGeometry]:
        """Every hull padded to the largest vertex, face, merged-face, loop
        and edge counts (padded vertices repeat vertex 0), with the merged
        topology derived here from the vertices and face planes."""
        if not self._hull_geoms:
            return None
        from dxk_tpu_torch.scene.hull_topology import (bake_topologies,
                                                       derive_hull_topology)
        H = len(self._hull_geoms)
        vmax = max(len(v) for v in self._hull_geoms)
        verts = np.zeros((H, vmax, 3))
        mask = np.zeros((H, vmax), bool)
        for i, v in enumerate(self._hull_geoms):
            verts[i, :len(v)] = v
            verts[i, len(v):] = v[0]
            mask[i, :len(v)] = True
        fmax = max(len(n) for n, _ in self._hull_faces)
        fnorm = np.zeros((H, fmax, 3))
        foff = np.zeros((H, fmax))
        fmask = np.zeros((H, fmax), bool)
        for i, (n, d) in enumerate(self._hull_faces):
            fnorm[i, :len(n)] = n
            foff[i, :len(n)] = d
            fmask[i, :len(n)] = True
        topos = []
        for v, (fn_, fd_) in zip(self._hull_geoms, self._hull_faces):
            t = derive_hull_topology(v, fn_, fd_)
            t["vertices"] = v
            topos.append(t)
        topo = bake_topologies(topos)
        return HullGeometry(
            vertices=tens(verts.astype(dtype)), vertex_mask=tens(mask),
            face_normals=tens(fnorm.astype(dtype)),
            face_offsets=tens(foff.astype(dtype)), face_mask=tens(fmask),
            **{k: tens(x) for k, x in topo.items()})

    def _collider_bounding_spheres(self, col, init_pos, init_rot, nb):
        """Initial-pose world bounding sphere per collider (conservative):
        picks the broad statics of the sort-and-sweep broadphase and prunes
        the pair tables under candidate_margin and orbit_margin."""
        C = len(self._colliders)
        centers = np.zeros((C, 3))
        brads = np.zeros(C)
        for i in range(C):
            ct = col["ctype"][i]
            a, bb, r = col["a"][i], col["b"][i], col["r"][i]
            if ct in (SHAPE_CAPSULE, SHAPE_CYLINDER):
                lc = (a + bb) * 0.5
                br = 0.5 * np.linalg.norm(bb - a) + r
            elif ct == SHAPE_BOX:
                lc, br = a, np.linalg.norm(bb)
            elif ct == SHAPE_HULL:
                verts = self._hull_geoms[col["hull_id"][i]]
                lc, br = a, float(np.linalg.norm(verts, axis=-1).max())
            else:   # sphere
                lc, br = a, r
            body = col["body"][i]
            if body >= nb:   # static owner: params already world-baked
                centers[i] = lc
            else:
                centers[i] = (_np_quat_rotate(init_rot[body], lc)
                              + init_pos[body])
            brads[i] = br
        return centers, brads

    def finalize(self, max_narrow_pairs_per_group: Optional[int] = None,
                 dtype=np.float32, contact_phases: int = 1,
                 broadphase: str = "table", broadphase_k: int = 8,
                 candidate_margin: Optional[float] = None,
                 orbit_margin: Optional[float] = None,
                 sap_window: int = 4, sap_broad_extent: float = 15.0,
                 device="cuda") -> Scene:
        """Bake the scene into static tensors on `device`.

        contact_phases=K > 1 splits every candidate bucket into K phase
        sub-buckets by a body-index hash, so that pairs within a phase
        rarely share a dynamic body; max_narrow_pairs_per_group caps each
        (type bucket, phase) sub-bucket. broadphase='kselect' replaces the
        masked tables by the K-select kernel (broadphase_k partners per
        collider); broadphase='sap' by the sort-and-sweep kernel, with the
        statics whose initial bounding radius exceeds sap_broad_extent
        paired by a dense side pass. candidate_margin=M keeps a static
        candidate pair only if the colliders' initial bounding spheres
        come within M of each other (the scene promises that pruned pairs
        never touch).

        orbit_margin=M is the rotation-safe variant of candidate_margin
        for articulated machines with spinning parts (gear trains: the
        vehicle's tooth capsules sweep full circles, so initial-centre
        pruning would drop tooth pairs that mesh half a revolution later).
        Each collider is bounded by the spherical shell it sweeps when its
        body rotates arbitrarily about its own centre of mass: radii
        [max(0, d-b), d+b] around the body COM, where d = the collider
        centre's distance from the COM and b = its bounding radius
        (statics, which never rotate, use their plain bounding sphere). A
        pair is kept iff the shells come within M of each other at the
        initial body-COM separation. The scene promises only that the
        COM-to-COM distances stay within M of their initial values (true
        for joint-held mechanisms like the vehicle: suspension travel
        bounds the COM drift, so pass M >= that travel)."""
        if broadphase not in ("table", "kselect", "sap"):
            raise ValueError(f"unknown broadphase {broadphase!r}")
        device = resolve_device(device)

        def tens(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        nb = len(self._bodies)
        n1 = nb + 1  # + dummy

        inv_mass = np.zeros(n1)
        inv_inertia = np.zeros((n1, 3, 3))
        local_cog = np.zeros((n1, 3))
        gravity_factor = np.zeros(n1)
        lin_damp = np.zeros(n1)
        ang_damp = np.zeros(n1)
        init_pos = np.zeros((n1, 3))
        init_rot = np.tile(np.array([0, 0, 0, 1.0]), (n1, 1))

        for i, b in enumerate(self._bodies):
            init_pos[i] = b.position
            init_rot[i] = b.rotation
            if b.kinematic is None:   # static-only owner
                continue
            gravity_factor[i] = b.gravity_factor
            lin_damp[i] = b.linear_damping
            ang_damp[i] = b.angular_damping
            if not b.kinematic:
                im, cog, ii = self._aggregate_body(b)
                inv_mass[i], local_cog[i], inv_inertia[i] = im, cog, ii

        # collider table; owner -> body index (dummy for non-RB owners)
        C = len(self._colliders)
        col = dict(ctype=np.zeros(C, np.int32), a=np.zeros((C, 3)),
                   b=np.zeros((C, 3)), r=np.zeros(C),
                   rot=np.tile(np.array([0, 0, 0, 1.0]), (C, 1)),
                   friction=np.zeros(C), restitution=np.zeros(C),
                   body=np.zeros(C, np.int32), owner_type=np.zeros(C, np.int32),
                   owner_index=np.zeros(C, np.int32), hull_id=np.zeros(C, np.int32))
        for i, c in enumerate(self._colliders):
            owner_body = self._bodies[c.body]
            is_rb = owner_body.kinematic is not None
            ca, cb, crot = c.a, c.b, c.rot
            if not is_rb:
                # static owners map to the dummy body (identity transform),
                # so bake the owner's transform into the collider params —
                # the reference instead reads the owner entity's transform
                # each step (physics.cpp:643-647); statics never move, so
                # baking is equivalent.
                p, q = owner_body.position, owner_body.rotation
                ca = _np_quat_rotate(q, c.a) + p
                if c.ctype in (SHAPE_CAPSULE, SHAPE_CYLINDER):
                    cb = _np_quat_rotate(q, c.b) + p
                crot = _np_quat_mul(q, c.rot)
            col["ctype"][i] = c.ctype
            col["a"][i] = ca
            col["b"][i] = cb
            col["r"][i] = c.r
            col["rot"][i] = crot
            col["friction"][i] = c.friction
            col["restitution"][i] = c.restitution
            col["body"][i] = c.body if is_rb else nb
            if c.owner_type in (OWNER_FORCE_FIELD, OWNER_TRIGGER):
                col["owner_type"][i] = c.owner_type
            else:
                col["owner_type"][i] = OWNER_RIGID_BODY if is_rb else OWNER_STATIC
            col["owner_index"][i] = c.owner_index
            col["hull_id"][i] = c.hull_id

        # --- static broadphase candidate tables -------------------------
        # Pruning mirrors collision_narrow.cpp:2346-2396: drop pairs where
        # neither collider has a rigid body, or both belong to the same one.
        # Trigger/FF pairs go to the overlap list instead.
        from dxk_tpu_torch.scene.native import bake_pair_tables
        coll_buckets, overlap_np = bake_pair_tables(
            col["ctype"], col["owner_type"], col["body"])
        overlap_pairs = [tuple(p) for p in overlap_np]

        sphs = None                      # computed at most once per finalize
        if broadphase == "sap":
            sphs = self._collider_bounding_spheres(col, init_pos, init_rot,
                                                   nb)
            sap_broad = tuple(
                int(i) for i in range(C)
                if col["owner_type"][i] == OWNER_STATIC
                and sphs[1][i] > sap_broad_extent)
        else:
            sap_broad = ()

        if candidate_margin is not None:
            centers, brads = sphs or self._collider_bounding_spheres(
                col, init_pos, init_rot, nb)
            for key, pairs in list(coll_buckets.items()):
                p = np.asarray(pairs, np.int32).reshape(-1, 2)
                if len(p) == 0:
                    continue
                d = np.linalg.norm(centers[p[:, 0]] - centers[p[:, 1]],
                                   axis=-1)
                keep = d <= (brads[p[:, 0]] + brads[p[:, 1]]
                             + candidate_margin)
                coll_buckets[key] = [tuple(q) for q in p[keep]]

        if orbit_margin is not None:
            centers, brads = sphs or self._collider_bounding_spheres(
                col, init_pos, init_rot, nb)
            # world COM per body at t0; a collider's swept shell is centred
            # on its body's COM (statics never rotate: pinned to the
            # collider centre, the shell is the plain bounding sphere)
            com_w = init_pos + np.stack(
                [_np_quat_rotate(init_rot[i], local_cog[i])
                 for i in range(n1)])
            cbody = col["body"]
            ref = np.where((cbody < nb)[:, None], com_w[cbody], centers)
            d0 = np.linalg.norm(centers - ref, axis=-1)
            outer = d0 + brads
            inner = np.maximum(0.0, d0 - brads)
            for key, pairs in list(coll_buckets.items()):
                p = np.asarray(pairs, np.int32).reshape(-1, 2)
                if len(p) == 0:
                    continue
                ia, ib = p[:, 0], p[:, 1]
                D = np.linalg.norm(ref[ia] - ref[ib], axis=-1)
                gap = np.maximum.reduce([D - outer[ia] - outer[ib],
                                         inner[ia] - D - outer[ib],
                                         inner[ib] - D - outer[ia]])
                coll_buckets[key] = [tuple(q) for q in p[gap <= orbit_margin]]

        cap = max_narrow_pairs_per_group or self.max_narrow_pairs_per_group
        groups = []
        for (ta, tb), pairs in sorted(coll_buckets.items()):
            p = np.asarray(pairs, np.int32).reshape(-1, 2)
            if contact_phases > 1:
                ba, bb = col["body"][p[:, 0]], col["body"][p[:, 1]]
                a_st, b_st = ba == nb, bb == nb
                dyn_min = np.where(a_st, bb, np.where(b_st, ba,
                                                      np.minimum(ba, bb)))
                # static pairs are offset by 2, so a body's chain contact
                # and its ground contact land in different phases
                phase = (dyn_min + 2 * (a_st | b_st)) % contact_phases
            else:
                phase = np.zeros(len(p), np.int32)
            for ph in range(contact_phases):
                pp = p[phase == ph]
                if len(pp) == 0:
                    continue
                max_narrow = len(pp) if cap is None else min(cap, len(pp))
                groups.append(PairGroup(type_a=int(ta), type_b=int(tb),
                                        pairs=tens(pp),
                                        max_narrow=int(max_narrow),
                                        phase=int(ph)))
        # trigger / force-field overlap pairs, bucketed by type for the
        # exact shape tests (overlapCheck, collision_narrow.cpp:1593-1689);
        # each bucket keeps its rows' indices into overlap_pairs
        overlap_groups = []
        op = np.asarray(overlap_pairs, np.int32).reshape(-1, 2)
        if len(op):
            ta_arr = col["ctype"][op[:, 0]]
            tb_arr = col["ctype"][op[:, 1]]
            for t1 in range(5):
                for t2 in range(t1, 5):
                    m = (ta_arr == t1) & (tb_arr == t2)
                    if m.any():
                        overlap_groups.append(PairGroup(
                            type_a=int(t1), type_b=int(t2),
                            pairs=tens(op[m]), max_narrow=int(m.sum()),
                            flat_index=tens(np.flatnonzero(m))))

        # --- joints -------------------------------------------------------
        def bake(kind, fields):
            js = [j for j in self._joints if j.kind == kind]
            if not js:
                return None, 0
            ba = np.array([j.body_a for j in js], np.int32)
            bb = np.array([j.body_b for j in js], np.int32)
            from dxk_tpu_torch.scene.native import color_constraints
            colors, num_colors = color_constraints(ba, bb, nb)
            data = dict(
                body_a=tens(ba),
                body_b=tens(bb),
                color=tens(colors),
                num_colors=int(max(num_colors, 1)),
            )
            for f in fields:
                arr = np.stack([np.asarray(j.params[f], np.float64) for j in js])
                data[f] = tens(arr.astype(dtype))
            return JointsOfType(**data), len(js)

        distance, _ = bake("distance", ["local_anchor_a", "local_anchor_b",
                                        "length"])
        ball, _ = bake("ball", ["local_anchor_a", "local_anchor_b"])
        fixed, _ = bake("fixed", ["local_anchor_a", "local_anchor_b",
                                  "initial_inv_rotation_difference"])
        hinge, n_hinge = bake("hinge", ["local_anchor_a", "local_anchor_b",
                                        "local_axis_a", "local_axis_b",
                                        "local_tangent_a", "local_bitangent_a",
                                        "local_tangent_b", "limit_min", "limit_max"])
        cone_twist, n_ct = bake("cone_twist", ["local_anchor_a", "local_anchor_b",
                                               "local_axis_a", "local_axis_b",
                                               "local_tangent_a", "local_bitangent_a",
                                               "local_tangent_b", "limit_min", "limit_max"])
        slider, n_sl = bake("slider", ["local_anchor_a", "local_anchor_b",
                                       "local_axis_a",
                                       "initial_inv_rotation_difference",
                                       "limit_min", "limit_max"])

        # default controls: all motors disabled (max torque = -1,
        # physics.cpp:255, 291-296, 327)
        z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
        zi = lambda n: torch.zeros((n,), dtype=torch.int32, device=device)
        neg = lambda n: torch.full((n,), -1.0, dtype=torch.float32,
                                   device=device)
        controls = MotorControls(
            hinge_motor_type=zi(n_hinge), hinge_target=z(n_hinge),
            hinge_max_torque=neg(n_hinge),
            ct_swing_motor_type=zi(n_ct), ct_swing_target=z(n_ct),
            ct_swing_axis_angle=z(n_ct), ct_swing_max_torque=neg(n_ct),
            ct_twist_motor_type=zi(n_ct), ct_twist_target=z(n_ct),
            ct_twist_max_torque=neg(n_ct),
            slider_motor_type=zi(n_sl), slider_target=z(n_sl),
            slider_max_force=neg(n_sl),
        )

        # --- force fields: the global ones summed (ownerless, so not
        # rotated); a localized one's force turned by its owner's rotation
        global_ff = np.zeros(3)
        ff_forces = np.zeros((max(len(self._force_fields), 1), 3))
        for idx, ff in enumerate(self._force_fields):
            if ff["owner"] is not None:
                ff_forces[idx] = _np_quat_rotate(
                    self._bodies[ff["owner"]].rotation, ff["force"])
            else:
                global_ff += ff["force"]

        f32 = lambda x: tens(np.asarray(x).astype(dtype))
        cloth = None
        if self._cloths:
            cloth = _cloth_params(
                _merge_cloths([_bake_cloth(spec) for spec in self._cloths]),
                col["ctype"], bool(self._hull_geoms), dtype, device)
        return Scene(
            num_bodies=nb,
            body_params=BodyParams(
                inv_mass=f32(inv_mass), inv_inertia=f32(inv_inertia),
                local_cog=f32(local_cog), gravity_factor=f32(gravity_factor),
                linear_damping=f32(lin_damp), angular_damping=f32(ang_damp),
            ),
            colliders=Colliders(
                ctype=tens(col["ctype"]), a=f32(col["a"]), b=f32(col["b"]),
                r=f32(col["r"]), rot=f32(col["rot"]),
                friction=f32(col["friction"]),
                restitution=f32(col["restitution"]),
                body=tens(col["body"]), owner_type=tens(col["owner_type"]),
                owner_index=tens(col["owner_index"]),
                hull_id=tens(col["hull_id"]),
            ),
            hulls=self._bake_hulls(dtype, tens),
            pair_groups=tuple(groups),
            num_contact_phases=int(contact_phases),
            broadphase_k=(int(broadphase_k)
                          if broadphase in ("kselect", "sap") else 0),
            broadphase_kind=("sap" if broadphase == "sap" else "kselect"),
            sap_window=int(sap_window),
            sap_broad=sap_broad,
            overlap_groups=tuple(overlap_groups),
            overlap_pairs=tens(op),
            distance=distance, ball=ball, fixed=fixed, hinge=hinge,
            cone_twist=cone_twist, slider=slider,
            default_controls=controls,
            global_ff_force=f32(global_ff),
            ff_forces=f32(ff_forces),
            cloth=cloth,
            heightfield=(make_heightfield(**self._heightfield, device=device)
                         if self._heightfield is not None else None),
            init_pos=f32(init_pos),
            init_rot=f32(init_rot),
        )


# ---------------------------------------------------------------------------
# cloth baking (numpy, float64 until the final cast, as in the JAX package)

def _bake_cloth(spec: dict) -> dict:
    """One grid cloth's arrays (the reference's cloth.cpp:7-80): particle
    positions and inverse masses (top row pinned), structural, shear and
    bend constraints with their rest lengths, the wind triangles."""
    gx, gy = spec["grid_x"], spec["grid_y"]
    width, height = spec["width"], spec["height"]
    n = gx * gy
    inv_mass_per = n / spec["total_mass"]

    positions = np.zeros((n, 3))
    inv_masses = np.zeros(n)
    for y in range(gy):
        im = 0.0 if y == 0 else inv_mass_per
        for x in range(gx):
            i = y * gx + x
            # x centred, y and z swapped (cloth.cpp:124-130)
            rel_x, rel_y = x / (gx - 1), y / (gy - 1)
            positions[i] = (rel_x * width - width * 0.5, 0.0,
                            -rel_y * height)
            inv_masses[i] = im
    positions = _np_quat_rotate_batch(spec["rot"], positions) + spec["pos"]

    cons = []
    for y in range(gy):
        for x in range(gx):
            i = y * gx + x
            if x < gx - 1:
                cons.append((i, i + 1))
            if y < gy - 1:
                cons.append((i, i + gx))
            if x < gx - 1 and y < gy - 1:
                cons.append((i, i + gx + 1))
                cons.append((i + gx, i + 1))
            if x < gx - 2:
                cons.append((i, i + 2))
            if y < gy - 2:
                cons.append((i, i + 2 * gx))
    cons = np.asarray(cons, np.int32)
    rest = np.linalg.norm(positions[cons[:, 0]] - positions[cons[:, 1]],
                          axis=-1)
    stiffness = min(max(spec["stiffness"], 0.01), 1.0)
    inv_mass_sums = (inv_masses[cons[:, 0]]
                     + inv_masses[cons[:, 1]]) / stiffness

    tris = []
    for y in range(gy - 1):
        for x in range(gx - 1):
            tl = y * gx + x
            tr, bl = tl + 1, tl + gx
            br = bl + 1
            tris.append((tl, bl, tr))
            tris.append((br, tr, bl))
    return dict(
        grids=((gx, gy, 0),), inv_masses=inv_masses, constraints=cons,
        rest_lengths=rest, inv_mass_sums=inv_mass_sums,
        init_positions=positions,
        triangles=np.asarray(tris, np.int32),
        gravity_factor=np.full(n, float(spec["gravity_factor"])),
        damping=np.full(n, float(spec["damping"])),
        thickness=np.full(n, float(spec.get("thickness", 0.0))))


def _merge_cloths(parts: list) -> dict:
    """N baked cloths as one flat system, particle indices offset."""
    if len(parts) == 1:
        return parts[0]
    grids, off = [], 0
    cons, tris = [], []
    for c in parts:
        gx, gy, _ = c["grids"][0]
        grids.append((gx, gy, off))
        cons.append(c["constraints"] + off)
        tris.append(c["triangles"] + off)
        off += c["inv_masses"].shape[0]
    out = {k: np.concatenate([c[k] for c in parts], axis=0)
           for k in parts[0] if k != "grids"}
    out.update(grids=tuple(grids), constraints=np.concatenate(cons),
               triangles=np.concatenate(tris))
    return out


def _constraint_colors(cons: np.ndarray) -> list:
    """Greedy edge colouring of the constraint graph, in the JAX package's
    visiting order (its ops/cloth.py _constraint_colors): each constraint
    joins the first colour that holds neither of its particles. Returns
    per colour the constraint indices, np.int64."""
    used, colors = [], []
    for i, (a, b) in enumerate(cons.tolist()):
        for c in range(len(colors)):
            if a not in used[c] and b not in used[c]:
                colors[c].append(i)
                used[c].update((a, b))
                break
        else:
            colors.append([i])
            used.append({a, b})
    return [np.asarray(c, np.int64) for c in colors]


def _sweep_levels(cons: np.ndarray) -> list:
    """The sequential sweep's dependency levels: a constraint's level is
    one past the last level, so far, of either of its particles. Each
    level's constraints share no particle, and each particle's constraints
    sit in rising levels in constraint order, so solving the levels in
    turn is the sweep exactly. Returns per level the constraint indices,
    np.int64, in constraint order."""
    last, levels = {}, []
    for i, (a, b) in enumerate(cons.tolist()):
        lv = 1 + max(last.get(a, -1), last.get(b, -1))
        last[a] = last[b] = lv
        if lv == len(levels):
            levels.append([])
        levels[lv].append(i)
    return [np.asarray(lv, np.int64) for lv in levels]


def _cloth_params(c: dict, ctype, has_hulls, dtype, device) -> ClothParams:
    """ClothParams on `device` from the baked arrays, with the index
    tables and the flag the step reads (scene.ClothParams); `ctype` the
    colliders' types (numpy)."""
    from dxk_tpu_torch.ops.cloth import collider_groups
    tens = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    f32 = lambda x: tens(np.asarray(x).astype(dtype))
    i64 = lambda x: tens(np.asarray(x, np.int64))
    cons = c["constraints"]
    thickness = np.asarray(c["thickness"]).astype(dtype)
    return ClothParams(
        grids=tuple(c["grids"]),
        inv_masses=f32(c["inv_masses"]),
        constraints=tens(cons),
        rest_lengths=f32(c["rest_lengths"]),
        inv_mass_sums=f32(c["inv_mass_sums"]),
        init_positions=f32(c["init_positions"]),
        triangles=tens(c["triangles"]),
        gravity_factor=f32(c["gravity_factor"]),
        damping=f32(c["damping"]),
        thickness=tens(thickness),
        collides=bool(thickness.max() > 0.0),
        color_index=tuple((i64(g), i64(cons[g, 0]), i64(cons[g, 1]))
                          for g in _constraint_colors(cons)),
        scan_levels=tuple((i64(g), i64(cons[g, 0]), i64(cons[g, 1]))
                          for g in _sweep_levels(cons)),
        collider_groups=collider_groups(ctype, has_hulls, device))


def _np_quat_rotate_batch(q, vs):
    u, w = np.asarray(q[:3]), q[3]
    uv = np.cross(np.broadcast_to(u, vs.shape), vs)
    return vs + 2.0 * (w * uv + np.cross(np.broadcast_to(u, vs.shape), uv))
