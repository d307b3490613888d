"""Scene and state containers — dataclasses of torch tensors.

A `Scene` is the *static* description (collider shapes, joint wiring,
masses, candidate collision pairs) produced once by `SceneBuilder`; its
tensors carry no batch dimension. A `State` is the dynamic struct-of-arrays
that `physics_step` maps to a new `State`; every tensor in it has an
explicit leading env-batch dimension B.

Conventions (shared with the JAX package):
  - `num_bodies` real bodies; index `num_bodies` is the static "dummy" body
    (inv mass 0, identity rotation). All body arrays have length
    num_bodies + 1.
  - Colliders with no rigid body map to the dummy body.
  - Quaternions are (x, y, z, w).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

SHAPE_SPHERE = 0
SHAPE_CAPSULE = 1
SHAPE_CYLINDER = 2
SHAPE_BOX = 3
SHAPE_HULL = 4
SHAPE_TYPE_NAMES = ("sphere", "capsule", "cylinder", "box", "hull")

OWNER_RIGID_BODY = 0
OWNER_STATIC = 1
OWNER_FORCE_FIELD = 2
OWNER_TRIGGER = 3


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. Asking for CUDA on a machine without a
    CUDA device raises: the port never carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return device


class _Struct:
    """Mixin: `replace` (like flax.struct) and `to(device)` over tensor
    fields, recursing into nested structs and tuples of structs."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, _Struct):
                return x.to(device)
            if isinstance(x, tuple):
                return tuple(move(y) for y in x)
            return x
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


@dataclass
class Colliders(_Struct):
    """SoA collider table.

    Field meaning by shape type:
      sphere:   a = local center, r = radius
      capsule:  a, b = local segment endpoints, r = radius
      cylinder: a, b = local cap centers, r = radius
      box:      a = local center, b = half extents, rot = local rotation
      hull:     a = local position, rot = local rotation, hull_id = geometry
    """

    ctype: torch.Tensor        # (C,) int32
    a: torch.Tensor            # (C, 3) f32
    b: torch.Tensor            # (C, 3) f32
    r: torch.Tensor            # (C,) f32
    rot: torch.Tensor          # (C, 4) f32
    friction: torch.Tensor     # (C,) f32
    restitution: torch.Tensor  # (C,) f32
    body: torch.Tensor         # (C,) int32 — owning body (num_bodies = none)
    owner_type: torch.Tensor   # (C,) int32
    owner_index: torch.Tensor  # (C,) int32
    hull_id: torch.Tensor      # (C,) int32


@dataclass
class HullGeometry(_Struct):
    """Padded convex hull geometry shared by hull colliders: vertices,
    triangle face planes (outward unit normals, offsets in n.x + d = 0
    form), and the merged-polygon topology of the SAT/clip contact recipes
    (scene/hull_topology.py): unique face normals, ordered vertex loops as
    local positions, unique edge directions."""

    vertices: torch.Tensor          # (H, Vmax, 3) f32, padded with vertex 0
    vertex_mask: torch.Tensor       # (H, Vmax) bool
    face_normals: torch.Tensor = None   # (H, Fmax, 3) outward unit normals
    face_offsets: torch.Tensor = None   # (H, Fmax) plane d: n.x + d = 0
    face_mask: torch.Tensor = None      # (H, Fmax) bool
    poly_normals: torch.Tensor = None   # (H, FU, 3)
    poly_offsets: torch.Tensor = None   # (H, FU)
    poly_mask: torch.Tensor = None      # (H, FU) bool
    loop_pts: torch.Tensor = None       # (H, FU, LM, 3) local positions
    loop_len: torch.Tensor = None       # (H, FU) int32
    edge_dirs: torch.Tensor = None      # (H, EU, 3) unit, sign-deduped
    edge_mask: torch.Tensor = None      # (H, EU) bool


@dataclass
class BodyParams(_Struct):
    """Static per-body parameters, sized (N+1,) with the dummy at index N."""

    inv_mass: torch.Tensor          # (N+1,)
    inv_inertia: torch.Tensor       # (N+1, 3, 3) local-space inverse inertia
    local_cog: torch.Tensor         # (N+1, 3)
    gravity_factor: torch.Tensor    # (N+1,)
    linear_damping: torch.Tensor    # (N+1,)
    angular_damping: torch.Tensor   # (N+1,)


@dataclass
class PairGroup(_Struct):
    """A static candidate-pair table for one (typeA, typeB) bucket. Pairs
    are pre-pruned and pre-oriented (colliderA.type <= colliderB.type) at
    build time."""

    type_a: int
    type_b: int
    pairs: torch.Tensor = None       # (P, 2) int32 collider indices
    max_narrow: int = 0
    phase: int = 0


@dataclass
class JointsOfType(_Struct):
    """Static parameters for one joint type, SoA."""

    body_a: torch.Tensor           # (J,) int32
    body_b: torch.Tensor           # (J,) int32
    local_anchor_a: torch.Tensor   # (J, 3)
    local_anchor_b: torch.Tensor   # (J, 3)
    length: torch.Tensor = None
    initial_inv_rotation_difference: torch.Tensor = None
    local_axis_a: torch.Tensor = None      # (J, 3)
    local_axis_b: torch.Tensor = None      # (J, 3)
    local_tangent_a: torch.Tensor = None   # (J, 3)
    local_bitangent_a: torch.Tensor = None  # (J, 3)
    local_tangent_b: torch.Tensor = None   # (J, 3)
    # hinge (min,max rotation), cone-twist (swing, twist)
    limit_min: torch.Tensor = None         # (J,)
    limit_max: torch.Tensor = None         # (J,)
    color: torch.Tensor = None             # (J,) int32
    num_colors: int = 1


@dataclass
class MotorControls(_Struct):
    """Dynamic motor parameters for the actuated joint types. In a `State`
    every field carries the leading env-batch dimension.

    motor_type: 0 = velocity motor, 1 = position motor. max_torque <= 0
    disables a motor."""

    hinge_motor_type: torch.Tensor      # (Jh,) int32
    hinge_target: torch.Tensor          # (Jh,)
    hinge_max_torque: torch.Tensor      # (Jh,)

    ct_swing_motor_type: torch.Tensor   # (Jc,) int32
    ct_swing_target: torch.Tensor       # (Jc,)
    ct_swing_axis_angle: torch.Tensor   # (Jc,)
    ct_swing_max_torque: torch.Tensor   # (Jc,)
    ct_twist_motor_type: torch.Tensor   # (Jc,) int32
    ct_twist_target: torch.Tensor       # (Jc,)
    ct_twist_max_torque: torch.Tensor   # (Jc,)

    slider_motor_type: torch.Tensor     # (Js,) int32
    slider_target: torch.Tensor         # (Js,)
    slider_max_force: torch.Tensor      # (Js,)


@dataclass
class ClothParams(_Struct):
    """Placeholder: cloth is not ported yet (Scene.cloth is None)."""

    grids: tuple = ()


def _expand(x, batch):
    return x.unsqueeze(0).expand(batch, *x.shape).clone()


@dataclass
class Scene(_Struct):
    """Full static scene description."""

    num_bodies: int
    body_params: BodyParams = None
    colliders: Colliders = None
    hulls: Optional[HullGeometry] = None
    pair_groups: tuple = ()
    num_contact_phases: int = 1
    broadphase_k: int = 0
    broadphase_kind: str = "kselect"
    sap_window: int = 4
    sap_broad: tuple = ()
    overlap_groups: tuple = ()
    overlap_pairs: torch.Tensor = None   # (Q, 2) int32 trigger/FF pairs
    distance: Optional[JointsOfType] = None
    ball: Optional[JointsOfType] = None
    fixed: Optional[JointsOfType] = None
    hinge: Optional[JointsOfType] = None
    cone_twist: Optional[JointsOfType] = None
    slider: Optional[JointsOfType] = None
    default_controls: Optional[MotorControls] = None
    global_ff_force: torch.Tensor = None     # (3,)
    ff_forces: torch.Tensor = None           # (F, 3)
    cloth: Optional[ClothParams] = None
    heightfield: Any = None       # ops.heightmap.Heightfield or None
    init_pos: torch.Tensor = None
    init_rot: torch.Tensor = None

    @property
    def dummy_body(self) -> int:
        return self.num_bodies

    @property
    def device(self):
        return self.init_pos.device

    def batched_controls(self, batch: int) -> MotorControls:
        c = self.default_controls
        return MotorControls(**{
            f.name: _expand(getattr(c, f.name), batch)
            for f in dataclasses.fields(c)})

    def initial_state(self, batch: int = 1) -> "State":
        """Initial state of `batch` identical environments."""
        n1 = self.num_bodies + 1
        z = lambda: torch.zeros((batch, n1, 3), dtype=torch.float32,
                                device=self.device)
        return State(
            pos=_expand(self.init_pos, batch),
            rot=_expand(self.init_rot, batch),
            lin_vel=z(), ang_vel=z(), force_acc=z(), torque_acc=z(),
            controls=self.batched_controls(batch),
            cloth=None,
        )


@dataclass
class State(_Struct):
    """Dynamic body state, batched: arrays sized (B, N+1, ...), dummy last.

    `pos`/`rot` are the entity transform; velocities live at the COG.
    `force_acc`/`torque_acc` are cleared by `physics_step` after
    integration, so external pokes write into them between steps."""

    pos: torch.Tensor         # (B, N+1, 3)
    rot: torch.Tensor         # (B, N+1, 4)
    lin_vel: torch.Tensor     # (B, N+1, 3)
    ang_vel: torch.Tensor     # (B, N+1, 3)
    force_acc: torch.Tensor   # (B, N+1, 3)
    torque_acc: torch.Tensor  # (B, N+1, 3)
    controls: Optional[MotorControls] = None
    cloth: Any = None


@dataclass
class StepInfo(_Struct):
    """Per-step observability, one value per env."""

    num_broadphase_overlaps: torch.Tensor   # (B,) int32
    num_contacts: torch.Tensor              # (B,) int32
    broadphase_overflow: torch.Tensor       # (B,) int32
    trigger_overlap: Any = None
    contact_pairs: torch.Tensor = None      # (P, 2) int32 collider ids
    contact_mask: torch.Tensor = None       # (B, P) bool
    contact_impulse: torch.Tensor = None    # (B, P) f32 summed normal impulse
    validate_stage: Any = None
