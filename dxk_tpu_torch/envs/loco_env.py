"""Ragdoll locomotion environment, batched over environments natively:
66-float observation (71 with the gait reference), 27-float action with EMA
smoothing (beta=0.1) driving position motors (max torque 200), DReCon-style
reward, head-height fall termination, 2%-per-step random pokes, auto-reset.

The PyTorch counterpart of the JAX package's envs/loco_env.py: where that
module writes one env and `vmap`s it, every tensor here carries the env
batch as its leading dimension, and the random pokes draw from an explicit
`torch.Generator` instead of a PRNG key carried in the state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from dxk_tpu_torch.core.maths import (cross, length, quat_conj, quat_mul,
                                      quat_rotate)
from dxk_tpu_torch.models.ragdoll import BODY_PART_PARENTS, add_ragdoll
from dxk_tpu_torch.physics import (PhysicsSettings, apply_ray_impulse,
                                   physics_step)
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.builder import _np_quat_rotate as _np_rot
from dxk_tpu_torch.scene.scene import (MotorControls, Scene, State, _Struct,
                                       resolve_device)

NUM_BODY_PARTS = 14
NUM_CONE_TWIST = 7
NUM_HINGE = 6
ACTION_SIZE = NUM_CONE_TWIST * 3 + NUM_HINGE       # 27
OBS_SIZE = 3 + 6 * 6 + ACTION_SIZE                 # 66
MOTOR_TORQUE = 200.0
ACTION_EMA_BETA = 0.1
POKE_PROBABILITY = 0.02
POKE_STRENGTH = 1000.0
DT = 1.0 / 60.0
FALL_HEAD_HEIGHT = 1.0

# Procedural gait reference (see the JAX package's loco_env.py)
GAIT_FREQUENCY = 1.4          # Hz, one full left+right cycle
GAIT_LEG_LENGTH = 0.9         # m, hip-to-ground at ragdoll SCALE 0.42
GAIT_KNEE_RATIO = 1.4         # knee flexion amplitude / hip swing amplitude
GAIT_KNEE_PHASE = 0.4         # rad, knee flexion lags the forward hip swing
# gait mode only: the episode ends when the torso falls this far behind
# the gliding reference root
TRACK_FAIL_DIST = 1.25        # m


@dataclass
class EnvState(_Struct):
    physics: State
    smoothed_action: torch.Tensor    # (B, 27)
    steps: torch.Tensor              # (B,) int32 episode step counter


def _select(done, a, b):
    """Per-env select over matching struct trees: a where done else b."""
    if isinstance(a, torch.Tensor):
        d = done.reshape(-1, *([1] * (a.dim() - 1)))
        return torch.where(d, a, b)
    if a is None:
        return None
    return dataclasses.replace(a, **{
        f.name: _select(done, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)})


class LocoEnv:
    """Build once; `reset(batch)` / `step(env, action, generator)` map a
    batch of environments forward in lockstep.

    Scene: ground box (center (0,-4,0), half extents (20,4,20), friction 1,
    restitution 0.1) + ragdoll at hip (0, 1.25, 0)."""

    def __init__(self, solver_iterations: int = 30,
                 solver_mode: str = "scan", max_narrow_pairs: int = 48,
                 enable_pokes: bool = True, narrow_caps: dict = None,
                 torso_velocity_target=(0.0, 0.0, 0.0), gait: bool = None,
                 device="cuda"):
        if solver_mode in ("fused", "fused_seq"):
            # the fused step needs the static pair tables (cap == table
            # size) and ignores both caps, as in the JAX package
            max_narrow_pairs = None
            narrow_caps = None
        self.device = resolve_device(device)
        dev = self.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self._ident_q = f32([0.0, 0.0, 0.0, 1.0])
        self._xz = f32([1.0, 0.0, 1.0])
        self.torso_velocity_target = f32(torso_velocity_target)
        v_norm = float(np.linalg.norm(np.asarray(torso_velocity_target,
                                                 np.float64)))
        # gait=None: the procedural walking reference is on iff the walk
        # target is non-zero; it adds sin/cos phase + the reference-root
        # tracking error to the observation (obs_size 71)
        self.gait_enabled = bool(gait) if gait is not None else v_norm > 0.0
        self.obs_size = OBS_SIZE + (5 if self.gait_enabled else 0)
        # hip swing amplitude so foot ground-speed ~= commanded speed
        self.gait_hip_amp = float(np.arcsin(np.clip(
            v_norm / (2.0 * GAIT_LEG_LENGTH * GAIT_FREQUENCY), 0.0, 0.95)))
        self.gait_knee_amp = GAIT_KNEE_RATIO * self.gait_hip_amp

        b = SceneBuilder()
        ground = b.add_static(position=(0.0, -4.0, 0.0))
        b.add_box_collider(ground, (0, 0, 0), (20.0, 4.0, 20.0),
                           friction=1.0, restitution=0.1)
        self.ragdoll = add_ragdoll(b, initial_hip_position=(0.0, 1.25, 0.0))
        self.scene: Scene = b.finalize(
            max_narrow_pairs_per_group=max_narrow_pairs, device=dev)
        if narrow_caps:
            # per-(typeA, typeB) narrowphase capacity, e.g. {(1, 3): 16}
            groups = tuple(
                g.replace(max_narrow=min(narrow_caps.get(
                    (g.type_a, g.type_b), g.max_narrow), g.pairs.shape[0]))
                for g in self.scene.pair_groups)
            self.scene = self.scene.replace(pair_groups=groups)
        self.settings = PhysicsSettings(
            num_rigid_solver_iterations=solver_iterations,
            solver_mode=solver_mode)
        self.enable_pokes = enable_pokes

        rag = self.ragdoll
        self.body_ids = torch.as_tensor(np.array(rag.body_ids, np.int64),
                                        device=dev)
        self.parent_ids = np.array(rag.parent_ids, np.int64)

        name_to_id = rag.bodies
        self.obs_parts = torch.as_tensor(np.array([
            name_to_id["left_toes"], name_to_id["right_toes"],
            name_to_id["torso"], name_to_id["head"],
            name_to_id["left_lower_arm"], name_to_id["right_lower_arm"],
        ], np.int64), device=dev)
        self.torso_id = name_to_id["torso"]
        self.head_id = name_to_id["head"]

        # per-part 6 local feature points from the collider-union AABB
        self.local_points = f32(self._compute_local_points())   # (14,6,3)

        # reward targets from the initial standing pose
        init = self.scene.initial_state(1)
        tp, tv, tr = self._body_part_targets(init)
        self.target_positions = tp[0]        # (14, 6, 3)
        self.target_velocities = tv[0]       # (14, 6, 3)
        self.target_local_rotations = tr[0]  # (14, 4)
        self.head_target_height = float(init.pos[0, self.head_id, 1])

        if self.gait_enabled:
            ct_ids = rag.cone_twist_ids
            hg_ids = rag.hinge_ids
            pos0 = init.pos[0].cpu().numpy()
            rot0 = init.rot[0].cpu().numpy()

            def world_anchor(arrs, j):
                a = int(arrs.body_a[j])
                la = arrs.local_anchor_a[j].cpu().numpy()
                return pos0[a] + _np_rot(rot0[a], la)

            jct, jh = self.scene.cone_twist, self.scene.hinge
            self._gait_anchors = f32(np.stack([
                world_anchor(jct, ct_ids[3]),   # left hip
                world_anchor(jh, hg_ids[2]),    # left knee
                world_anchor(jct, ct_ids[4]),   # left ankle
                world_anchor(jct, ct_ids[5]),   # right hip
                world_anchor(jh, hg_ids[4]),    # right knee
                world_anchor(jct, ct_ids[6]),   # right ankle
            ]))
            self._base_rot = f32(rot0[np.asarray(rag.body_ids)])  # (14, 4)
            lc = self.scene.body_params.local_cog.cpu().numpy()
            self._init_torso_cog = f32(
                pos0[self.torso_id]
                + _np_rot(rot0[self.torso_id], lc[self.torso_id]))

        self.action_min, self.action_max = self._action_ranges()
        self._ct_ids = torch.as_tensor(
            np.array(rag.cone_twist_ids, np.int64), device=dev)
        self._h_ids = torch.as_tensor(
            np.array(rag.hinge_ids, np.int64), device=dev)
        self._part_parents = torch.as_tensor(
            np.array(BODY_PART_PARENTS, np.int64), device=dev)

    # -- build-time helpers ------------------------------------------------

    def _compute_local_points(self):
        c = self.scene.colliders
        ctype = c.ctype.cpu().numpy()
        a = c.a.cpu().numpy()
        bb = c.b.cpu().numpy()
        r = c.r.cpu().numpy()
        body = c.body.cpu().numpy()
        pts = np.zeros((NUM_BODY_PARTS, 6, 3), np.float32)
        for pi, bid in enumerate(self.body_ids.cpu().numpy()):
            mn = np.full(3, np.inf)
            mx = np.full(3, -np.inf)
            for ci in np.nonzero(body == bid)[0]:
                if ctype[ci] == 0:      # sphere
                    mn = np.minimum(mn, a[ci] - r[ci])
                    mx = np.maximum(mx, a[ci] + r[ci])
                elif ctype[ci] == 1:    # capsule
                    mn = np.minimum(mn, np.minimum(a[ci], bb[ci]) - r[ci])
                    mx = np.maximum(mx, np.maximum(a[ci], bb[ci]) + r[ci])
                elif ctype[ci] == 3:    # box (identity local rotation here)
                    mn = np.minimum(mn, a[ci] - bb[ci])
                    mx = np.maximum(mx, a[ci] + bb[ci])
                else:
                    raise NotImplementedError
            ctr = (mn + mx) * 0.5
            rad = (mx - mn) * 0.5
            for axis in range(3):
                e = np.zeros(3)
                e[axis] = rad[axis]
                pts[pi, axis] = ctr - e
                pts[pi, axis + 3] = ctr + e
        return pts

    def _body_part_targets(self, state: State):
        """World positions + point velocities of the 6 points of every
        part, and each part's rotation relative to its parent body.
        Returns ((B,14,6,3), (B,14,6,3), (B,14,4))."""
        ids = self.body_ids
        pos = state.pos[:, ids]
        rot = state.rot[:, ids]
        pts_w = (quat_rotate(rot[:, :, None, :], self.local_points)
                 + pos[:, :, None, :])

        # point velocity: v + w x (p - cog_world)
        bp = self.scene.body_params
        cog_w = pos + quat_rotate(rot, bp.local_cog[ids])
        v = state.lin_vel[:, ids][:, :, None, :]
        w = state.ang_vel[:, ids][:, :, None, :]
        vel_w = v + cross(w, pts_w - cog_w[:, :, None, :])

        parent = torch.as_tensor(self.parent_ids, device=pos.device)
        parent_rot = torch.where((parent >= 0)[:, None],
                                 state.rot[:, torch.clamp(parent, min=0)],
                                 self._ident_q)
        local_rot = quat_mul(rot, quat_conj(parent_rot))
        return pts_w, vel_w, local_rot

    def _action_ranges(self):
        j_ct = self.scene.cone_twist
        j_h = self.scene.hinge
        mins, maxs = [], []
        for i in self.ragdoll.cone_twist_ids:
            swing = float(j_ct.limit_min[i])
            twist = float(j_ct.limit_max[i])
            mins += [-twist if twist >= 0 else -np.pi,
                     -swing if swing >= 0 else -np.pi, -np.pi]
            maxs += [twist if twist >= 0 else np.pi,
                     swing if swing >= 0 else np.pi, np.pi]
        for i in self.ragdoll.hinge_ids:
            mn = float(j_h.limit_min[i])
            mx = float(j_h.limit_max[i])
            mins.append(mn if mn <= 0 else -np.pi)
            maxs.append(mx if mx >= 0 else np.pi)
        dev = self.device
        return (torch.as_tensor(np.array(mins, np.float32), device=dev),
                torch.as_tensor(np.array(maxs, np.float32), device=dev))

    # -- controls ----------------------------------------------------------

    def _controls_from_action(self, smoothed) -> MotorControls:
        """Position motors with max torque 200 on all 13 joints.
        smoothed: (B, 27)."""
        B = smoothed.shape[0]
        dev = smoothed.device
        ct = smoothed[:, :NUM_CONE_TWIST * 3].reshape(B, NUM_CONE_TWIST, 3)
        hinge_t = smoothed[:, NUM_CONE_TWIST * 3:]

        c = self.scene.default_controls
        n_ct = c.ct_swing_target.shape[0]
        n_h = c.hinge_target.shape[0]

        def scatter(n, ids, vals):
            out = torch.zeros((B, n), dtype=torch.float32, device=dev)
            out[:, ids] = vals
            return out

        ones_ct = torch.ones((B, n_ct), dtype=torch.float32, device=dev)
        ones_h = torch.ones((B, n_h), dtype=torch.float32, device=dev)
        n_s = c.slider_target.shape[0]
        return MotorControls(
            hinge_motor_type=torch.ones((B, n_h), dtype=torch.int32,
                                        device=dev),
            hinge_target=scatter(n_h, self._h_ids, hinge_t),
            hinge_max_torque=ones_h * MOTOR_TORQUE,
            ct_swing_motor_type=torch.ones((B, n_ct), dtype=torch.int32,
                                           device=dev),
            ct_swing_target=scatter(n_ct, self._ct_ids, ct[:, :, 1]),
            ct_swing_axis_angle=scatter(n_ct, self._ct_ids, ct[:, :, 2]),
            ct_swing_max_torque=ones_ct * MOTOR_TORQUE,
            ct_twist_motor_type=torch.ones((B, n_ct), dtype=torch.int32,
                                           device=dev),
            ct_twist_target=scatter(n_ct, self._ct_ids, ct[:, :, 0]),
            ct_twist_max_torque=ones_ct * MOTOR_TORQUE,
            slider_motor_type=torch.zeros((B, n_s), dtype=torch.int32,
                                          device=dev),
            slider_target=torch.zeros((B, n_s), dtype=torch.float32,
                                      device=dev),
            slider_max_force=torch.full((B, n_s), -1.0, dtype=torch.float32,
                                        device=dev),
        )

    # -- observation / reward ------------------------------------------------

    def _torso_cog(self, state: State):
        bp = self.scene.body_params
        return (state.pos[:, self.torso_id]
                + quat_rotate(state.rot[:, self.torso_id],
                              bp.local_cog[self.torso_id]))

    def _observe(self, state: State, smoothed, t=None) -> torch.Tensor:
        """Everything in the torso-ground frame (identity rotation, origin =
        torso COG with y zeroed). With gait enabled, five features are
        appended: gait phase (sin, cos) and the 3-float reference-root
        tracking error. t: (B,) episode time in seconds (None = 0).
        Returns (B, obs_size)."""
        bp = self.scene.body_params
        B = state.pos.shape[0]
        torso_cog = self._torso_cog(state)
        origin = torso_cog * self._xz

        ids = self.obs_parts
        cog_w = state.pos[:, ids] + quat_rotate(state.rot[:, ids],
                                                bp.local_cog[ids])
        rel_pos = cog_w - origin[:, None, :]
        vel = state.lin_vel[:, ids]

        cog_velocity = state.lin_vel[:, self.torso_id]
        parts = torch.cat([rel_pos, vel], dim=-1).reshape(B, -1)
        obs = torch.cat([cog_velocity, parts, smoothed], dim=-1)
        if self.gait_enabled:
            if t is None:
                t = torch.zeros((B,), dtype=torch.float32,
                                device=state.pos.device)
            phase = (2.0 * np.pi * GAIT_FREQUENCY) * t
            drift = self.torso_velocity_target * t[:, None]
            err = torch.clamp(self._init_torso_cog + drift - torso_cog,
                              -2.0, 2.0)
            obs = torch.cat(
                [obs, torch.stack([torch.sin(phase), torch.cos(phase)],
                                  dim=-1), err], dim=-1)
        return obs

    def _head_height(self, state: State):
        return state.pos[:, self.head_id, 1]

    def has_fallen(self, state: State):
        return self._head_height(state) < FALL_HEAD_HEIGHT

    def tracking_failed(self, state: State, t):
        """Gait-mode early termination: horizontal torso-COG distance from
        the gliding reference root exceeds TRACK_FAIL_DIST."""
        torso_cog = self._torso_cog(state)
        drift = self.torso_velocity_target * t[:, None]
        err = (self._init_torso_cog + drift - torso_cog) * self._xz
        return torch.sum(err * err, dim=-1) > TRACK_FAIL_DIST ** 2

    def _gait_pose(self, t):
        """Kinematic walking-reference pose at episode times `t` (B,):
        per-part rigid transforms (rot (B,14,4), trans (B,14,3)) mapping
        the base standing pose to the gait pose (before the forward drift).

        Each leg chain rotates about the lateral (+x) axis at its base-pose
        joint anchors: hips swing sinusoidally in antiphase, knees flex
        during the swing phase, ankles counter-rotate so the feet stay
        level. Amplitude 0 is exactly the standing reference."""
        phase = (2.0 * np.pi * GAIT_FREQUENCY) * t
        zeros = torch.zeros_like(t)
        ident = (torch.stack([zeros, zeros, zeros, zeros + 1.0], dim=-1),
                 torch.stack([zeros, zeros, zeros], dim=-1))

        def rot_about(theta, anchor):
            # rotation by theta about +x through `anchor`:
            # x -> q(x - A) + A  ==  (q, A - q(A))
            half = 0.5 * theta
            q = torch.stack([torch.sin(half), 0.0 * half, 0.0 * half,
                             torch.cos(half)], dim=-1)
            return q, anchor - quat_rotate(q, anchor)

        def compose(outer, inner):
            # x -> outer(inner(x))
            qo, to = outer
            qi, ti = inner
            return quat_mul(qo, qi), quat_rotate(qo, ti) + to

        def leg(ph, a_hip, a_knee, a_ankle):
            th_hip = self.gait_hip_amp * torch.sin(ph)
            th_knee = -self.gait_knee_amp * torch.clamp(
                torch.sin(ph + GAIT_KNEE_PHASE), min=0.0)
            m_hip = rot_about(th_hip, a_hip)
            m_knee = compose(m_hip, rot_about(th_knee, a_knee))
            # ankle counter-rotation keeps the foot level through the cycle
            m_foot = compose(m_knee, rot_about(-(th_hip + th_knee), a_ankle))
            return m_hip, m_knee, m_foot

        a = self._gait_anchors
        l_hip, l_knee, l_foot = leg(phase, a[0], a[1], a[2])
        r_hip, r_knee, r_foot = leg(phase + np.pi, a[3], a[4], a[5])
        # BODY_PART_NAMES order: torso, head, l/r arms (4), then
        # l_u_leg, l_l_leg, l_foot, l_toes, r_u_leg, r_l_leg, r_foot, r_toes
        per_part = [ident] * 6 + [l_hip, l_knee, l_foot, l_foot,
                                  r_hip, r_knee, r_foot, r_foot]
        rots = torch.stack([p[0] for p in per_part], dim=1)     # (B, 14, 4)
        trans = torch.stack([p[1] for p in per_part], dim=1)    # (B, 14, 3)
        return rots, trans

    def _gait_targets(self, t):
        """Gait-reference (positions (B,14,6,3), local rotations (B,14,4))
        at times t, before drift."""
        rots, trans = self._gait_pose(t)
        tp = (quat_rotate(rots[:, :, None, :], self.target_positions)
              + trans[:, :, None, :])
        q_ref = quat_mul(rots, self._base_rot.expand_as(rots))
        # part-index parents (q_ref is part-indexed, not body-indexed)
        parent = self._part_parents
        parent_q = torch.where((parent >= 0)[:, None],
                               q_ref[:, torch.clamp(parent, min=0)],
                               self._ident_q)
        tr = quat_mul(q_ref, quat_conj(parent_q))
        return tp, tr

    def reward(self, state: State, t=None) -> torch.Tensor:
        """DReCon-style tracking reward, (B,). `t` (B,) is the episode time
        in seconds: with a non-zero walk target the reference pose glides
        forward at the target velocity and, with gait enabled, steps its
        legs. Exactly the standing reward when the target is zero."""
        B = state.pos.shape[0]
        if t is None:
            t = torch.zeros((B,), dtype=torch.float32,
                            device=state.pos.device)
        tp, tv, tr = self._body_part_targets(state)
        drift = (self.torso_velocity_target * t[:, None])[:, None, None, :]
        if self.gait_enabled:
            ref_p, ref_r = self._gait_targets(t)
            prev_p, _ = self._gait_targets(t - DT)
            target_positions = ref_p + drift
            # reference point velocities by finite difference over one
            # control step (drift contributes the walk target exactly)
            target_velocities = ((ref_p - prev_p) / DT
                                 + self.torso_velocity_target)
            target_local_rotations = ref_r
        else:
            target_positions = self.target_positions + drift
            target_velocities = (self.target_velocities
                                 + self.torso_velocity_target)
            target_local_rotations = self.target_local_rotations.expand_as(tr)
        pos_err = torch.sum(length(tp - target_positions), dim=(-1, -2))
        vel_err = torch.sum(length(tv - target_velocities), dim=(-1, -2))
        rot_diff = quat_mul(target_local_rotations, quat_conj(tr))
        rot_err = torch.sum(
            2.0 * torch.acos(torch.clamp(rot_diff[..., 3], -1.0, 1.0)),
            dim=-1)

        vcm_err = length(state.lin_vel[:, self.torso_id]
                         - self.torso_velocity_target)

        rp = torch.exp(-10.0 / NUM_BODY_PARTS * pos_err)
        rv = torch.exp(-1.0 / NUM_BODY_PARTS * vel_err)
        rlocal = torch.exp(-10.0 / NUM_BODY_PARTS * rot_err)
        rvcm = torch.exp(-vcm_err)

        fall = torch.clamp(1.3 - 1.4 * (self.head_target_height
                                        - self._head_height(state)), 0.0, 1.0)
        return fall * (rp + rv + rlocal + rvcm)

    # -- gym-like API --------------------------------------------------------

    def reset(self, batch: int) -> Tuple[EnvState, torch.Tensor]:
        """`batch` environments at the initial standing pose."""
        state = self.scene.initial_state(batch)
        smoothed = torch.zeros((batch, ACTION_SIZE), dtype=torch.float32,
                               device=self.device)
        state = state.replace(controls=self._controls_from_action(smoothed))
        env = EnvState(physics=state, smoothed_action=smoothed,
                       steps=torch.zeros((batch,), dtype=torch.int32,
                                         device=self.device))
        return env, self._observe(state, smoothed)

    def step(self, env: EnvState, action, generator: torch.Generator = None
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One 60 Hz control step of every env. Returns (env', obs, reward,
        done), auto-resetting the envs whose `done` fired. The poke draws
        come from `generator` (on the env's device; None = that device's
        default generator)."""
        B = action.shape[0]
        dev = self.device
        do_poke = part = d2 = None
        if self.enable_pokes:
            part = torch.randint(0, NUM_BODY_PARTS, (B,), generator=generator,
                                 device=dev)
            d2 = torch.rand((B, 2), generator=generator, device=dev,
                            dtype=torch.float32) * 2.0 - 1.0
            do_poke = torch.rand((B,), generator=generator, device=dev,
                                 dtype=torch.float32) < POKE_PROBABILITY
        return self._step_with_draws(env, action, do_poke, part, d2)

    def _step_with_draws(self, env: EnvState, action, do_poke, part, d2):
        """`step` with the random draws given: do_poke (B,) bool, part (B,)
        int64 in [0, 14), d2 (B, 2) in [-1, 1). Ignored (may be None) when
        pokes are disabled."""
        B = action.shape[0]
        smoothed = (env.smoothed_action
                    + (action - env.smoothed_action) * ACTION_EMA_BETA)
        state = env.physics.replace(
            controls=self._controls_from_action(smoothed))

        if self.enable_pokes:
            zeros = torch.zeros_like(d2[:, 0])
            direction = torch.stack([d2[:, 0], zeros, d2[:, 1]], dim=-1)
            direction = direction / torch.clamp(length(direction),
                                                min=1e-6)[:, None]
            ar = torch.arange(B, device=action.device)
            up = torch.tensor([0.0, 0.2, 0.0], device=action.device)
            origin = (state.pos[ar, self.body_ids[part]] + up
                      - direction * 5.0)
            poked = apply_ray_impulse(self.scene, state, origin, direction,
                                      POKE_STRENGTH)
            state = _select(do_poke, poked, state)

        state, _ = physics_step(self.scene, state, self.settings, DT)

        t = (env.steps + 1).to(torch.float32) * DT
        obs = self._observe(state, smoothed, t)
        done = self.has_fallen(state)
        if self.gait_enabled:
            done = done | self.tracking_failed(state, t)
        reward = torch.where(done, 0.0, self.reward(state, t))

        next_env = EnvState(physics=state, smoothed_action=smoothed,
                            steps=env.steps + 1)
        # auto-reset
        reset_env, reset_obs = self.reset(B)
        env_out = _select(done, reset_env, next_env)
        obs_out = torch.where(done[:, None], reset_obs, obs)
        return env_out, obs_out, reward, done
