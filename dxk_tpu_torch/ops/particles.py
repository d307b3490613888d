"""Particle systems (fire / smoke / boid / debris), batched over
environments: the JAX package's ops/particles.py, after the reference's
GPU particle stack (src/particles/particles.cpp and the per-system emit /
sim shaders of shaders/particle_systems/*.hlsli).

A pool is a fixed-capacity SoA of (B, N, ...) tensors with `alive =
life > 0`. Each frame:
  - start: `accum += emit_rate * dt; n = min(floor(accum), num_dead);
    accum -= n` (particle_start_cs.hlsl:26-30), per env;
  - emit: the first n dead slots by prefix-sum rank revive with the
    system's emit rule applied to six uniforms a slot;
  - simulate: every alive slot ages by dt and moves by the system's rule
    (the new ones too: the reference emits, then simulates).
Debris bounces off the scene's colliders (the cloth's particle SDF, the
deepest surface, the first on ties) and the heightfield with reflect *
restitution.

The uniforms come from `draws` (B, N, 6) when given, else from
torch.rand on the pool's device with an explicit generator: the JAX
package's PRNG key is not carried (its bits cannot be reproduced), so
parity tests pass the JAX draws.

Every parameter of a pack may carry a leading env dimension (B,) or not
(shared by all envs); the smoke spline's knots are shared.

Plain PyTorch on the CPU and on the card; no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxk_tpu_torch.core.maths import const, evaluate_spline, normalize, sqrt
from dxk_tpu_torch.scene.scene import _Struct

TWO_PI = 2.0 * np.pi


@dataclass
class ParticleState(_Struct):
    """Fixed-capacity pools, one per env. Slot i is alive iff life > 0.
    `rot` is the billboard (sin, cos)."""

    pos: torch.Tensor         # (B, N, 3)
    vel: torch.Tensor         # (B, N, 3)
    life: torch.Tensor        # (B, N)
    max_life: torch.Tensor    # (B, N)
    rot: torch.Tensor         # (B, N, 2)
    emit_accum: torch.Tensor  # (B,) fractional emission carried over


def init_particles(capacity: int, batch: int = 1,
                   device="cuda") -> ParticleState:
    z3 = torch.zeros((batch, capacity, 3), dtype=torch.float32,
                     device=device)
    z1 = torch.zeros((batch, capacity), dtype=torch.float32, device=device)
    rot = torch.zeros((batch, capacity, 2), dtype=torch.float32,
                      device=device)
    rot[..., 1] = 1.0
    return ParticleState(pos=z3, vel=z3.clone(), life=z1,
                         max_life=torch.ones_like(z1), rot=rot,
                         emit_accum=torch.zeros((batch,), dtype=torch.float32,
                                                device=device))


def alive_count(state: ParticleState) -> torch.Tensor:
    """(B,) int32."""
    return torch.sum((state.life > 0.0).to(torch.int32), dim=-1,
                     dtype=torch.int32)


# -- parameter packs (defaults: the reference's inline constants)


def _f(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


@dataclass
class FireParams(_Struct):
    """fire_particle_system.hlsli:50-72 emit, 75-105 sim."""

    emit_position: torch.Tensor      # (3,) or (B, 3)
    emit_rate: torch.Tensor          # () or (B,) particles/s
    dir_disk_radius: torch.Tensor
    axial_speed: torch.Tensor
    buoyancy: torch.Tensor
    life_min: torch.Tensor
    life_max: torch.Tensor


def fire_params(emit_position=(0.0, 0.0, 0.0), emit_rate=150.0,
                device="cuda"):
    return FireParams(
        emit_position=_f(emit_position, device),
        emit_rate=_f(emit_rate, device), dir_disk_radius=_f(0.1, device),
        axial_speed=_f(4.0, device), buoyancy=_f(5.0, device),
        life_min=_f(1.3, device), life_max=_f(1.8, device))


@dataclass
class SmokeParams(_Struct):
    """smoke_particle_system.hlsli:55-82 emit, 85-110 sim; the
    life-scale-from-distance spline of smoke_particle_system.cpp:40-70."""

    emit_position: torch.Tensor
    emit_rate: torch.Tensor
    radius: torch.Tensor
    gravity: torch.Tensor
    life_spline_ts: torch.Tensor     # (8,)
    life_spline_vals: torch.Tensor   # (8,)


def smoke_params(emit_position=(0.0, 0.0, 0.0), emit_rate=60.0,
                 device="cuda"):
    return SmokeParams(
        emit_position=_f(emit_position, device),
        emit_rate=_f(emit_rate, device), radius=_f(4.0, device),
        gravity=_f(-1.0, device),
        life_spline_ts=_f([0.0, 1.0] + [-1.0] * 6, device),
        life_spline_vals=_f([1.0, 0.4] + [0.0] * 6, device))


@dataclass
class BoidParams(_Struct):
    """boid_particle_system.hlsli:35-84: a ballistic hop with a floor at
    the emit height."""

    emit_position: torch.Tensor
    emit_rate: torch.Tensor
    radius: torch.Tensor
    gravity: torch.Tensor


def boid_params(emit_position=(0.0, 0.0, 0.0), emit_rate=50.0, radius=15.0,
                device="cuda"):
    return BoidParams(emit_position=_f(emit_position, device),
                      emit_rate=_f(emit_rate, device),
                      radius=_f(radius, device), gravity=_f(-9.81, device))


@dataclass
class DebrisParams(_Struct):
    """debris_particle_system.hlsli:52-129: a radial burst from up to E
    emit points, gravity and a per-frame drag multiply, bounce = reflect
    * restitution."""

    emit_positions: torch.Tensor     # (E, 3) or (B, E, 3)
    emit_mask: torch.Tensor          # (E,) or (B, E): which rows are live
    emit_rate: torch.Tensor
    drag: torch.Tensor
    restitution: torch.Tensor
    contact_radius: torch.Tensor     # SDF shell thickness
    max_life: torch.Tensor


def debris_params(emit_positions, emit_rate=200.0, drag=0.995,
                  device="cuda"):
    """`emit_positions` (E, 3), or (B, E, 3) for a batch of its own per
    env; a tensor keeps its device, anything else goes to `device`."""
    if isinstance(emit_positions, torch.Tensor):
        ep = emit_positions.to(torch.float32)
        device = ep.device
    else:
        ep = _f(emit_positions, device)
    if ep.dim() == 1:
        ep = ep[None]
    return DebrisParams(emit_positions=ep,
                        emit_mask=torch.ones(ep.shape[:-1],
                                             dtype=torch.float32,
                                             device=device),
                        emit_rate=_f(emit_rate, device), drag=_f(drag, device),
                        restitution=_f(0.5, device),
                        contact_radius=_f(0.05, device),
                        max_life=_f(5.5, device))


def _s(x):
    """A scalar parameter, () or (B,), as (1, 1) or (B, 1)."""
    return x.reshape(-1, 1)


def _v(x):
    """A vector parameter, (3,) or (B, 3), as (1, 1, 3) or (B, 1, 3)."""
    return x.reshape(-1, 1, 3)


# -- emit rules: uniforms u (B, N, 6) in [0, 1) -> every per-slot field


def _disk(u0, u1, radius):
    """A uniform point on the disk (getRandomPointOnDisk)."""
    r = sqrt(u0) * radius
    a = u1 * TWO_PI
    return r * torch.cos(a), r * torch.sin(a)


def _sin_cos(ang):
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1)


def _emit_fire(p: FireParams, u):
    dx, dy = _disk(u[..., 0], u[..., 1], _s(p.dir_disk_radius))
    vel = normalize(torch.stack([torch.ones_like(dx), dx, dy], -1))
    vel = torch.cat([vel[..., :1] * _s(p.axial_speed)[..., None],
                     vel[..., 1:]], -1)                # velocity.x *= 4
    pos = _v(p.emit_position).expand(vel.shape)
    maxl = _s(p.life_min) + u[..., 2] * (_s(p.life_max) - _s(p.life_min))
    return pos, vel, maxl, _sin_cos(u[..., 3] * TWO_PI)


def _emit_smoke(p: SmokeParams, u):
    radius = _s(p.radius)
    ox, oz = _disk(u[..., 0], u[..., 1], radius)
    pos = _v(p.emit_position) + torch.stack([ox, u[..., 2] * 0.5, oz], -1)
    vel = torch.stack([u[..., 3], u[..., 4] * 3.0 + 4.0, u[..., 5]], -1)
    dist = torch.clamp(sqrt(ox * ox + oz * oz) / radius, 0.0, 1.0)
    scale = evaluate_spline(p.life_spline_ts, p.life_spline_vals, dist)
    maxl = u[..., 2] * 5.0 * scale + 3.0
    return pos, vel, maxl, _sin_cos(u[..., 4] * TWO_PI)


def _emit_boid(p: BoidParams, u):
    ox, oz = _disk(u[..., 0], u[..., 1], _s(p.radius))
    h = u[..., 2] * 2.0 + 3.0
    pos = _v(p.emit_position) + torch.stack([ox, h, oz], -1)
    maxl = u[..., 3] + 4.5
    vx, vz = _disk(u[..., 4], u[..., 5], 1.0)          # a point ON the disk
    speed = 5.0 + u[..., 3] * 1.5
    vel = torch.stack([vx * speed, torch.zeros_like(vx), vz * speed], -1)
    rot = const((0.0, 1.0), u).expand(*u.shape[:-1], 2)
    return pos, vel, maxl, rot


def _emit_debris(p: DebrisParams, u):
    dx, dz = _disk(u[..., 0], u[..., 1], 0.3)
    off = torch.stack([dx, torch.zeros_like(dx), dz], -1)
    vel = normalize(off)
    # emitIndex / 256 picks the batch; here uniform over the live rows
    ep = p.emit_positions.reshape(-1, *p.emit_positions.shape[-2:])
    mask = p.emit_mask.reshape(-1, ep.shape[1])
    ne = ep.shape[1]
    idx = torch.clamp((u[..., 2] * mask.sum(-1, keepdim=True))
                      .to(torch.int32), max=ne - 1).long()
    base = torch.gather(ep.expand(u.shape[0], ne, 3), 1,
                        idx[..., None].expand(*idx.shape, 3))
    maxl = _s(p.max_life).expand(u.shape[:-1])
    return base + off, vel, maxl, _sin_cos(u[..., 3] * TWO_PI)


# -- sim rules: (pos, vel, dt) -> (pos, vel)


def _up(like):
    return const((0.0, 1.0, 0.0), like)


def _sim_fire(p: FireParams, pos, vel, dt):
    vel = vel + _up(vel) * (_s(p.buoyancy)[..., None] * dt)
    return pos + vel * dt, vel


def _sim_smoke(p: SmokeParams, pos, vel, dt):
    g = _up(vel) * (_s(p.gravity)[..., None] * dt)
    return pos + 0.5 * g * dt + vel * dt, vel + g


def _sim_boid(p: BoidParams, pos, vel, dt):
    g = _up(vel) * (_s(p.gravity)[..., None] * dt)
    pos = pos + 0.5 * g * dt + vel * dt
    vel = vel + g
    floor = _v(p.emit_position)[..., 1]
    below = pos[..., 1] <= floor
    pos = torch.cat([pos[..., :1], torch.where(below, floor, pos[..., 1])
                     [..., None], pos[..., 2:]], -1)
    vel = torch.cat([vel[..., :1], torch.where(below, 0.0, vel[..., 1])
                     [..., None], vel[..., 2:]], -1)
    return pos, vel


def _sim_debris(p: DebrisParams, pos, vel, dt, world, hulls, heightfield,
                groups):
    vel = vel + _up(vel) * (-9.81 * dt)
    vel = vel * _s(p.drag)[..., None]
    # the scene's SDF (the reference tests the screen-space depth buffer)
    n = None
    sd = None
    if world is not None and world.a.shape[1] > 0:
        from dxk_tpu_torch.ops.cloth import _particle_collider_sdf
        sdc, nc = _particle_collider_sdf(world, hulls, pos, groups)
        ci = torch.argmin(sdc, dim=1)                 # the first on ties
        sd = torch.amin(sdc, dim=1)
        B, P = ci.shape
        n = torch.gather(nc, 1, ci[:, None, :, None].expand(B, 1, P, 3))[:, 0]
    if heightfield is not None:
        from dxk_tpu_torch.ops.heightmap import height_at
        hsd = pos[..., 1] - height_at(heightfield, pos[..., 0], pos[..., 2])
        up = torch.zeros_like(pos)
        up[..., 1] = 1.0
        if sd is None:
            sd, n = hsd, up
        else:
            use_h = hsd < sd
            sd = torch.where(use_h, hsd, sd)
            n = torch.where(use_h[..., None], up, n)
    if sd is not None:
        vn = torch.sum(vel * n, -1)
        hit = (sd < _s(p.contact_radius)) & (vn < 0.0)
        refl = (vel - 2.0 * vn[..., None] * n) * _s(p.restitution)[..., None]
        vel = torch.where(hit[..., None], refl, vel)
    return pos + vel * dt, vel


_EMIT = {FireParams: _emit_fire, SmokeParams: _emit_smoke,
         BoidParams: _emit_boid, DebrisParams: _emit_debris}
_SIM = {FireParams: _sim_fire, SmokeParams: _sim_smoke,
        BoidParams: _sim_boid}


def particle_step(params, state: ParticleState, dt, world=None, hulls=None,
                  heightfield=None, *, groups=None, generator=None,
                  draws=None) -> ParticleState:
    """One frame of every env's pool: fractional-rate emission into dead
    slots, then the system's sim over every alive slot (the new ones
    too).

    `world` / `hulls` / `heightfield` (ops.shapes.world_colliders of the
    envs' states, scene.hulls, scene.heightfield) are read by debris
    only; with `world`, `groups` = ops.cloth.collider_groups(...) of the
    scene, built once on the host. `draws` (B, N, 6) in [0, 1): the
    uniforms; else torch.rand with `generator` on the pool's device."""
    B, n = state.life.shape
    dead = state.life <= 0.0
    num_dead = torch.sum(dead.to(torch.int32), dim=-1, dtype=torch.int32)
    accum = state.emit_accum + params.emit_rate.reshape(-1) * dt
    n_emit = torch.minimum(accum.to(torch.int32), num_dead)
    accum = accum - n_emit.to(torch.float32)

    rank = torch.cumsum(dead.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    spawn = dead & (rank < n_emit[:, None])
    if draws is None:
        draws = torch.rand((B, n, 6), generator=generator,
                           device=state.life.device)
    epos, evel, emaxl, erot = _EMIT[type(params)](params, draws)
    w = spawn[..., None]
    pos = torch.where(w, epos, state.pos)
    vel = torch.where(w, evel, state.vel)
    max_life = torch.where(spawn, emaxl, state.max_life)
    life = torch.where(spawn, emaxl, state.life)
    rot = torch.where(w, erot, state.rot)

    life = torch.where(life > 0.0, life - dt, life)
    alive = life > 0.0
    if isinstance(params, DebrisParams):
        if world is not None and groups is None:
            raise ValueError("particle_step: debris against `world` needs "
                             "groups=ops.cloth.collider_groups(...)")
        npos, nvel = _sim_debris(params, pos, vel, dt, world, hulls,
                                 heightfield, groups)
    else:
        npos, nvel = _SIM[type(params)](params, pos, vel, dt)
    pos = torch.where(alive[..., None], npos, pos)
    vel = torch.where(alive[..., None], nvel, vel)
    return ParticleState(pos=pos, vel=vel, life=life, max_life=max_life,
                         rot=rot, emit_accum=accum)


# -- render glue (the bitonic sort's analog; not on the sim path)


def render_order(state: ParticleState, camera_position,
                 front_to_back: bool = False):
    """Draw order for alpha blending by camera distance^2 (bitonicSortFloat,
    particles.cpp:188). Returns (order (B, N), alive_sorted (B, N) bool):
    iterate order, skip dead. A stable sort, as jnp.argsort's."""
    cam = torch.as_tensor(np.asarray(camera_position, np.float32),
                          device=state.pos.device)
    v = state.pos - cam
    key = torch.sum(v * v, -1)
    alive = state.life > 0.0
    key = torch.where(alive, key if front_to_back else -key, float("inf"))
    order = torch.argsort(key, dim=-1, stable=True)
    return order, torch.gather(alive, -1, order)


def rel_life(state: ParticleState):
    """getRelLife: 0 (born) -> 1 (dead)."""
    return torch.clamp(1.0 - state.life / torch.clamp(state.max_life,
                                                      min=1e-6), 0.0, 1.0)
