"""The reference's demo scene, physics parts (application.cpp:79-330), on
the port: the JAX package's examples/demo_scene.py.

A big ground box, three falling spheres, a trigger volume, procedural
terrain with a heightfield collider and a box on it, and a ball-joint
chain hanging from a kinematic anchor, stepped on the reference step
("scan"). Around the step: fire and smoke pools burning at a fixed torch,
collision-begin events mapped to sound triggers, a debris burst at the
first body of a begin event that bounces off the current colliders and
the terrain, and a frame of the debug ray-caster.

    python -m dxk_tpu_torch.examples.demo_scene [--device cpu]

writes six frames as PPM files, dxk_torch_demo_{i}.ppm, into the
temporary directory and prints a line a frame and the spheres' heights.
The default device is "cuda", which raises without a card.

`build_demo_scene`, `init_pools` and `run_frame` run the same loop on a
batch of B envs (chip_smoke.py and the tests call them).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

DT = 1.0 / 120.0
STEPS_PER_FRAME = 60
FRAMES = 6
PARTICLE_DT = 0.5                  # the pools tick once a frame
CAPACITY = 256
TORCH_POSITION = (25.0, 0.5, -5.0)
EYE = (38.0, 8.0, 10.0)
TARGET = (22.0, 2.0, -5.0)
WIDTH, HEIGHT = 160, 120
MIN_IMPULSE = 1e-3
BURST_RATE = 400.0
SOUND_SEED = 519431                # the demo's sound-pitch seed
TERRAIN = dict(size=48, cell_size=2.0, height_scale=4.0, seed=3)


def build_demo_scene(with_chain=True, with_terrain=True, heights=None,
                     device="cuda"):
    """(SceneBuilder, sphere body ids), builder call for builder call as
    the JAX example's; the terrain's noise is computed on `device`.
    `heights`: (48, 48) terrain heights to use in place of
    utils.noise.terrain_heightfield's (the tests pass the JAX package's,
    to keep the noise's rounding out of the step's)."""
    from dxk_tpu_torch.scene import SceneBuilder
    from dxk_tpu_torch.utils.noise import terrain_heightfield

    b = SceneBuilder()

    ground = b.add_static(position=(25.0, -4.0, -5.0))
    b.add_box_collider(ground, (0, 0, 0), (30.0, 4.0, 30.0),
                       friction=1.0, restitution=0.1)

    spheres = []
    for i in range(3):
        s = b.add_body(position=(25.0, 10.0 + i * 3.0, -5.0))
        b.add_sphere_collider(s, (0, 0, 0), 1.0, friction=0.5,
                              restitution=0.1, density=1.0)
        spheres.append(s)

    trig = b.add_static(position=(25.0, 1.0, -5.0))
    b.add_box_collider(trig, (0, 0, 0), (5.0, 1.0, 5.0))
    b.mark_trigger(trig)

    if with_terrain:
        if heights is None:
            heights = terrain_heightfield(**TERRAIN,
                                          device=device).cpu().numpy()
        b.set_heightfield(heights, cell_size=2.0,
                          min_corner=(-60.0, -2.0, -60.0), friction=0.8)
        t = b.add_body(position=(-40.0, 8.0, -40.0))
        b.add_box_collider(t, (0, 0, 0), (0.8, 0.8, 0.8), density=300.0)

    if with_chain:
        anchor = b.add_body(position=(20.0, 8.0, 0.0), kinematic=True)
        prev = anchor
        for i in range(6):
            link = b.add_body(position=(20.0, 7.4 - i * 0.6, 0.0))
            b.add_capsule_collider(link, (0, -0.2, 0), (0, 0.2, 0), 0.08,
                                   density=500.0)
            b.add_ball_constraint(prev, link, (20.0, 7.7 - i * 0.6, 0.0))
            prev = link

    return b, spheres


def finalize_demo(builder, device="cuda"):
    return builder.finalize(max_narrow_pairs_per_group=64, device=device)


def init_pools(batch, device="cuda"):
    """{"fire", "smoke", "debris": (params, ParticleState (batch, 256))}:
    the torch's fire and smoke, and a debris pool with one emit point per
    env and no emission until a burst."""
    from dxk_tpu_torch.ops.particles import (debris_params, fire_params,
                                             init_particles, smoke_params)
    x, y, z = TORCH_POSITION
    debris = debris_params(torch.zeros((batch, 1, 3), device=device),
                           emit_rate=np.zeros(batch, np.float32),
                           device=device)
    return {"fire": (fire_params(TORCH_POSITION, 150.0, device),
                     init_particles(CAPACITY, batch, device)),
            "smoke": (smoke_params((x, y + 1.0, z), 40.0, device),
                      init_particles(CAPACITY, batch, device)),
            "debris": (debris, init_particles(CAPACITY, batch, device))}


@dataclass
class Frame:
    state: Any                 # State (B envs) after the frame's steps
    info: Any                  # StepInfo of its last step
    pools: dict
    events: List               # per env: (begins, ends)
    sounds: List               # per env: collision_sound_triggers(...)
    rgb: Any = None            # (B, H, W, 3)
    depth: Any = None          # (B, H, W)
    seconds: dict = None       # wall seconds of the frame's parts


def _clock(device):
    """perf_counter after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def run_frame(scene, state, pools, prev_info, *, groups, rng,
              steps=STEPS_PER_FRAME, generator=None, draws=None,
              width=WIDTH, height=HEIGHT, render_frame=True):
    """One frame of the demo on B envs: `steps` physics steps, one tick
    of each pool (debris against the envs' current colliders and the
    terrain; `groups` = ops.cloth.collider_groups of the scene, built once),
    begin events against `prev_info`, sound triggers (one rng, env by
    env), a debris burst at the first begin event's body in each env that
    has one, and a render of every env. `draws`: {pool name: (B, 256, 6)
    uniforms} in place of the generator's. Frame.seconds times the steps,
    the pools' ticks, the events with the sounds and the burst, and the
    render, each up to the device's end of it. Runs in inference mode (the
    demo takes no gradients; each operation then costs the host less), so
    what it returns is not to be updated in place outside that mode."""
    from dxk_tpu_torch.events import collision_events_batched
    from dxk_tpu_torch.ops.particles import particle_step
    from dxk_tpu_torch.ops.shapes import world_colliders
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    from dxk_tpu_torch.render.raster import render
    from dxk_tpu_torch.utils.sound import collision_sound_triggers

    settings = PhysicsSettings()           # "scan", as the JAX example
    draws = draws or {}
    dev = state.pos.device
    info = None
    t = [_clock(dev)]
    for _ in range(steps):
        state, info = physics_step(scene, state, settings, DT)
    t.append(_clock(dev))

    pools = dict(pools)
    for name in ("fire", "smoke"):
        p, ps = pools[name]
        pools[name] = (p, particle_step(p, ps, PARTICLE_DT,
                                        generator=generator,
                                        draws=draws.get(name)))
    p, ps = pools["debris"]
    w = world_colliders(scene, state.pos, state.rot)
    ps = particle_step(p, ps, PARTICLE_DT, world=w, hulls=scene.hulls,
                       heightfield=scene.heightfield, groups=groups,
                       generator=generator, draws=draws.get("debris"))
    p = p.replace(emit_rate=torch.zeros_like(p.emit_rate))  # one-frame bursts
    t.append(_clock(dev))

    events = collision_events_batched(scene, prev_info, info,
                                      min_impulse=MIN_IMPULSE)
    sounds = [collision_sound_triggers(scene, begins, rng=rng)
              for begins, _ends in events]
    burst = [(e, begins[0].body_a) for e, (begins, _) in enumerate(events)
             if begins]
    if burst:
        envs, bodies = (torch.tensor(x, device=state.pos.device)
                        for x in zip(*burst))
        ep = p.emit_positions.clone()
        ep[envs, 0] = state.pos[envs, bodies]
        rate = torch.zeros_like(p.emit_rate)
        rate[envs] = BURST_RATE
        p = p.replace(emit_positions=ep, emit_rate=rate)
    pools["debris"] = (p, ps)
    t.append(_clock(dev))

    rgb = depth = None
    if render_frame:
        rgb, depth = render(scene, state, eye=EYE, target=TARGET,
                            width=width, height=height)
    t.append(_clock(dev))
    seconds = dict(zip(("steps", "particles", "events", "render"),
                       np.diff(t).tolist()))
    return Frame(state=state, info=info, pools=pools, events=events,
                 sounds=sounds, rgb=rgb, depth=depth, seconds=seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("demo_scene: no CUDA device; pass --device cpu")

    from dxk_tpu_torch.ops.cloth import collider_groups
    from dxk_tpu_torch.ops.particles import alive_count

    builder, spheres = build_demo_scene(device=args.device)
    scene = finalize_demo(builder, args.device)
    groups = collider_groups(scene.colliders.ctype.cpu().numpy(),
                             scene.hulls is not None, args.device)
    state = scene.initial_state(1)
    pools = init_pools(1, args.device)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    rng = np.random.default_rng(SOUND_SEED)
    prev_info = None
    for frame_i in range(FRAMES):
        fr = run_frame(scene, state, pools, prev_info, groups=groups,
                       rng=rng, generator=gen)
        state, pools, prev_info = fr.state, fr.pools, fr.info
        for trig in fr.sounds[0]:
            print(f"  sound {trig['sound_id']}: bodies "
                  f"({trig['body_a']},{trig['body_b']}) "
                  f"pitch={trig['pitch']:.2f} volume={trig['volume']:.2f}")
        img = (np.clip(fr.rgb[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        path = os.path.join(tempfile.gettempdir(),
                            f"dxk_torch_demo_{frame_i}.ppm")
        with open(path, "wb") as f:
            f.write(f"P6 {WIDTH} {HEIGHT} 255\n".encode() + img.tobytes())
        trigger = (fr.info.trigger_overlap[0].cpu().numpy()
                   if fr.info.trigger_overlap is not None else None)
        alive = {k: int(alive_count(pools[k][1])[0]) for k in pools}
        print(f"t={PARTICLE_DT * (frame_i + 1):.1f}s wrote {path}; "
              f"trigger={trigger}, "
              f"contacts={int(fr.info.num_contacts[0])}, particles alive "
              f"fire={alive['fire']} smoke={alive['smoke']} "
              f"debris={alive['debris']}")

    ys = [float(state.pos[0, s, 1]) for s in spheres]
    print("sphere heights:", [round(y, 2) for y in ys])


if __name__ == "__main__":
    main()
