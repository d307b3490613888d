"""The motor gear's spin at step 180 of BASELINE config 4, JAX package
against the PyTorch port, on the CPU: what chip_smoke.py's config4 spin
gates are set from.

Builds config 4 as chip_smoke.py's config4 phase does (bench.py:354-396:
terrain, driven vehicle, sheet, orbit_margin=0.5) in both packages and
steps the first --envs envs of that phase's initial state
(chip_smoke.config4_initial_state: env 0 as dropped, the others with the
seeded 0.01 m/s numpy velocity noise, the same envs at every batch) for
--steps steps at 30 iterations and dt 1/120, "colored" cloth: the JAX
package's compiled "jacobi" step (jit of vmap; its "fused" step does not
compile in minutes) and the port's "fused" step (the kernel's plain
version on the CPU). Prints one JSON line per run: the motor gear's |w_y|
at the last step in env 0 and in every env, and the share of envs 1.. above
tests/test_vehicle.py's 0.05 rad/s.

    JAX_PLATFORMS=cpu python3 tools/vehicle_spin_cpu.py [--envs 64]
        [--steps 180] [--seed 14] [--runs jax,port]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERATIONS = 30


def run_jax(envs, steps, seed):
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from dxk_tpu.models.vehicle import add_vehicle
    from dxk_tpu.physics import PhysicsSettings, physics_step
    from dxk_tpu.scene import SceneBuilder
    b, veh = cs.config4_builder(SceneBuilder, add_vehicle)
    scene = b.finalize(orbit_margin=cs.CONFIG4_ORBIT_MARGIN)
    c = scene.default_controls
    scene = scene.replace(default_controls=c.replace(**{
        name: getattr(c, name).at[veh.motor_hinge].set(value)
        for name, value in cs.CONFIG4_MOTOR.items()}))
    s = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                        solver_mode="jacobi",
                        cloth_solver_mode=cs.CONFIG4_MODE)
    one = scene.initial_state()
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (envs,) + x.shape), one)
    noise = cs.config4_noise(envs, one.lin_vel.shape[0], seed)
    st = st.replace(lin_vel=st.lin_vel + jnp.asarray(noise))
    step = jax.jit(jax.vmap(lambda x: physics_step(scene, x, s, cs.CONFIG4_DT)[0]))
    for _ in range(steps):
        st = step(st)
    return np.asarray(st.ang_vel[:, veh.parts["motor_gear"], 1])


def run_port(envs, steps, seed):
    import chip_smoke as cs
    from dxk_tpu_torch.physics import PhysicsSettings, physics_step
    scene, veh = cs.config4_scene("cpu")
    s = PhysicsSettings(num_rigid_solver_iterations=ITERATIONS,
                        solver_mode="fused", cloth_solver_mode=cs.CONFIG4_MODE)
    st = cs.config4_initial_state(scene, envs, seed)
    for _ in range(steps):
        st = physics_step(scene, st, s, cs.CONFIG4_DT)[0]
    return st.ang_vel[:, veh.parts["motor_gear"], 1].numpy()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=180)
    ap.add_argument("--seed", type=int, default=14,
                    help="chip_smoke.py's config4 seed (its --seed + 14)")
    ap.add_argument("--runs", default="jax,port")
    args = ap.parse_args()
    import chip_smoke as cs
    runs = {"jax": run_jax, "port": run_port}
    for name in args.runs.split(","):
        t0 = time.perf_counter()
        wy = np.abs(runs[name](args.envs, args.steps, args.seed))
        print(json.dumps(dict(
            run=name, envs=args.envs, steps=args.steps, seed=args.seed,
            seconds=time.perf_counter() - t0,
            env0_abs_wy=float(wy[0]),
            share_above=float((wy[1:] > cs.CONFIG4_SPIN).mean()),
            above=int((wy[1:] > cs.CONFIG4_SPIN).sum()),
            of=int(wy.shape[0] - 1),
            abs_wy=[round(float(x), 5) for x in wy])), flush=True)


if __name__ == "__main__":
    main()
