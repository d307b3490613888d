"""Train the ragdoll standing / locomotion policy with on-device PPO: the
counterpart of the JAX package's examples/train_locomotion.py (the same
flags and defaults), on one CUDA device.

    python -m dxk_tpu_torch.train.train_locomotion --num-envs 4096
    python -m dxk_tpu_torch.train.train_locomotion --resume   # continue
    python -m dxk_tpu_torch.train.train_locomotion --device cpu --num-envs 16

Each iteration rolls every env `--unroll` steps on the fused step, then
runs PPO's updates (train/ppo.py); it prints reward per step, loss, done
rate and env-steps/s, logs the metrics to `--csv`, keeps the best policy
in `--ckpt-dir` and always saves the final one. Both default to names of
the port's own under the temporary directory (`$TMPDIR`, else /tmp), so
the JAX example's checkpoints and best-reward sidecar are never read.
`--resume` restores the latest saved policy and its step. With `--curriculum-stages N` the walk
target ramps over N equal stages of the run: each stage builds a new env
and keeps the policy and Adam's state, and the best-policy tracker starts
afresh (a harder target scores lower).

`main(argv)` runs in-process and returns a summary dict: the steps, the
config, the policy's parameters before the first iteration (fresh or
restored), the final TrainState and per iteration its metrics, its seconds
(all, the rollout's and the updates', each ending in a synchronisation),
the fused-step kernel's launches and Adam's updates.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--num-envs", type=int, default=None,
                    help="default: 1024 on the card, 16 on the CPU")
    ap.add_argument("--unroll", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--solver-iterations", type=int, default=30)
    ap.add_argument("--solver-mode", default="fused",
                    help="fused = the whole contact pipeline in one kernel "
                         "(ops/kernels/csrc/fused_step.cu); or fused_seq")
    ap.add_argument("--walk-target", type=float, default=0.0,
                    help="torso x-velocity target in m/s; 0 = standing task")
    ap.add_argument("--curriculum-stages", type=int, default=0,
                    help="N>0 ramps the walk target to walk-target over N "
                         "equal stages of this run (stage 1 trains at "
                         "walk-target/N; a new env per stage; a resumed "
                         "run restarts the ramp)")
    tmp = tempfile.gettempdir()   # honours TMPDIR
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "dxk_torch_loco_ckpt"))
    ap.add_argument("--csv",
                    default=os.path.join(tmp, "dxk_torch_loco_train.csv"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the envs over all devices: not ported "
                         "(ROADMAP Queue A 10)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; never chosen for you")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh (data-parallel PPO over several devices, the JAX "
            "package's parallel/mesh.py) is not ported yet: ROADMAP Queue "
            "A 10")
    from dxk_tpu_torch.envs.loco_env import LocoEnv
    from dxk_tpu_torch.ops.kernels import fused_step
    from dxk_tpu_torch.scene.scene import resolve_device
    from dxk_tpu_torch.train.ppo import PPOConfig, make_train
    from dxk_tpu_torch.utils.checkpoint import BestModelTracker, Checkpointer
    from dxk_tpu_torch.utils.profiling import StatsLogger, sync

    device = resolve_device(args.device)
    num_envs = args.num_envs or (1024 if device.type == "cuda" else 16)
    config = PPOConfig(num_envs=num_envs, unroll_length=args.unroll,
                       learning_rate=args.lr,
                       num_minibatches=max(4, num_envs // 64))

    def make_step(target):
        # the gait is pinned to the run's walk target (not the stage's), so
        # the obs size (66, or 71 with the gait features) is the same in
        # every stage and checkpoints stay compatible
        env = LocoEnv(solver_iterations=args.solver_iterations,
                      solver_mode=args.solver_mode,
                      narrow_caps={(1, 1): 24, (1, 3): 20, (3, 3): 3},
                      torso_velocity_target=(target, 0.0, 0.0),
                      gait=(args.walk_target != 0.0), device=device)
        return make_train(env, config)

    n_stages = max(args.curriculum_stages, 0)

    def target_for(i):
        if n_stages <= 0 or args.walk_target == 0.0:
            return args.walk_target
        stage = min(i * n_stages // max(args.iters, 1), n_stages - 1)
        return args.walk_target * (stage + 1) / n_stages

    init_fn, step = make_step(target_for(0))
    ckpt = Checkpointer(args.ckpt_dir)
    tracker = BestModelTracker(ckpt)
    log = StatsLogger(args.csv)

    ts = init_fn(0)
    start = 0
    if args.resume and ckpt.latest_step is not None:
        start = ckpt.latest_step
        ckpt.restore(template=ts.net)
        print(f"resumed params from step {start}")
    initial = {k: v.detach().clone() for k, v in ts.net.state_dict().items()}

    t0 = time.time()
    cur_target = target_for(0)
    history = []
    for i in range(start, start + args.iters):
        t = target_for(i - start)
        if t != cur_target:
            cur_target = t
            # a new env for the stage; the policy, Adam's state, the envs'
            # state and the generator carry over (only the reward's
            # target changes)
            _init, step = make_step(t)
            # rewards of different targets are not comparable: the best
            # of this stage starts afresh
            tracker.best = -float("inf")
            print(f"curriculum: walk target -> {t:.2f} m/s")
        t_iter = time.perf_counter()
        launches0, updates0 = fused_step.launch_count(), ts.opt_state.count
        times = {}
        ts, metrics = step(ts, times=times)
        sync(metrics["loss"])
        times["seconds"] = time.perf_counter() - t_iter
        r = float(metrics["reward_per_step"])
        log.log(i, metrics)
        tag = (" (new best, checkpointed)"
               if tracker.update(i, r, ts.net.state_dict()) else "")
        sps = config.num_envs * config.unroll_length / max(
            (time.time() - t0) / (i - start + 1), 1e-9)
        history.append({
            **{k: float(v) for k, v in metrics.items()}, **times,
            "fused_launches": fused_step.launch_count() - launches0,
            "adam_updates": ts.opt_state.count - updates0})
        print(f"iter {i}: reward/step={r:.3f} "
              f"loss={float(metrics['loss']):.3f} "
              f"done_rate={float(metrics['episode_done_rate']):.3f} "
              f"env-steps/s={sps:,.0f}{tag}", flush=True)
    # the final policy is always kept: the curriculum's last stage is the
    # task, even where its rewards never beat an earlier stage's
    ckpt.save(start + args.iters, ts.net.state_dict())
    log.flush()
    print(f"log: {args.csv}; best reward/step: {tracker.best:.3f}; "
          f"final params saved at step {start + args.iters}")
    return {"start": start, "final_step": start + args.iters,
            "num_envs": num_envs, "config": config, "metrics": history,
            "initial_params": initial, "train_state": ts}


if __name__ == "__main__":
    main()
