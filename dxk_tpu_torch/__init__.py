"""dxk_tpu_torch — the PyTorch/CUDA port of dxk_tpu.

Mirrors the JAX package module for module (``ops/pallas`` becomes
``ops/kernels``); the batch of environments is an explicit leading tensor
dimension where the JAX package used ``vmap``, and every entry point takes a
``device`` (default ``"cuda"``).

Top-level API:
    SceneBuilder      — describe bodies/colliders/joints, finalize() -> Scene
    physics_step      — (Scene, State, PhysicsSettings, dt) -> (State, StepInfo)
    PhysicsSettings   — solver iterations / mode (``"scan"`` by default,
                        ``"jacobi"`` and ``"colored"`` on the reference
                        step; ``"fused"`` and ``"fused_seq"`` on the fused
                        kernel)
    apply_ray_impulse — poke interaction
    LocoEnv           — batched ragdoll locomotion environment
    islandize         — decompose a scene of identical sub-structures into
                        island envs on the batch axis (scene/islands.py)
"""

__version__ = "0.1.0"

from dxk_tpu_torch.physics import (PhysicsSettings, apply_ray_impulse,  # noqa: F401
                                   physics_step)
from dxk_tpu_torch.scene import SceneBuilder  # noqa: F401


def __getattr__(name):
    if name == "LocoEnv":
        from dxk_tpu_torch.envs.loco_env import LocoEnv
        return LocoEnv
    if name == "islandize":
        from dxk_tpu_torch.scene.islands import islandize
        return islandize
    raise AttributeError(name)
