"""Carrying weights and state between the JAX package and the port.

Everything here takes and returns numpy arrays or torch tensors; nothing
imports JAX. A caller that holds JAX arrays converts them with
``numpy.asarray`` first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dxk_tpu_torch.scene.scene import ClothState, MotorControls, State


def policy_state_dict_from_flax(params) -> dict:
    """ActorCritic `state_dict` from a flax parameter tree given as nested
    dicts of numpy arrays (``{"params": {"pi": {"Dense_0": {"kernel",
    "bias"}, ...}, "vf": {...}, "log_std"}}``, with or without the outer
    "params"). A flax ``Dense.kernel`` is (in, out); ``nn.Linear.weight``
    is (out, in)."""
    p = params.get("params", params)
    out = {"log_std": torch.from_numpy(np.array(p["log_std"], np.float32))}
    for head in ("pi", "vf"):
        for i in range(3):
            layer = p[head][f"Dense_{i}"]
            out[f"{head}.dense{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layer["kernel"], np.float32).T,
                         order="C"))                  # a writable copy
            out[f"{head}.dense{i}.bias"] = torch.from_numpy(
                np.array(layer["bias"], np.float32))
    return out


def _adam_state(opt_state):
    """The ScaleByAdamState (anything with `count`, `mu` and `nu`) inside an
    optax state tree of tuples and named tuples."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for x in opt_state:
            found = _adam_state(x)
            if found is not None:
                return found
    return None


def ppo_state_from_optax(params, opt_state) -> dict:
    """The port's PPO state from a JAX TrainState's flax params and optax
    state (`chain(clip_by_global_norm, adam)`: (EmptyState,
    (ScaleByAdamState(count, mu, nu), EmptyState)), leaves as numpy):
    {"weights": ActorCritic state_dict, "count": Adam's step count,
    "mu", "nu": its moments as state_dicts of the same keys}. mu and nu
    have the params' tree, so a kernel's moments are transposed like the
    kernel. `train.ppo.adam_state_from_state_dicts` turns the moments into
    the trainer's AdamState."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("ppo_state_from_optax: no ScaleByAdamState "
                         "(count, mu, nu) in the optax state")
    return {"weights": policy_state_dict_from_flax(params),
            "count": int(np.asarray(adam.count)),
            "mu": policy_state_dict_from_flax(adam.mu),
            "nu": policy_state_dict_from_flax(adam.nu)}


def policy_state_dict_from_npz(path) -> dict:
    """The same from an .npz written by tools/export_policy_npz.py, whose
    keys are the flax tree paths joined by '/' (e.g. "pi/Dense_0/kernel")."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return policy_state_dict_from_flax(tree)


def _tensor(x, device, batch):
    t = torch.from_numpy(np.array(x)).to(device)      # a writable copy
    return t if batch is None else t.unsqueeze(0).expand(
        batch, *t.shape).clone()


def controls_from_numpy(fields: dict, device="cuda", batch=None
                        ) -> MotorControls:
    """MotorControls from {field: ndarray}. Arrays already carry the env
    batch dimension unless `batch` is given, which broadcasts unbatched
    arrays to that many envs."""
    return MotorControls(**{
        f.name: _tensor(fields[f.name], device, batch)
        for f in dataclasses.fields(MotorControls)})


def cloth_state_from_numpy(fields: dict, device="cuda", batch=None
                           ) -> ClothState:
    """ClothState from {"positions", "prev_positions", "velocities",
    "forces": ndarray}, batched like controls_from_numpy."""
    return ClothState(**{
        f.name: _tensor(fields[f.name], device, batch).to(torch.float32)
        for f in dataclasses.fields(ClothState)})


def state_from_numpy(fields: dict, device="cuda", batch=None) -> State:
    """State from {"pos", "rot", "lin_vel", "ang_vel", "force_acc",
    "torque_acc": ndarray, "controls": {field: ndarray} or None,
    "cloth": <cloth_state_from_numpy fields> or None}."""
    ctl = fields.get("controls")
    cloth = fields.get("cloth")
    return State(
        **{k: _tensor(fields[k], device, batch).to(torch.float32)
           for k in ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                     "torque_acc")},
        controls=(controls_from_numpy(ctl, device, batch)
                  if ctl is not None else None),
        cloth=(cloth_state_from_numpy(cloth, device, batch)
               if cloth is not None else None))


def env_state_from_numpy(fields: dict, device="cuda", batch=None):
    """EnvState from {"physics": <state_from_numpy fields>,
    "smoothed_action": ndarray, "steps": ndarray}."""
    from dxk_tpu_torch.envs.loco_env import EnvState
    return EnvState(
        physics=state_from_numpy(fields["physics"], device, batch),
        smoothed_action=_tensor(fields["smoothed_action"], device,
                                batch).to(torch.float32),
        steps=_tensor(fields["steps"], device, batch).to(torch.int32))


def _flatten(prefix, obj, out):
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            _flatten(f"{prefix}.{i}", x, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.metadata.get("port_only"):
                continue
            _flatten(f"{prefix}.{f.name}" if prefix else f.name,
                     getattr(obj, f.name), out)
    elif isinstance(obj, (int, float, str, bool)):
        out[prefix] = np.asarray(obj)


def scene_arrays(scene) -> dict:
    """The port's Scene as a flat {dotted.name: ndarray} dict (static ints
    and strings as 0-d arrays), for comparison with the JAX Scene. Fields
    the JAX package has no counterpart of (scene.port_only) are left
    out."""
    out: dict = {}
    _flatten("", scene, out)
    return out


def particle_state_from_numpy(fields: dict, device="cuda", batch=None):
    """ops.particles.ParticleState from {"pos", "vel", "life", "max_life",
    "rot", "emit_accum": ndarray}, batched like controls_from_numpy (a
    JAX ParticleState's fields; its "key" is dropped: the port draws from
    a torch.Generator or takes `draws`)."""
    from dxk_tpu_torch.ops.particles import ParticleState
    return ParticleState(**{
        f.name: _tensor(fields[f.name], device, batch).to(torch.float32)
        for f in dataclasses.fields(ParticleState)})


def particle_params_from_numpy(kind: str, fields: dict, device="cuda"):
    """One of the four parameter packs of ops.particles ("fire", "smoke",
    "boid" or "debris") from {field: ndarray} (a JAX pack's fields)."""
    from dxk_tpu_torch.ops import particles
    cls = {"fire": particles.FireParams, "smoke": particles.SmokeParams,
           "boid": particles.BoidParams,
           "debris": particles.DebrisParams}[kind]
    return cls(**{f.name: _tensor(fields[f.name], device, None)
                  .to(torch.float32) for f in dataclasses.fields(cls)})


def trs_from_numpy(fields: dict, device="cuda", batch=None):
    """ops.animation.Trs from {"pos", "rot", "scale": ndarray}."""
    from dxk_tpu_torch.ops.animation import Trs
    return Trs(**{k: _tensor(fields[k], device, batch).to(torch.float32)
                  for k in ("pos", "rot", "scale")})


def animation_clip_from_numpy(fields: dict, device="cuda"):
    """ops.animation.AnimationClip from {"pos", "rot", "scale": {"ts",
    "vals", "count": ndarray}, "animated", "length": ndarray, and the
    static "looping", "bake_root_rotation", "bake_root_xz",
    "bake_root_y": bool}."""
    from dxk_tpu_torch.ops.animation import AnimationClip, Channel

    def channel(ch):
        return Channel(ts=_tensor(ch["ts"], device, None).to(torch.float32),
                       vals=_tensor(ch["vals"], device, None)
                       .to(torch.float32),
                       count=_tensor(ch["count"], device, None)
                       .to(torch.int32))
    return AnimationClip(
        pos=channel(fields["pos"]), rot=channel(fields["rot"]),
        scale=channel(fields["scale"]),
        animated=_tensor(fields["animated"], device, None).to(torch.bool),
        length=_tensor(fields["length"], device, None).to(torch.float32),
        **{k: bool(fields[k]) for k in ("looping", "bake_root_rotation",
                                        "bake_root_xz", "bake_root_y")})


def animation_instance_from_numpy(fields: dict, device="cuda", batch=None):
    """ops.animation.AnimationInstance from {"time": ndarray (I,),
    "last_root": <trs_from_numpy fields>}; `batch` broadcasts one
    instance's arrays."""
    from dxk_tpu_torch.ops.animation import AnimationInstance
    return AnimationInstance(
        time=_tensor(fields["time"], device, batch).to(torch.float32),
        last_root=trs_from_numpy(fields["last_root"], device, batch))
