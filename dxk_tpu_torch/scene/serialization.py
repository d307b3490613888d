"""Scene serialization: a `SceneBuilder` (the pre-bake description)
round-trips through a plain dict -> JSON, joints and hulls (vertices, face
planes, mass properties) included; dynamic `State` snapshots round-trip
through npz. Counterpart of the JAX package's scene/serialization.py, with
the same files: a scene or state written by either package loads in the
other.

Cloths, force fields (global and localized: the owner's body index) and
trigger volumes (the colliders' owner type and index, and the count)
round-trip.

A state's npz holds its tensors as `leaf_0`, `leaf_1`, ... in field order
(pos, rot, lin_vel, ang_vel, force_acc, torque_acc, the controls' fields,
then the cloth's positions, prev_positions, velocities and forces where the
state has a cloth), as the JAX package's tree flattening orders them. The
port's states carry the env batch as their first dimension, the JAX
package's do not: `load_state` broadcasts an array that lacks it to the
template's batch.
"""

from __future__ import annotations

import dataclasses
import itertools
import json

import numpy as np
import torch

from dxk_tpu_torch.scene.builder import SceneBuilder, _Body, _Collider, _Joint


def builder_to_dict(b: SceneBuilder) -> dict:
    return {
        "bodies": [
            {"position": body.position.tolist(),
             "rotation": body.rotation.tolist(),
             "kinematic": body.kinematic,
             "gravity_factor": body.gravity_factor,
             "linear_damping": body.linear_damping,
             "angular_damping": body.angular_damping,
             "colliders": list(body.colliders)}
            for body in b._bodies],
        "colliders": [
            {"ctype": c.ctype, "a": np.asarray(c.a).tolist(),
             "b": np.asarray(c.b).tolist(), "r": c.r,
             "rot": np.asarray(c.rot).tolist(), "friction": c.friction,
             "restitution": c.restitution, "density": c.density,
             "body": c.body, "owner_type": c.owner_type,
             "owner_index": c.owner_index, "hull_id": c.hull_id}
            for c in b._colliders],
        "joints": [
            {"kind": j.kind, "body_a": j.body_a, "body_b": j.body_b,
             "params": {k: (np.asarray(v).tolist()
                            if isinstance(v, np.ndarray) else v)
                        for k, v in j.params.items()}}
            for j in b._joints],
        "hulls": [v.tolist() for v in b._hull_geoms],
        "hull_faces": [{"normals": np.asarray(n).tolist(),
                        "offsets": np.asarray(d).tolist()}
                       for n, d in b._hull_faces],
        "hull_props": [{"mass_per_density": float(m),
                        "cog": np.asarray(c).tolist(),
                        "inertia_per_density": np.asarray(i).tolist()}
                       for m, c, i in b._hull_props],
        "force_fields": [
            {"force": np.asarray(ff["force"]).tolist(), "owner": ff["owner"]}
            for ff in b._force_fields],
        "num_triggers": b._num_triggers,
        "cloths": [{**c, "pos": np.asarray(c["pos"]).tolist(),
                    "rot": np.asarray(c["rot"]).tolist()}
                   for c in b._cloths],
    }


def builder_from_dict(d: dict) -> SceneBuilder:
    b = SceneBuilder()
    for body in d["bodies"]:
        b._bodies.append(_Body(
            np.asarray(body["position"], np.float64),
            np.asarray(body["rotation"], np.float64),
            body["kinematic"], body["gravity_factor"],
            body["linear_damping"], body["angular_damping"],
            list(body["colliders"])))
    for c in d["colliders"]:
        b._colliders.append(_Collider(
            c["ctype"], np.asarray(c["a"], np.float64),
            np.asarray(c["b"], np.float64), c["r"],
            np.asarray(c["rot"], np.float64), c["friction"],
            c["restitution"], c["density"], c["body"], c["owner_type"],
            c["owner_index"], c["hull_id"]))
    for j in d["joints"]:
        params = {k: (np.asarray(v, np.float64) if isinstance(v, list) else v)
                  for k, v in j["params"].items()}
        b._joints.append(_Joint(j["kind"], j["body_a"], j["body_b"], params))
    faces = d.get("hull_faces")
    props = d.get("hull_props")
    for hi, v in enumerate(d.get("hulls", [])):
        b._hull_geoms.append(np.asarray(v, np.float64))
        if props is not None:
            p = props[hi]
            b._hull_props.append((p["mass_per_density"],
                                  np.asarray(p["cog"], np.float64),
                                  np.asarray(p["inertia_per_density"],
                                             np.float64)))
        else:   # a dump without hull metadata: collision-only reload
            b._hull_props.append((1.0, np.zeros(3), np.eye(3)))
        if faces is not None:
            f = faces[hi]
            b._hull_faces.append((np.asarray(f["normals"], np.float64),
                                  np.asarray(f["offsets"], np.float64)))
        else:
            b._hull_faces.append((np.zeros((0, 3)), np.zeros((0,))))
    for ff in d.get("force_fields", []):
        b._force_fields.append({"force": np.asarray(ff["force"], np.float64),
                                "owner": ff["owner"]})
    b._num_triggers = d.get("num_triggers", 0)
    # "cloth" (singular) is the format from before scenes held several
    legacy = [d["cloth"]] if d.get("cloth") else []
    for c in legacy + list(d.get("cloths", [])):
        c = dict(c)
        c["pos"] = np.asarray(c["pos"], np.float64)
        c["rot"] = np.asarray(c["rot"], np.float64)
        b._cloths.append(c)
    return b


def save_scene(path: str, b: SceneBuilder) -> None:
    with open(path, "w") as f:
        json.dump(builder_to_dict(b), f, indent=1)


def load_scene(path: str) -> SceneBuilder:
    with open(path) as f:
        return builder_from_dict(json.load(f))


def _leaves(tree, path=""):
    """(dotted name, tensor) of every tensor of `tree` in field order;
    None fields have none."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name),
                               f"{path}.{f.name}" if path else f.name)


def save_state(path: str, state) -> None:
    """Dynamic state snapshot -> npz."""
    leaves = list(_leaves(state))
    np.savez(path, treedef=" ".join(name for name, _ in leaves),
             **{f"leaf_{i}": x.detach().cpu().numpy()
                for i, (_, x) in enumerate(leaves)})


def load_state(path: str, template):
    """Restore a state snapshot into the structure, dtypes and device of
    `template`."""
    data = np.load(path, allow_pickle=False)
    leaf = itertools.count()

    def fill(t):
        x = torch.from_numpy(data[f"leaf_{next(leaf)}"]).to(
            device=t.device, dtype=t.dtype)
        if x.dim() == t.dim() - 1:
            x = x.unsqueeze(0).expand(t.shape[0], *x.shape).clone()
        return x

    return template.map_tensors(fill)
