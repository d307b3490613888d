"""Build-time island decomposition: map a large scene of independent
sub-structures (towers, ragdoll farms, chain arrays) onto the batch axis.

A 1k-body scene of 64 identical towers steps as 64 envs of one 16-body
sub-scene, so the fused-step kernel takes it (small per-env tables, one
team of warps an env) instead of one 1k-body monolith on the reference
step. Counterpart of the JAX package's scene/islands.py.

Requirements (checked, `islandize` raises NotIslandizable otherwise):
  - static candidate tables (finalize(candidate_margin=...) prunes a big
    scene into disconnected components; K-select and sort-and-sweep scenes
    have no static tables);
  - all islands identical: same local topology and same collider / body /
    joint parameters (initial positions may differ: they live in State);
  - no cloth, heightfield, triggers or force fields.

Bodies with inv_mass == 0 (statics, kinematic anchors) do not transmit
impulses, so they do not merge islands; each island referencing one gets a
local replica.

The topology work is numpy on host copies of the scene, once; `gather` and
`scatter` are index operations on the state's device.

Usage (B worlds of I islands each):
    scene = builder.finalize(candidate_margin=0.25, contact_phases=2)
    im = islandize(scene)
    st = im.gather(scene.initial_state(B))        # (B * I, nbl + 1, ...)
    st, info = physics_step(im.sub_scene, st, settings, dt)
    full = im.scatter(st, scene.initial_state(B))  # back to (B, N + 1, ...)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dxk_tpu_torch.ops.kernels.cm_joint_prep import CTL_ATTRS
from dxk_tpu_torch.scene.scene import (JOINT_TYPES, BodyParams, Colliders,
                                       JointsOfType, MotorControls, PairGroup,
                                       Scene, State)

STATE_FIELDS = ("pos", "rot", "lin_vel", "ang_vel", "force_acc",
                "torque_acc")
# the motor-control fields of each control-bearing joint type
CTRL_FIELDS = {name: tuple(attrs.values())
               for name, attrs in CTL_ATTRS.items()}
JOINT_PARAM_FIELDS = ("local_anchor_a", "local_anchor_b", "length",
                      "initial_inv_rotation_difference", "local_axis_a",
                      "local_axis_b", "local_tangent_a", "local_bitangent_a",
                      "local_tangent_b", "limit_min", "limit_max")


class NotIslandizable(ValueError):
    pass


@dataclass
class IslandMap:
    """sub_scene: the representative island Scene (nbl bodies + dummy);
    body_map: (I, nbl) int32 global body index per island-local slot;
    *_ctrl_map: (I, Jl) int32 global joint index per island-local joint of
    the control-bearing types (None where the island has none); gather
    slices the caller's MotorControls with them."""

    sub_scene: Scene
    body_map: torch.Tensor
    num_islands: int
    hinge_ctrl_map: Optional[torch.Tensor] = None
    ct_ctrl_map: Optional[torch.Tensor] = None
    slider_ctrl_map: Optional[torch.Tensor] = None

    def __post_init__(self):
        dev = self.body_map.device
        flat = self.body_map.reshape(-1).cpu().numpy()
        # scatter writes each global row once: of a replicated zero-mass
        # row, its last replica (the last write of the JAX package's
        # .at[].set)
        last = {g: k for k, g in enumerate(flat)}
        keep = np.array(sorted(last.values()), np.int64)
        self._take = torch.from_numpy(keep).to(dev)
        self._put = torch.from_numpy(flat[keep].astype(np.int64)).to(dev)
        self._ctrl = {name: getattr(self, attr).long()
                      for name, attr in (("hinge", "hinge_ctrl_map"),
                                         ("cone_twist", "ct_ctrl_map"),
                                         ("slider", "slider_ctrl_map"))
                      if getattr(self, attr) is not None}

    def gather(self, state: State) -> State:
        """(B, N+1, ...) -> (B * I, nbl+1, ...), env b * I + i holding
        island i of world b. The local dummy row is the global dummy row."""
        B, n1 = state.pos.shape[:2]
        idx = torch.cat([self.body_map.long(), torch.full(
            (self.num_islands, 1), n1 - 1, dtype=torch.long,
            device=self.body_map.device)], dim=1)

        def take(x):
            out = x[:, idx]                          # (B, I, nbl+1, ...)
            return out.reshape(B * self.num_islands, *out.shape[2:])

        return state.replace(
            **{f: take(getattr(state, f)) for f in STATE_FIELDS},
            controls=self._gather_controls(state.controls), cloth=None)

    def _gather_controls(self, controls):
        """Slice the caller's (B, J) MotorControls into (B * I, Jl) island
        space through the per-island joint maps (identical topology gives
        every island the same count, in corresponding order)."""
        if controls is None:
            return None
        n_isl = self.num_islands
        out = {}
        for name, fields in CTRL_FIELDS.items():
            cmap = self._ctrl.get(name)
            for f in fields:
                arr = getattr(controls, f)
                B = arr.shape[0]
                if cmap is None:
                    out[f] = arr.new_zeros((B * n_isl, 0))
                else:
                    out[f] = arr[:, cmap].reshape(B * n_isl, -1)
        return MotorControls(**out)

    def scatter(self, island_state: State, template_state: State) -> State:
        """(B * I, nbl+1, ...) -> (B, N+1, ...): write the island rows back
        into a copy of a full-scene state (each replicated zero-mass row
        from its last replica; they never change)."""
        B = template_state.pos.shape[0]

        def put(tmpl, isl):
            vals = isl[:, :-1].reshape(B, -1, *isl.shape[2:])
            out = tmpl.clone()
            out[:, self._put] = vals[:, self._take]
            return out

        return template_state.replace(**{
            f: put(getattr(template_state, f), getattr(island_state, f))
            for f in STATE_FIELDS})


def _np(x):
    return x.detach().cpu().numpy()


def islandize(scene: Scene, strict_params: bool = True) -> IslandMap:
    """Decompose `scene` into identical islands. Raises NotIslandizable if
    the scene has non-identical islands or unsupported features."""
    if scene.cloth is not None or scene.heightfield is not None:
        raise NotIslandizable("cloth/heightfield scenes not supported")
    if scene.overlap_groups or (scene.overlap_pairs is not None
                                and scene.overlap_pairs.shape[0] > 0):
        raise NotIslandizable("trigger/force-field scenes not supported")
    if scene.broadphase_k > 0:
        raise NotIslandizable(
            f"{scene.broadphase_kind} scenes have no static tables")

    dev = scene.device
    nb = scene.num_bodies
    dynamic = _np(scene.body_params.inv_mass)[:nb] > 0.0
    col = {f.name: _np(getattr(scene.colliders, f.name))
           for f in dataclasses.fields(Colliders)}
    col_body = col["body"]
    group_pairs = [_np(g.pairs) for g in scene.pair_groups]
    joints = {name: getattr(scene, name) for name in JOINT_TYPES}
    joint_ab = {name: (_np(j.body_a), _np(j.body_b))
                for name, j in joints.items() if j is not None}

    # union-find over dynamic bodies
    parent = np.arange(nb)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = [np.stack([col_body[p[:, 0]], col_body[p[:, 1]]], -1)
             for p in group_pairs]
    edges += [np.stack([a, b], -1) for a, b in joint_ab.values()]
    all_edges = np.concatenate(edges) if edges else np.zeros((0, 2), int)
    for a, b in all_edges:
        a, b = int(a), int(b)
        if a < nb and b < nb and dynamic[a] and dynamic[b]:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    roots = {}
    for i in range(nb):
        if dynamic[i]:
            roots.setdefault(find(i), []).append(i)
    islands_dyn = sorted(roots.values(), key=lambda lst: lst[0])
    n_isl = len(islands_dyn)
    if n_isl < 2:
        raise NotIslandizable(f"{n_isl} island(s) — nothing to decompose")

    # per island: the zero-mass (kinematic / static-owner) bodies its
    # joints and pair tables reference
    isl_of = np.full(nb, -1)
    for ii, lst in enumerate(islands_dyn):
        isl_of[lst] = ii
    ref_sets = [set() for _ in range(n_isl)]
    for a, b in all_edges:
        a, b = int(a), int(b)
        for x, y in ((a, b), (b, a)):
            if x < nb and dynamic[x] and y < nb and not dynamic[y]:
                ref_sets[isl_of[x]].add(y)
    islands = [lst + sorted(ref_sets[ii])
               for ii, lst in enumerate(islands_dyn)]

    sizes = {len(lst) for lst in islands}
    if len(sizes) != 1:
        raise NotIslandizable(f"unequal island sizes: {sorted(sizes)}")
    nbl = sizes.pop()

    # local body index per island; the global dummy maps to the local one
    g2l = []
    for lst in islands:
        m = {g: i for i, g in enumerate(lst)}
        m[nb] = nbl
        g2l.append(m)

    # per-island colliders: those of the island's bodies (replicated
    # kinematic ones included), then every static-owner collider (body ==
    # dummy) paired with one of them, e.g. the shared ground
    own_cols = [[] for _ in range(n_isl)]
    static_refs = [set() for _ in range(n_isl)]
    for ci, b in enumerate(col_body):
        b = int(b)
        if b < nb and isl_of[b] >= 0:
            own_cols[isl_of[b]].append(ci)
    for ci, b in enumerate(col_body):
        b = int(b)
        if b < nb and not dynamic[b]:
            for ii in range(n_isl):
                if b in g2l[ii]:
                    own_cols[ii].append(ci)
    for p in group_pairs:
        ba, bb = col_body[p[:, 0]], col_body[p[:, 1]]
        for (c0, c1), b0, b1 in zip(p, ba, bb):
            for cs, bs, bo in ((c0, b0, b1), (c1, b1, b0)):
                if bs == nb and bo < nb and isl_of[bo] >= 0:
                    static_refs[isl_of[bo]].add(int(cs))
    col_lists = [sorted(set(own_cols[ii])) + sorted(static_refs[ii])
                 for ii in range(n_isl)]
    csizes = {len(lst) for lst in col_lists}
    if len(csizes) != 1:
        raise NotIslandizable(f"unequal collider counts: {sorted(csizes)}")
    cmaps = [{g: i for i, g in enumerate(lst)} for lst in col_lists]

    def pair_rows(ii, p):
        cmap = cmaps[ii]
        return [(cmap[int(c0)], cmap[int(c1)]) for c0, c1 in p
                if int(c0) in cmap and int(c1) in cmap]

    def joint_keep(ii, name):
        """Global indices of the joints of type `name` in island ii."""
        m = g2l[ii]
        a, b = joint_ab[name]
        return [ji for ji, (x, y) in enumerate(zip(a, b))
                if int(x) in m and int(y) in m
                and (isl_of[int(x)] == ii or isl_of[int(y)] == ii)]

    def pair_sig(ii):
        return tuple((g.type_a, g.type_b, g.phase, tuple(sorted(
            pair_rows(ii, p)))) for g, p in zip(scene.pair_groups,
                                                group_pairs))

    def joint_sig(ii):
        sig = []
        for name in JOINT_TYPES:
            if name not in joint_ab:
                sig.append(None)
                continue
            a, b = joint_ab[name]
            sig.append(tuple((g2l[ii][int(a[ji])], g2l[ii][int(b[ji])])
                             for ji in joint_keep(ii, name)))
        return tuple(sig)

    sig0p, sig0j = pair_sig(0), joint_sig(0)
    for ii in range(1, n_isl):
        if pair_sig(ii) != sig0p:
            raise NotIslandizable(f"island {ii} pair topology differs")
        if joint_sig(ii) != sig0j:
            raise NotIslandizable(f"island {ii} joint topology differs")

    bp_np = {f.name: _np(getattr(scene.body_params, f.name))
             for f in dataclasses.fields(BodyParams)}
    if strict_params:
        ref = col_lists[0]
        for ii in range(1, n_isl):
            for field in ("ctype", "a", "b", "r", "rot", "friction",
                          "restitution", "hull_id"):
                v = col[field]
                if not np.allclose(v[col_lists[ii]], v[ref]):
                    raise NotIslandizable(
                        f"island {ii} collider param '{field}' differs")
            for field in ("inv_mass", "inv_inertia", "local_cog",
                          "gravity_factor", "linear_damping",
                          "angular_damping"):
                v = bp_np[field]
                if not np.allclose(v[islands[ii]], v[islands[0]]):
                    raise NotIslandizable(
                        f"island {ii} body param '{field}' differs")

    # ---- the representative sub-scene, from island 0, on the scene's device
    def tens(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    cols0 = col_lists[0]
    m0 = g2l[0]
    init_map = islands[0] + [nb]
    bp = BodyParams(**{k: tens(v[init_map]) for k, v in bp_np.items()})
    sub_col = {k: v[cols0] for k, v in col.items()}
    sub_col["body"] = np.array([m0.get(int(b), nbl) for b in col_body[cols0]],
                               np.int32)
    cols = Colliders(**{k: tens(v) for k, v in sub_col.items()})

    groups = []
    for g, p in zip(scene.pair_groups, group_pairs):
        rows = pair_rows(0, p)
        if rows:
            groups.append(PairGroup(
                type_a=g.type_a, type_b=g.type_b,
                pairs=tens(np.asarray(rows, np.int32)),
                max_narrow=len(rows), phase=g.phase))

    from dxk_tpu_torch.scene.native import color_constraints
    sub_joints, keeps = {}, {}
    for name in JOINT_TYPES:
        keep = joint_keep(0, name) if name in joint_ab else []
        keeps[name] = keep
        if not keep:
            sub_joints[name] = None
            continue
        a, b = joint_ab[name]
        ba = np.array([m0[int(a[ji])] for ji in keep], np.int32)
        bb = np.array([m0[int(b[ji])] for ji in keep], np.int32)
        colors, ncol = color_constraints(ba, bb, nbl)
        kw = dict(body_a=tens(ba), body_b=tens(bb), color=tens(colors),
                  num_colors=int(max(ncol, 1)))
        for f in JOINT_PARAM_FIELDS:
            v = getattr(joints[name], f)
            if v is not None:
                kw[f] = tens(_np(v)[keep])
        sub_joints[name] = JointsOfType(**kw)

    def ctrl_map_for(name):
        """(I, Jl) global joint index per island-local joint."""
        if name not in joint_ab or not keeps[name]:
            return None
        return tens(np.asarray([joint_keep(ii, name) for ii in range(n_isl)],
                               np.int32))

    sub_controls = None
    c = scene.default_controls
    if c is not None:
        sub_controls = MotorControls(**{
            f: tens(_np(getattr(c, f))[keeps[name]])
            for name, fields in CTRL_FIELDS.items() for f in fields})

    sub = Scene(
        num_bodies=nbl,
        body_params=bp,
        colliders=cols,
        hulls=scene.hulls,
        pair_groups=tuple(groups),
        num_contact_phases=scene.num_contact_phases,
        broadphase_k=0,
        overlap_pairs=tens(np.zeros((0, 2), np.int32)),
        **sub_joints,
        default_controls=sub_controls,
        global_ff_force=scene.global_ff_force,
        ff_forces=scene.ff_forces,
        init_pos=tens(_np(scene.init_pos)[init_map]),
        init_rot=tens(_np(scene.init_rot)[init_map]))

    return IslandMap(sub_scene=sub,
                     body_map=tens(np.asarray(islands, np.int32)),
                     num_islands=n_isl,
                     hinge_ctrl_map=ctrl_map_for("hinge"),
                     ct_ctrl_map=ctrl_map_for("cone_twist"),
                     slider_ctrl_map=ctrl_map_for("slider"))
