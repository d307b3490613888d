"""Fused contact pipeline: narrowphase + contact prep + joint prep + the
whole iterated solve in one CUDA kernel, with nothing but body state,
world collider params and motor controls crossing device memory.

This module replaces the JAX package's
``ops/pallas/fused_step.py::_fused_step_batched`` / ``_fused_core`` (the
Pallas TPU kernel behind ``solver_mode="fused"``). It holds

  - the scene-static tables (`FusedTables`) both versions index directly —
    pair -> collider and body indices, per-row friction/restitution, joint
    wiring and static joint parameters, per-type inverse degrees, the
    per-body incidence lists the kernel sums deltas over, and one
    descriptor per joint type that the kernel walks in JOINT_ORDER;
  - `_fused_core`, the **plain PyTorch version**: the same pipeline on
    (B, rows) lanes, calling the plain recipes of cm_narrowphase,
    cm_joint_prep and batched_solver;
  - the wrapper around ``csrc/fused_step.cu`` (`make_fused_step_solver`):
    builds the shared library with nvcc at first use, checks its inputs,
    allocates the outputs and launches on the current stream.

The wrapper takes the plain version **only for tensors that lie on the
CPU**. For CUDA tensors it launches the kernel or raises.

What bounds the kernel on an H100: latency — one env reads about 0.6k
floats and writes about 0.8k, and runs a branch-heavy narrowphase and a
30-iteration loop of dependent joint and contact solves whose work fits
one warp. The design therefore packs several envs into a block, each on a
team of whole warps that synchronises only itself (`FusedTables.
launch_plan` picks envs per block and warps per env from the scene's
shared memory and the batch), keeps in shared memory what the solve
rewrites, puts the contact points and row deltas in a device-memory
scratch the wrapper allocates (`scratch_shapes`; hulls past the per-thread
polytope buffers get a hull scratch too, `hull_scratch_shape`), touches
live pair rows and manifold points only (dead ones contribute exactly
zero), and sums per-body deltas in a fixed order from incidence lists, so
results do not vary from run to run. Not done yet: no cp.async/TMA staging of the inputs,
the sequential chain on one lane per env; the library is compiled with
``-fmad=false`` so that the narrowphase takes the same side of every
tie-break as the plain version.

Solve semantics: the JAX package's averaged ("jacobi") mode, or with
``sequential=True`` its sequential (``fused_seq``) mode — per iteration
each joint in JOINT_ORDER, one at a time, then every pair row in phase
order with its points in order, both bodies' velocities stored after each
joint and each row (reference Gauss-Seidel, the JAX package's ``scan``
semantics); see batched_solver.py. Joint rows are prepared in the kernel
from the motor controls, or outside it (ops/solver.py's preps, packed by
batched_solver.pack_joint_type) and passed in. A scene with a heightfield
adds a prep-passed pseudo-group: its terrain contact rows (ops/heightmap.py,
prepared by ops/solver.py's prep_contacts) come in prepared, one row per
collider, and are solved with the kernel's own rows as the last phase slice.

Three builds of ``csrc/fused_step.cu``: "base" (averaged, joint prep in the
kernel, no sphere or cylinder recipes), "shapes" (the same with the sphere
and cylinder recipes) and "prepped" (every recipe, passed joint rows or
in-kernel prep, prep-passed contact rows or none, averaged or sequential
solve, all by run-time flags). The first two serve ``"fused"`` with
``joint_prep_in_kernel=True`` on scenes without a heightfield; the third
every other combination.

Ported: all 15 shape-pair recipes (sphere, capsule, cylinder, box and
hull against each other; the hull recipes over the distance GJK of
gjk_distance.py, cm_hull.py, and the polytope SAT of cm_polytope.py), all
six joint types (distance, ball, fixed, hinge, cone-twist, slider), one
contact phase or several, both solve modes, heightfield terrain rows.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from dxk_tpu_torch.core.maths import sqrt
from dxk_tpu_torch.ops.kernels import build
from dxk_tpu_torch.ops.kernels import cm_hull as ch
from dxk_tpu_torch.ops.kernels import cm_narrowphase as cm
from dxk_tpu_torch.ops.kernels import cm_polytope as cp
from dxk_tpu_torch.ops.kernels.batched_solver import (
    JOINT_ORDER, JOINT_SPECS, TYPE_MAX_POINTS, _contact_point,
    _solve_joint_type, _solve_joint_type_seq, _sub, phase_partition,
    scene_joint_ab, static_joint_invdeg)
from dxk_tpu_torch.ops.kernels.cm_joint_prep import (CTL_FIELDS, ROW_BUILDERS,
                                                     STATIC_FIELDS,
                                                     STATIC_WIDTH,
                                                     static_table)

# shape-type pairs with a recipe in both the plain version and the kernel,
# and the recipe id the kernel switches on
CM_RECIPES = {(1, 1): 0, (1, 3): 1, (3, 3): 2, (1, 4): 3, (3, 4): 4,
              (4, 4): 5, (0, 0): 6, (0, 1): 7, (0, 2): 8, (0, 3): 9,
              (0, 4): 10, (1, 2): 11, (2, 2): 12, (2, 3): 13, (2, 4): 14}
RECIPE_NAMES = {0: "capsule_capsule", 1: "capsule_box", 2: "box_box",
                3: "capsule_hull", 4: "box_hull", 5: "hull_hull",
                6: "sphere_sphere", 7: "sphere_capsule", 8: "sphere_cylinder",
                9: "sphere_box", 10: "sphere_hull", 11: "capsule_cylinder",
                12: "cylinder_cylinder", 13: "cylinder_box",
                14: "cylinder_hull", 15: "passed"}
# row kind of the prep-passed pseudo-group: contact points prepared outside
# the kernel (heightfield terrain), read from device memory, no narrowphase
PASSED_ROW = 15
HULL_RECIPES = {(0, 4), (1, 4), (2, 4), (3, 4), (4, 4)}
# largest padded hull the kernel's polytope recipes hold per thread: world
# vertices of each side, and clip slots 2 * LM (csrc/fused_step.cu VCAP,
# SCAP); a scene with larger hulls gives them a device-memory hull scratch
# (hull_scratch_shape)
MAX_HULL_VERTS = 32
MAX_HULL_LOOP = 16

# floats one contact point keeps in the kernel's scratch: 8 vec3
# fields + eff_n, eff_t, bias, friction + the two accumulated impulses
POINT_FIELDS = 30
POINT_VEC_FIELDS = ("rel_a", "rel_b", "normal", "tangent", "n_to_wa",
                    "n_to_wb", "t_to_wa", "t_to_wb")
POINT_SCALAR_FIELDS = ("eff_mass_n", "eff_mass_t", "bias", "friction")
ROW_INTS = 8      # type, k, col_a, col_b, body_a, body_b, pt_base, pt_stride
# ints of one joint type's descriptor in the kernel's launch dims: joint
# count, offsets of its rows, accumulated impulses and controls in shared
# memory, index of its first joint in the joint wiring / static table,
# offsets of its incidence lists (itab) and inverse degrees (ftab), and the
# offset (itab) and count of the bodies its joints touch
DESC_INTS = 10


def fused2_eligible(scene) -> bool:
    """Fused-pipeline eligibility: static (uncapped) pair tables and no
    dynamic broadphase."""
    if scene.broadphase_k > 0:
        return False
    if not scene.pair_groups:
        return False
    for g in scene.pair_groups:
        if g.max_narrow != g.pairs.shape[0]:
            return False
    return True


def _group_static(scene):
    """Per-group static info, groups in ascending phase order: pair count,
    K, collider and body indices, type pair, friction/restitution
    constants (numpy). A scene with a heightfield gets a trailing
    prep-passed pseudo-group (`native` False): one row per collider, 4
    points, body A the collider's body, body B the dummy, in a phase of
    its own after every other (the JAX package's heightfield rows)."""
    body_of = scene.colliders.body.cpu().numpy()
    fric = scene.colliders.friction.cpu().numpy()
    rest = scene.colliders.restitution.cpu().numpy()
    hull_id = scene.colliders.hull_id.cpu().numpy().astype(np.int64)
    out = []
    for gi in sorted(range(len(scene.pair_groups)),
                     key=lambda i: scene.pair_groups[i].phase):
        g = scene.pair_groups[gi]
        pairs = g.pairs.cpu().numpy()
        ta, tb = int(g.type_a), int(g.type_b)
        key = (min(ta, tb), max(ta, tb))
        if key not in CM_RECIPES:
            raise NotImplementedError(
                f"contact recipe for shape pair {key} is not ported to the "
                "fused step yet")
        ca, cb2 = pairs[:, 0], pairs[:, 1]
        pf = np.clip(np.sqrt(fric[ca] * fric[cb2]), 0.0, 1.0)
        pr = np.clip(np.maximum(rest[ca], rest[cb2]), 0.0, 1.0)
        out.append(dict(
            hull_a=hull_id[ca], hull_b=hull_id[cb2], native=True,
            pg=pairs.shape[0], k=TYPE_MAX_POINTS[key], ta=ta, tb=tb, key=key,
            col_a=ca.astype(np.int64), col_b=cb2.astype(np.int64),
            body_a=body_of[ca].astype(np.int64),
            body_b=body_of[cb2].astype(np.int64),
            fric=pf.astype(np.float32), rest=pr.astype(np.float32),
            phase=int(g.phase)))
    if scene.heightfield is not None:
        C = body_of.shape[0]
        cols = np.arange(C, dtype=np.int64)
        out.append(dict(
            hull_a=None, hull_b=None, native=False, pg=C, k=4, ta=-1, tb=-1,
            key=None, col_a=cols, col_b=cols,
            body_a=body_of.astype(np.int64),
            body_b=np.full(C, scene.num_bodies, np.int64),
            fric=np.zeros(C, np.float32), rest=np.zeros(C, np.float32),
            phase=max((m["phase"] for m in out), default=0) + 1))
    return out


def _csr(num_bodies, entries):
    """entries: list of (body, value) in summation order -> (ptr, idx)."""
    buckets = [[] for _ in range(num_bodies)]
    for body, val in entries:
        buckets[body].append(val)
    ptr = np.zeros(num_bodies + 1, np.int32)
    ptr[1:] = np.cumsum([len(b) for b in buckets])
    idx = np.array([v for b in buckets for v in b], np.int32)
    return ptr, idx


@dataclass
class _JointType:
    name: str
    idx_a: torch.Tensor        # (J,) int64
    idx_b: torch.Tensor        # (J,) int64
    js: dict                   # static params, see cm_joint_prep
    ctl_cols: dict             # field -> (J,) int64 columns of the ctl pack
    inv_deg: torch.Tensor      # (NB,)
    ab: list                   # [(a, b), ...] as Python ints


@dataclass
class _Group:
    meta: dict
    col_a: torch.Tensor
    col_b: torch.Tensor
    body_a: torch.Tensor
    body_b: torch.Tensor
    fric: torch.Tensor
    rest: torch.Tensor
    hull_a: dict = None       # per-row hull-local tables of side a / b
    hull_b: dict = None

    @property
    def ab(self):
        """[(body_a, body_b), ...] of the rows, as Python ints."""
        return list(zip(self.meta["body_a"].tolist(),
                        self.meta["body_b"].tolist()))


def _hull_rows(h, hid):
    """The hull-local tables of each row's hull, (Pg, ...) tensors."""
    return dict(verts=h.vertices[hid], fn=h.face_normals[hid],
                fo=h.face_offsets[hid], fm=h.face_mask[hid],
                pn=h.poly_normals[hid], pm=h.poly_mask[hid],
                loops=h.loop_pts[hid], llen=h.loop_len[hid],
                ed=h.edge_dirs[hid], em=h.edge_mask[hid])


class FusedTables:
    """Scene-static index and parameter tables of the fused step, on one
    device. Built once per (scene, device)."""

    def __init__(self, scene, device):
        self.device = torch.device(device)
        self.num_bodies = scene.num_bodies + 1          # incl. dummy
        self.num_colliders = int(scene.colliders.ctype.shape[0])
        metas = _group_static(scene)
        self.metas = metas
        joints = scene_joint_ab(scene)
        dev = self.device
        nb = self.num_bodies

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        hulls = scene.hulls.to(dev) if scene.hulls is not None else None
        self.groups: List[_Group] = []
        for m in metas:
            g = _Group(m, t(m["col_a"]), t(m["col_b"]), t(m["body_a"]),
                       t(m["body_b"]), t(m["fric"]), t(m["rest"]))
            if m["key"] in HULL_RECIPES:
                g.hull_b = _hull_rows(hulls, t(m["hull_b"]))
                if m["key"] == (4, 4):
                    g.hull_a = _hull_rows(hulls, t(m["hull_a"]))
            self.groups.append(g)
        self.phase_groups = phase_partition([m["phase"] for m in metas])
        # rows of a sphere or cylinder recipe (ids from 6 on): only the
        # library built with those recipes launches for them
        self.has_shapes = any(m["native"] and CM_RECIPES[m["key"]] >= 6
                              for m in metas)
        self.num_rows = sum(m["pg"] for m in metas)
        # contact points prepared outside the kernel (the heightfield
        # pseudo-group, last): only the prepped library takes them
        self.passed_points = sum(m["pg"] * m["k"] for m in metas
                                 if not m["native"])
        self.col_r = scene.colliders.r.to(dev).float().contiguous()

        # ---- joints ---------------------------------------------------
        idg = static_joint_invdeg(scene, nb)
        self.joint_types: List[_JointType] = []
        self.joint_counts = {name: 0 for name in JOINT_ORDER}
        self.ctl_rows = 0
        stat_tabs, ab_all = {}, {}
        for name, ab in joints:
            fields = CTL_FIELDS[name]
            J = len(ab)
            self.joint_counts[name] = J
            base = self.ctl_rows
            cols = {f: t(base + np.arange(J) * len(fields) + i)
                    for i, f in enumerate(fields)}
            self.ctl_rows += J * len(fields)
            tab = static_table(scene, name)
            stat_tabs[name], ab_all[name] = tab, np.asarray(ab, np.int64)
            js, c = {}, 0
            tt = t(tab)
            for f, n in STATIC_FIELDS:
                js[f] = (tt[:, c] if n == 1
                         else tuple(tt[:, c + i] for i in range(n)))
                c += n
            self.joint_types.append(_JointType(
                name, t(ab_all[name][:, 0]), t(ab_all[name][:, 1]), js, cols,
                t(idg[JOINT_ORDER.index(name)]), [tuple(x) for x in ab]))

        # ---- packed tables for the CUDA kernel --------------------------
        rows_i, rows_f, pt_base = [], [], 0
        phase_rows, con_entries = [0], []
        row0 = 0
        for pi, glist in enumerate(self.phase_groups):
            entries = []
            for g in glist:
                m = metas[g]
                for p in range(m["pg"]):
                    r = row0 + p
                    rows_i.append([CM_RECIPES[m["key"]] if m["native"]
                                   else PASSED_ROW, m["k"],
                                   m["col_a"][p], m["col_b"][p],
                                   m["body_a"][p], m["body_b"][p],
                                   pt_base + p, m["pg"]])
                    rows_f.append([m["fric"][p], m["rest"][p]])
                # summation order of the plain version: a group's a-sides
                # in row order, then its b-sides
                entries += [(int(m["body_a"][p]), 2 * (row0 + p))
                            for p in range(m["pg"])]
                entries += [(int(m["body_b"][p]), 2 * (row0 + p) + 1)
                            for p in range(m["pg"])]
                row0 += m["pg"]
                pt_base += m["pg"] * m["k"]
            phase_rows.append(row0)
            con_entries.append(_csr(nb, entries))
        self.num_points = pt_base
        self.num_phases = len(self.phase_groups)
        con_ptr, con_idx, off = [], [], 0
        for ptr, idx in con_entries:
            con_ptr.append(ptr[:-1] + off)
            con_idx.append(idx)
            off += len(idx)
        con_ptr.append(np.array([off], np.int32))

        # joints of all types in JOINT_ORDER (the order `joints` comes in):
        # one wiring table, one static table; per type its incidence lists,
        # inverse degrees and a descriptor (DESC_INTS) the kernel walks
        jab = np.concatenate(
            list(ab_all.values())
            or [np.zeros((0, 2), np.int64)]).astype(np.int32)
        jstat = np.concatenate(
            list(stat_tabs.values())
            or [np.zeros((0, STATIC_WIDTH), np.float32)])
        itabs = [np.asarray(rows_i, np.int32).reshape(-1),
                 np.asarray(phase_rows, np.int32),
                 np.concatenate(con_ptr).astype(np.int32),
                 np.concatenate(con_idx).astype(np.int32),
                 jab.reshape(-1)]
        ftabs = [self.col_r.cpu().numpy(),
                 np.asarray(rows_f, np.float32).reshape(-1),
                 jstat.astype(np.float32).reshape(-1)]
        ilen = sum(len(x) for x in itabs)
        flen = sum(len(x) for x in ftabs)
        desc = []
        row_off = acc_off = ctl_off = jbase = 0
        for ti, name in enumerate(JOINT_ORDER):
            J = self.joint_counts[name]
            ptr_off = idx_off = idg_off = tb_off = tb_n = 0
            if J:
                ent = []
                for j, (a, b) in enumerate(ab_all[name]):
                    ent.append((int(a), 2 * j))
                    ent.append((int(b), 2 * j + 1))
                ptr, idx = _csr(nb, ent)
                # the bodies with an incidence list: the only ones whose
                # velocities a pass of this type changes
                touched = np.nonzero(np.diff(ptr))[0].astype(np.int32)
                ptr_off, idx_off = ilen, ilen + len(ptr)
                tb_off, tb_n = idx_off + len(idx), len(touched)
                itabs += [ptr, idx, touched]
                ilen += len(ptr) + len(idx) + tb_n
                idg_off = flen
                ftabs.append(idg[ti])
                flen += nb
            desc += [J, row_off, acc_off, ctl_off, jbase, ptr_off, idx_off,
                     idg_off, tb_off, tb_n]
            row_off += J * JOINT_SPECS[name][0]
            acc_off += J * JOINT_SPECS[name][3]
            ctl_off += J * len(CTL_FIELDS[name])
            jbase += J
        self.joint_desc = desc
        self.joint_row_floats = row_off
        self.joint_acc_floats = acc_off
        self.ioffs = np.cumsum([0] + [len(x) for x in itabs[:5]])[:-1].tolist()
        self.foffs = np.cumsum([0] + [len(x) for x in ftabs[:3]])[:-1].tolist()

        # ---- hulls: each hull geometry's local tables once, in one block
        # per hull (csrc/fused_step.cu, "hull block"), the collider ->
        # hull id map and the merged faces' loop lengths
        self.hull_dims = (0, 0, 0, 0, 0)                 # V, F, FU, LM, EU
        hull_offs = [0, 0, 0]
        if scene.hulls is not None:
            h = {k: getattr(scene.hulls, k).cpu().numpy() for k in (
                "vertices", "face_normals", "face_offsets", "face_mask",
                "poly_normals", "poly_mask", "loop_pts", "loop_len",
                "edge_dirs", "edge_mask")}
            H, V = h["vertices"].shape[:2]
            F, FU = h["face_normals"].shape[1], h["poly_normals"].shape[1]
            LM, EU = h["loop_pts"].shape[2], h["edge_dirs"].shape[1]
            self.hull_dims = (V, F, FU, LM, EU)
            planes = np.concatenate(
                [h["face_normals"], h["face_offsets"][..., None],
                 h["face_mask"][..., None]], axis=2)
            block = np.concatenate([
                x.reshape(H, -1).astype(np.float32) for x in (
                    h["vertices"], planes, h["poly_normals"], h["poly_mask"],
                    h["loop_pts"], h["edge_dirs"], h["edge_mask"])], axis=1)
            hull_offs = [ilen, ilen + self.num_colliders, flen]
            itabs += [scene.colliders.hull_id.cpu().numpy(),
                      h["loop_len"].reshape(-1)]
            ftabs.append(block.reshape(-1))
        self.hull_offs = hull_offs
        self.itab = t(np.concatenate(itabs).astype(np.int32))
        self.ftab = t(np.concatenate(ftabs).astype(np.float32))

    # -- launch geometry -------------------------------------------------

    def dims(self, batch, num_iterations):
        """The int launch parameters of the kernel, in the order
        dxk_fused_step_launch reads them."""
        return ([batch, self.num_bodies, self.num_colliders, self.num_rows,
                 self.num_phases, self.ctl_rows + 1, self.num_points,
                 int(num_iterations)] + self.ioffs + self.foffs
                + self.joint_desc + self.hull_offs + list(self.hull_dims)
                + [int(self.has_shapes)])

    def shared_layout(self):
        """(block words, env words) of the kernel's shared memory, in
        4-byte words, each part 16-byte aligned: the block's one copy of
        the inverse masses, and per env (csrc/fused_step.cu, env_layout,
        same order) velocities, inverse inertias, joint rows, accumulated
        joint impulses, one joint pass's deltas, contact inverse degrees per
        phase, and the live lists (u16: per phase and body the live
        incidence entries' offsets, per phase the live rows' offsets, the
        live rows, the live entries; u8: each row's live points)."""
        def w16(n):
            return (n + 3) & ~3
        nb, P, nph = self.num_bodies, self.num_rows, self.num_phases
        parts = [6 * nb, 9 * nb, self.joint_row_floats, self.joint_acc_floats,
                 12 * max(max(self.joint_counts.values()), 1), nph * nb,
                 (nph * (nb + 1) + 1) // 2, (nph + 2) // 2, (P + 1) // 2, P,
                 (P + 3) // 4]
        return w16(nb), sum(w16(n) for n in parts)

    def launch_plan(self, batch) -> "LaunchPlan":
        """Envs per block (E) and warps per env (W) of the kernel's launch
        for `batch` envs, on an H100 (SMS SMs of SM_WARPS warps at the
        kernel's 128 registers a thread and SM_SHARED bytes of shared
        memory):

          - W: as many warps as leave no warp slot of the card idle at this
            batch (SMS * SM_WARPS // batch, a power of two, 1 to 8), so a
            large batch runs one warp per env and a small one spreads each
            env over up to eight;
          - then the (E, W >= that) with E * W <= 8 warps a block whose
            blocks put the most envs on an SM, then the most warps, then
            the largest E.

        Raises NotImplementedError when one env's working set does not fit
        a block's shared memory."""
        block_w, env_w = self.shared_layout()
        block_b, env_b = 4 * block_w, 4 * env_w
        if block_b + env_b > BLOCK_SHARED:
            raise NotImplementedError(
                f"fused_step: one env needs {block_b + env_b} bytes of shared "
                f"memory, a block holds {BLOCK_SHARED}")
        if 2 * self.num_rows > 0xFFFF:
            raise NotImplementedError(
                f"fused_step: {self.num_rows} pair rows; the kernel's live "
                "lists index at most 32767")
        if batch < 1:
            raise ValueError("fused_step: empty batch")
        w_fill = 1
        while w_fill < 8 and 2 * w_fill * batch <= SMS * SM_WARPS:
            w_fill *= 2
        best = None
        for W in (1, 2, 4, 8):
            if W < w_fill:
                continue
            for E in range(1, 8 // W + 1):
                smem = block_b + E * env_b
                if smem > BLOCK_SHARED:
                    break
                per_sm = min(SM_WARPS // (E * W),
                             SM_SHARED // (smem + BLOCK_RESERVED), 32)
                key = (E * per_sm, E * W * per_sm, E)
                if best is None or key > best[0]:
                    best = (key, E, W)
        _key, E, W = best
        return LaunchPlan(envs=E, warps=W, threads=32 * E * W,
                          blocks=-(-batch // E),
                          smem_bytes=block_b + E * env_b,
                          env_bytes=env_b, block_bytes=block_b)


# the card the launch plan is made for: an H100's SMs, the warps an SM holds
# at the kernel's 128 registers a thread (65,536 / (128 * 32)), the shared
# memory an SM and a block can have, and what the SM reserves per block
SMS = 132
SM_WARPS = 16
SM_SHARED = 233472
BLOCK_SHARED = 232448
BLOCK_RESERVED = 1024


@dataclass(frozen=True)
class LaunchPlan:
    """FusedTables.launch_plan: envs per block, warps per env, threads and
    blocks of the grid, dynamic shared memory of a block and its parts."""
    envs: int
    warps: int
    threads: int
    blocks: int
    smem_bytes: int
    env_bytes: int
    block_bytes: int


# ===========================================================================
# the plain PyTorch version


def _lanes(x, n):
    """(B, rows, n) -> n-tuple of (B, rows) lanes."""
    return tuple(x[..., i] for i in range(n))


def _v3_rows(x):
    """(Pg, n, 3) static rows -> list of n v3 tuples of (Pg,) lanes."""
    return [tuple(x[:, i, c] for c in range(3)) for i in range(x.shape[1])]


def _hull_local(h):
    """A hull side's local lists for the recipes: vertices, triangle
    planes and their validity (the distance-GJK recipes), and the merged
    faces, loops, loop lengths and edge directions (the SAT recipes)."""
    planes = list(zip(_v3_rows(h["fn"]),
                      [h["fo"][:, f] for f in range(h["fo"].shape[1])]))
    pvalid = [h["fm"][:, f] for f in range(h["fm"].shape[1])]
    faces = list(zip(_v3_rows(h["pn"]),
                     [h["pm"][:, f] for f in range(h["pm"].shape[1])]))
    loops = [_v3_rows(h["loops"][:, f]) for f in range(h["loops"].shape[1])]
    llens = [h["llen"][:, f] for f in range(h["llen"].shape[1])]
    edges = list(zip(_v3_rows(h["ed"]),
                     [h["em"][:, e] for e in range(h["em"].shape[1])]))
    return _v3_rows(h["verts"]), planes, pvalid, faces, loops, llens, edges


def _hull_world(h, pos, quat, LM):
    """World-space polytope lists of a hull side, loops padded to LM by
    repeating their last point."""
    verts, _pl, _pv, faces, loops, llens, edges = _hull_local(h)
    loops = [tuple(lp) + (lp[-1],) * (LM - len(lp)) for lp in loops]
    return cp.hull_topology_world(pos, quat, verts, faces, loops, llens,
                                  edges)


def _narrow_native(group, pa, pb, stats=None):
    """Dispatch a contact recipe. pa/pb: (a3, b3, r, q4) per side, side a
    the lower shape type. Returns (pts[K] v3, dps[K], normal, mask[K]).
    `stats` (a dict or None) collects the branch data of the recipes that
    keep it (hull, cylinder-box and cylinder-cylinder)."""
    a3, b3a, ra, qa = pa
    a3b, b3b, rb, qb = pb
    key = group.meta["key"]
    if key[0] == 0 and key[1] < 4:                  # one-point sphere recipes
        if key == (0, 0):
            p, d, n, h = cm.sphere_sphere_cm(a3, ra, a3b, rb)
        elif key == (0, 1):
            p, d, n, h = cm.sphere_capsule_cm(a3, ra, a3b, b3b, rb)
        elif key == (0, 2):
            p, d, n, h = cm.sphere_cylinder_cm(a3, ra, a3b, b3b, rb)
        else:
            p, d, n, h = cm.sphere_box_cm(a3, ra, a3b, b3b, qb)
        return [p], [d], n, [h]
    if key == (1, 1):
        return cm.capsule_capsule_cm(a3, b3a, ra, a3b, b3b, rb)
    if key == (1, 2):
        return cm.capsule_cylinder_cm(a3, b3a, ra, a3b, b3b, rb)
    if key == (1, 3):
        return cm.capsule_box_cm(a3, b3a, ra, a3b, b3b, qb)
    if key == (2, 2):
        return cm.cylinder_cylinder_cm(a3, b3a, ra, a3b, b3b, rb, stats)
    if key == (2, 3):
        return cm.cylinder_box_cm(a3, b3a, ra, a3b, b3b, qb, stats)
    if key == (3, 3):
        return cm.box_box_cm(a3, b3a, qa, a3b, b3b, qb)
    if key in {(0, 4), (1, 4)}:
        # hull-local frame (hull = side b: position a3b, rotation qb)
        verts, planes, pvalid = _hull_local(group.hull_b)[:3]

        def to_local(p):
            return cm.quat_inv_rotate_cm(qb, cm._sub(p, a3b))
        if key == (0, 4):
            pt, dp, nrm, hit = ch.sphere_hull_core(
                to_local(a3), ra, verts, planes, pvalid, stats)
        else:
            pt, dp, nrm, hit = ch.capsule_hull_core(
                to_local(a3), to_local(b3a), ra, verts, planes, pvalid,
                stats)
        return ([cm._add(cm.quat_rotate_cm(qb, pt), a3b)], [dp],
                cm.quat_rotate_cm(qb, nrm), [hit])
    if key == (2, 4):
        hwb = _hull_world(group.hull_b, a3b, qb,
                          group.hull_b["loops"].shape[2])
        return cp.cylinder_hull_cm(a3, b3a, ra, hwb, stats)
    if key == (3, 4):
        LM = max(4, group.hull_b["loops"].shape[2])
        hwb = _hull_world(group.hull_b, a3b, qb, LM)
        return cp.box_hull_cm(a3, b3a, qa, hwb, LM, stats)
    if key == (4, 4):
        LM = group.hull_b["loops"].shape[2]
        return cp.hull_hull_cm(_hull_world(group.hull_a, a3, qa, LM),
                               _hull_world(group.hull_b, a3b, qb, LM), stats)
    raise NotImplementedError(f"no contact recipe for {key}")


def _prep_points(pts, dps, normal, masks, group, pos_cog, inv_inertia,
                 inv_mass, vw, inv_dt):
    """Contact prep on (B, Pg) lanes: per-point field tuples the contact
    solve consumes + the pair inverse masses. pos_cog (B, NB, 3),
    inv_inertia (B, NB, 3, 3), inv_mass (NB,), vw (B, NB, 6); inv_dt a
    0-dim float32 tensor."""
    B = vw.shape[0]
    ba, bb = group.body_a, group.body_b
    pa = _lanes(pos_cog[:, ba], 3)
    pb = _lanes(pos_cog[:, bb], 3)
    ua = _lanes(vw[:, ba], 6)
    ub = _lanes(vw[:, bb], 6)
    va, wa = ua[0:3], ua[3:6]
    vb, wb = ub[0:3], ub[3:6]
    ia = _lanes(inv_inertia[:, ba].reshape(B, -1, 9), 9)
    ib = _lanes(inv_inertia[:, bb].reshape(B, -1, 9), 9)
    inv_ma = inv_mass[ba]
    inv_mb = inv_mass[bb]
    fric_c, rest_c = group.fric, group.rest

    def matvec(m, v):
        return (m[0]*v[0] + m[1]*v[1] + m[2]*v[2],
                m[3]*v[0] + m[4]*v[1] + m[5]*v[2],
                m[6]*v[0] + m[7]*v[1] + m[8]*v[2])

    out = []
    for k in range(group.meta["k"]):
        point = pts[k]
        depth = dps[k]
        mask = masks[k].to(torch.float32)
        rel_a = cm._sub(point, pa)
        rel_b = cm._sub(point, pb)
        av = cm._add(va, cm._cross(wa, rel_a))
        bv = cm._add(vb, cm._cross(wb, rel_b))
        rel_v = cm._sub(bv, av)
        vn0 = cm._dot(normal, rel_v)
        t_raw = cm._sub(rel_v, cm._muls(normal, vn0))
        # normalize-or-zero: zero vector below epsilon
        tl = sqrt(torch.clamp(cm._sqlen(t_raw), min=0.0))
        ok = tl > 1e-6
        tangent = tuple(torch.where(ok, c / torch.clamp(tl, min=1e-30), 0.0)
                        for c in t_raw)

        cr_at = cm._cross(rel_a, tangent)
        cr_bt = cm._cross(rel_b, tangent)
        im_t = (inv_ma + inv_mb + cm._dot(cr_at, matvec(ia, cr_at))
                + cm._dot(cr_bt, matvec(ib, cr_bt)))
        eff_t = torch.where(im_t != 0.0,
                            1.0 / torch.where(im_t != 0.0, im_t, 1.0),
                            0.0) * mask

        cr_an = cm._cross(rel_a, normal)
        cr_bn = cm._cross(rel_b, normal)
        im_n = (inv_ma + inv_mb + cm._dot(cr_an, matvec(ia, cr_an))
                + cm._dot(cr_bn, matvec(ib, cr_bn)))
        eff_n = torch.where(im_n != 0.0,
                            1.0 / torch.where(im_n != 0.0, im_n, 1.0),
                            0.0) * mask

        slop = -0.001
        # inv_dt >= 1e5 (dt <= 1e-5): zero the whole bias
        active = (-depth < slop) & (vn0 < 0.0) & (inv_dt < 1e5)
        bias = torch.where(active,
                           -rest_c * vn0 - 0.1 * (-depth - slop) * inv_dt,
                           0.0)

        cv = (rel_a, rel_b, normal, tangent,
              matvec(ia, cr_an), matvec(ib, cr_bn),
              matvec(ia, cr_at), matvec(ib, cr_bt))
        cs = (eff_n, eff_t, bias, fric_c * mask)
        out.append((cv, cs))
    return out, inv_ma, inv_mb


def _joint_rows(tab, jt, rot, pos_cog, inv_inertia, inv_mass, ctl, inv_dt):
    """Packed prep rows of one joint type, each lane (B, J)."""
    B = rot.shape[0]
    a, b = jt.idx_a, jt.idx_b
    bd = dict(
        qa=_lanes(rot[:, a], 4), qb=_lanes(rot[:, b], 4),
        pa=_lanes(pos_cog[:, a], 3), pb=_lanes(pos_cog[:, b], 3),
        ia=_lanes(inv_inertia[:, a].reshape(B, -1, 9), 9),
        ib=_lanes(inv_inertia[:, b].reshape(B, -1, 9), 9),
        inv_ma=inv_mass[a], inv_mb=inv_mass[b])
    ctl_d = {f: ctl[:, cols] for f, cols in jt.ctl_cols.items()}
    dtl = ctl[:, -1:]                                   # (B, 1) dt lane
    rows = ROW_BUILDERS[jt.name](jt.js, ctl_d, bd, dtl, inv_dt)
    shape = (B, a.shape[0])
    return [r.expand(shape) for r in rows]


def _side(tab, cols, col_a, col_b, col_rot):
    """One side's recipe params (a3, b3, r, q4) of a group's rows."""
    return (_lanes(col_a[:, cols], 3), _lanes(col_b[:, cols], 3),
            tab.col_r[cols], _lanes(col_rot[:, cols], 4))


# recipes whose plain version reports which branch each row took
BRANCH_RECIPES = HULL_RECIPES | {(2, 2), (2, 3)}


def recipe_branches(tab: FusedTables, col_a, col_b, col_rot):
    """Which branch the branching recipes take on these world collider
    params, from the plain version, per recipe name: rows by branch and the
    loop iterations the kernel runs.

      - capsule-hull: live rows whose segment stays outside the hull
        ("separated", the distance GJK's shallow case) or reaches into it
        ("overlap"); sphere-hull: the same as "outside" and "inside";
        "gjk_iterations" of all rows;
      - box-hull / hull-hull: live rows by SAT winner "face_a", "face_b",
        "edge";
      - cylinder-hull: all rows by the distance-GJK gate's verdict,
        "gate_separated" and "gate_overlap", and "sat_overruled", the rows
        the gate drops although no candidate axis separates them;
        "gjk_iterations" of all rows;
      - cylinder-box / cylinder-cylinder: live rows by manifold "ring" (4-point
        cap ring), "tube" (2-point lying tube), "single"; "projection_rounds"
        of all rows (the alternating projection, up to its fixed point)."""
    out = {}
    for grp in tab.groups:
        key = grp.meta["key"]
        if key not in BRANCH_RECIPES:
            continue
        stats = {}
        _pts, _dps, _n, masks = _narrow_native(
            grp, _side(tab, grp.col_a, col_a, col_b, col_rot),
            _side(tab, grp.col_b, col_a, col_b, col_rot), stats)
        live = masks[0].expand(col_a.shape[0], grp.meta["pg"])
        name = RECIPE_NAMES[CM_RECIPES[key]]
        acc = out.setdefault(name, {})
        loops = "gjk_iterations"
        if key in {(0, 4), (1, 4)}:
            ov = stats["overlap"]
            names = (("outside", "inside") if key == (0, 4)
                     else ("separated", "overlap"))
            cnt = {names[0]: live & ~ov, names[1]: live & ov}
        elif key == (2, 4):
            sat, gate = stats["sat"], stats["gate"]
            cnt = {"gate_separated": ~gate, "gate_overlap": gate,
                   "sat_overruled": sat & ~gate}
        elif key in {(2, 2), (2, 3)}:
            br = stats["branch"]
            cnt = {"ring": live & (br == 0), "tube": live & (br == 1),
                   "single": live & (br == 2)}
            loops = "projection_rounds"
        else:
            w = stats["which"]
            cnt = {"face_a": live & (w == 0), "face_b": live & (w == 1),
                   "edge": live & (w == 2)}
            loops = None
        if loops is not None:
            acc[loops] = acc.get(loops, 0) + int(stats["iterations"].sum())
        for k, m in cnt.items():
            acc[k] = acc.get(k, 0) + int(m.sum())
    return out


def joint_table_rows(tab: FusedTables, tables):
    """Packed joint tables (batched_solver.pack_joint_type: one (B, J * ROWS)
    joint-major table per joint type of the scene, in scene_joint_ab order)
    -> per type the list of ROWS (B, J) lanes the solves read."""
    if len(tables) != len(tab.joint_types):
        raise ValueError(f"fused_step: {len(tables)} joint tables for "
                         f"{len(tab.joint_types)} joint types")
    out = []
    for jt, t in zip(tab.joint_types, tables):
        J, R = len(jt.ab), JOINT_SPECS[jt.name][0]
        if t.dim() != 2 or t.shape[1] != J * R:
            raise ValueError(f"fused_step: {jt.name} table of shape "
                             f"{tuple(t.shape)}, expected (B, {J * R})")
        t3 = t.view(t.shape[0], J, R)
        out.append([t3[..., r] for r in range(R)])
    return out


def passed_rows(tab: FusedTables, prep):
    """The prep-passed pseudo-group's ContactPrep (B, C, 4, ...: the
    heightfield rows of ops/solver.py's prep_contacts) as the kernel's
    point layout: (B, 28, 4, C), field-major
    (rel_a, rel_b, normal, tangent, n_to_wa, n_to_wb, t_to_wa, t_to_wb as
    three components each, then eff_mass_n, eff_mass_t, bias, friction),
    point k of row p at [k, p]."""
    C = tab.passed_points // 4
    if prep is None or tuple(prep.eff_mass_n.shape[1:]) != (C, 4):
        raise ValueError(
            f"fused_step: the scene has {C} prep-passed contact rows, got "
            f"{None if prep is None else tuple(prep.eff_mass_n.shape)}")
    vec = [getattr(prep, f).permute(0, 3, 2, 1) for f in POINT_VEC_FIELDS]
    sca = [getattr(prep, f).transpose(1, 2)[:, None]
           for f in POINT_SCALAR_FIELDS]
    return torch.cat(vec + sca, dim=1).contiguous()


def _passed_fields(rows, prep):
    """Per-point (cv, cs) lane tuples of passed_rows' layout, the rows'
    inverse masses (from the prep, as the JAX package reads them) and the
    live bits: point k is live where its eff_mass_n > 0."""
    fields = []
    for k in range(rows.shape[2]):
        x = rows[:, :, k]                                  # (B, 28, C)
        cv = tuple(tuple(x[:, 3 * i + c] for c in range(3))
                   for i in range(len(POINT_VEC_FIELDS)))
        cs = tuple(x[:, 24 + i] for i in range(len(POINT_SCALAR_FIELDS)))
        fields.append((cv, cs))
    live = torch.zeros_like(rows[:, 0, 0], dtype=torch.uint8)
    for k, (_cv, cs) in enumerate(fields):
        live = live | ((cs[0] > 0.0).to(torch.uint8) << k)
    return fields, prep.inv_ma, prep.inv_mb, live


def _fused_core(tab: FusedTables, num_iterations, omega, inv_dt,
                vw0, inv_mass, inv_inertia, pos_cog, rot, ctl,
                col_a, col_b, col_rot, joint_tables=None, sequential=False,
                passed=None):
    """The whole contact pipeline in plain PyTorch on (B, rows) lanes.

    vw0 (B, NB, 6); inv_mass (NB,); inv_inertia (B, NB, 3, 3);
    pos_cog (B, NB, 3); rot (B, NB, 4); ctl (B, R+1) controls pack with dt
    in the last column, from which the joint rows are prepared, or None
    when `joint_tables` (joint_table_rows' input) brings them prepared;
    col_a/col_b (B, C, 3), col_rot (B, C, 4) world collider params; inv_dt
    a 0-dim float32 tensor. `sequential` selects the sequential solve.
    `passed`: the ContactPrep of the prep-passed pseudo-group (the scene's
    heightfield rows), or None when the scene has none.

    Returns (vw (B, NB, 6), imp_n (B, P, 4), live (B, P) uint8) with the
    pair rows P in ascending phase order; bit k of `live` says that
    manifold point k of the row is live."""
    B, nb = vw0.shape[0], vw0.shape[1]
    inv_dt = torch.as_tensor(inv_dt, dtype=torch.float32, device=vw0.device)
    if passed is not None and not tab.passed_points:
        raise ValueError("fused_step: prep-passed contact rows given for a "
                         "scene without a heightfield")

    # ---- joint rows: prepared here, or passed in ------------------------
    if joint_tables is None:
        joint_ts = [_joint_rows(tab, jt, rot, pos_cog, inv_inertia, inv_mass,
                                ctl, inv_dt) for jt in tab.joint_types]
    else:
        joint_ts = joint_table_rows(tab, joint_tables)

    # ---- narrowphase + prep per group; prep-passed rows as given ---------
    group_fields, group_live = [], []
    for grp in tab.groups:
        if not grp.meta["native"]:
            fields, inv_ma, inv_mb, live = _passed_fields(
                passed_rows(tab, passed), passed)
            group_fields.append((fields, inv_ma, inv_mb))
            group_live.append(live)
            continue
        pts, dps, normal, masks = _narrow_native(
            grp, _side(tab, grp.col_a, col_a, col_b, col_rot),
            _side(tab, grp.col_b, col_a, col_b, col_rot))
        shape = (B, grp.meta["pg"])
        masks = [m.expand(shape) for m in masks]
        fields, inv_ma, inv_mb = _prep_points(
            pts, dps, normal, masks, grp, pos_cog, inv_inertia, inv_mass,
            vw0, inv_dt)
        live = masks[0].to(torch.uint8)
        for k, m in enumerate(masks[1:], start=1):
            live = live | (m.to(torch.uint8) << k)
        group_fields.append((fields, inv_ma, inv_mb))
        group_live.append(live)

    if sequential:
        vw, imps = _sequential_solve(tab, num_iterations, vw0, inv_mass,
                                     inv_inertia, joint_ts, group_fields)
        return vw, imps, torch.cat(group_live, dim=1)

    # ---- contact inverse degrees from live pairs, per phase slice -------
    inv_deg_con = []
    for glist in tab.phase_groups:
        deg = torch.zeros((B, nb), dtype=torch.float32, device=vw0.device)
        for g in glist:
            lv = (group_live[g] != 0).to(torch.float32)
            deg.index_add_(1, tab.groups[g].body_a, lv)
            deg.index_add_(1, tab.groups[g].body_b, lv)
        inv_deg_con.append(1.0 / torch.clamp(deg, min=1.0))

    def zeros(n):
        return torch.zeros((B, n), dtype=torch.float32, device=vw0.device)

    con_imps = [([zeros(g.meta["pg"]) for _ in range(g.meta["k"])],
                 [zeros(g.meta["pg"]) for _ in range(g.meta["k"])])
                for g in tab.groups]
    joint_imps = [tuple(zeros(jt.idx_a.shape[0])
                        for _ in range(JOINT_SPECS[jt.name][3]))
                  for jt in tab.joint_types]

    vw = vw0
    for _it in range(num_iterations):
        # ---- joint passes in reference type order -----------------------
        for ji, jt in enumerate(tab.joint_types):
            vw, joint_imps[ji] = _solve_joint_type(
                jt.name, jt.idx_a, jt.idx_b, joint_ts[ji], vw, inv_mass,
                inv_inertia, jt.inv_deg, omega, joint_imps[ji])

        # ---- contact phase slices: every row reads the slice-start
        # velocities, solves its points in order, deltas are averaged ------
        for pi, glist in enumerate(tab.phase_groups):
            all_deltas = torch.zeros_like(vw)
            for g in glist:
                grp = tab.groups[g]
                fields, inv_ma, inv_mb = group_fields[g]
                ua = _lanes(vw[:, grp.body_a], 6)
                ub = _lanes(vw[:, grp.body_b], 6)
                va, wa, vb, wb = ua[0:3], ua[3:6], ub[0:3], ub[3:6]
                va0, wa0, vb0, wb0 = va, wa, vb, wb
                imp_n, imp_t = con_imps[g]
                nn, tt = [], []
                for k in range(grp.meta["k"]):
                    cv, cs = fields[k]
                    va, wa, vb, wb, ik_n, ik_t = _contact_point(
                        cv, cs, inv_ma, inv_mb, va, wa, vb, wb,
                        imp_n[k], imp_t[k])
                    nn.append(ik_n)
                    tt.append(ik_t)
                con_imps[g] = (nn, tt)
                da = torch.stack(list(_sub(va, va0)) + list(_sub(wa, wa0)),
                                 dim=-1)
                db = torch.stack(list(_sub(vb, vb0)) + list(_sub(wb, wb0)),
                                 dim=-1)
                all_deltas.index_add_(1, grp.body_a, da)
                all_deltas.index_add_(1, grp.body_b, db)
            vw = vw + all_deltas * (omega * inv_deg_con[pi])[..., None]

    imps = []
    for g, grp in enumerate(tab.groups):
        x = torch.stack(con_imps[g][0], dim=-1)             # (B, Pg, K)
        if grp.meta["k"] < 4:
            x = torch.nn.functional.pad(x, (0, 4 - grp.meta["k"]))
        imps.append(x)
    return vw, torch.cat(imps, dim=1), torch.cat(group_live, dim=1)


def _sequential_solve(tab, num_iterations, vw0, inv_mass, inv_inertia,
                      joint_ts, group_fields):
    """The sequential solve (the JAX package's ``_fused_core`` with
    sequential=True): per iteration each joint type in JOINT_ORDER, joints
    in order, then the groups in ascending phase order, rows in table
    order, every point k < K in order (dead ones included: their effective
    masses and friction are zero), both bodies' [v|w] rows stored after each
    joint and each row. Returns (vw, imp_n (B, P, 4))."""
    B = vw0.shape[0]
    vw = vw0.clone()
    zero = torch.zeros((B,), dtype=torch.float32, device=vw0.device)
    joint_fields = [[JOINT_SPECS[jt.name][1]([r[:, j] for r in rows])
                     for j in range(len(jt.ab))]
                    for jt, rows in zip(tab.joint_types, joint_ts)]
    joint_imps = [tuple([zero] * len(jt.ab)
                        for _ in range(JOINT_SPECS[jt.name][3]))
                  for jt in tab.joint_types]
    # per group, row and point: the point's fields as (B,) lanes
    rows = []
    for grp, (fields, inv_ma, inv_mb) in zip(tab.groups, group_fields):
        for p, (a, b) in enumerate(grp.ab):
            points = [(tuple(tuple(c[:, p] for c in v) for v in cv),
                       tuple(c[:, p] for c in cs)) for cv, cs in fields]
            rows.append((a, b, inv_ma[..., p], inv_mb[..., p], points))
    imp_n = [[zero] * len(pts) for *_x, pts in rows]
    imp_t = [[zero] * len(pts) for *_x, pts in rows]

    for _it in range(num_iterations):
        for ji, jt in enumerate(tab.joint_types):
            joint_imps[ji] = _solve_joint_type_seq(
                jt.name, jt.ab, joint_fields[ji], vw, inv_mass, inv_inertia,
                joint_imps[ji])
        for r, (a, b, inv_ma, inv_mb, points) in enumerate(rows):
            ua, ub = vw[:, a], vw[:, b]
            va = tuple(ua[:, c] for c in range(3))
            wa = tuple(ua[:, c] for c in range(3, 6))
            vb = tuple(ub[:, c] for c in range(3))
            wb = tuple(ub[:, c] for c in range(3, 6))
            for k, (cv, cs) in enumerate(points):
                va, wa, vb, wb, imp_n[r][k], imp_t[r][k] = _contact_point(
                    cv, cs, inv_ma, inv_mb, va, wa, vb, wb, imp_n[r][k],
                    imp_t[r][k])
            row_a = torch.stack(list(va) + list(wa), dim=-1)
            row_b = torch.stack(list(vb) + list(wb), dim=-1)
            vw[:, a] = row_a
            vw[:, b] = row_b

    imps = torch.zeros((B, len(rows), 4), dtype=torch.float32,
                       device=vw0.device)
    for r, row_imps in enumerate(imp_n):
        for k, x in enumerate(row_imps):
            imps[:, r, k] = x
    return vw, imps


# ===========================================================================
# the CUDA kernel: build, bind, launch

NVCC_FLAGS = build.BASE_FLAGS + ["-fmad=false"]
# the library with the sphere and cylinder recipes is a second build of the
# same source: in one module with the other recipes they made the ragdoll
# settle's kernel 4 % slower on an H100, though it never calls them
SHAPES_FLAGS = ["-DDXK_SHAPE_RECIPES=1"]
# the third build takes joint rows prepared outside the kernel and solves
# averaged or sequentially (a run-time flag); it holds every recipe, and its
# code is compiled into neither of the other two
PREPPED_FLAGS = SHAPES_FLAGS + ["-DDXK_PREPPED_JOINTS=1"]
LIBRARY_FLAGS = {"base": [], "shapes": SHAPES_FLAGS, "prepped": PREPPED_FLAGS}

_LIBS = {}
_LAUNCHES = {name: 0 for name in LIBRARY_FLAGS}
BUILD_LOGS = {}              # compiler output by library: "base", "shapes",
                             # "prepped"


def launch_count(library=None) -> int:
    """Kernel launches made by the wrapper since the last reset: of one
    library ("base", "shapes", "prepped"), or of all three."""
    if library is None:
        return sum(_LAUNCHES.values())
    return _LAUNCHES[library]


def reset_launch_count() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def load_library(verbose: bool = False, shapes: bool = False,
                 prepped: bool = False):
    """Compile csrc/fused_step.cu with nvcc into the build directory (once
    per source content and flags) and bind it with ctypes: the library
    without the sphere and cylinder recipes, with them (`shapes`), or the
    one that takes prepared joint rows and solves averaged or sequentially
    (`prepped`, every recipe). Raises if nvcc is missing or the build
    fails."""
    name = "prepped" if prepped else ("shapes" if shapes else "base")
    if name in _LIBS:
        return _LIBS[name]
    rows = tuple(JOINT_SPECS[n][0] for n in JOINT_ORDER)
    if (rows, STATIC_WIDTH, POINT_FIELDS, ROW_INTS, DESC_INTS,
            MAX_HULL_VERTS, MAX_HULL_LOOP) != (
            (17, 18, 30, 46, 59, 58), 31, 30, 8, 10, 32, 16):
        raise RuntimeError("row layouts changed: csrc/fused_step.cu hard-"
                           "codes the joint row widths, STATIC_WIDTH, "
                           "POINT_FIELDS, ROW_INTS, DESC_INTS, the per-thread "
                           "hull caps (VCAP, SCAP = 2 * MAX_HULL_LOOP) and "
                           "hull_lane_floats")
    lib, BUILD_LOGS[name] = build.compile_library(
        "fused_step.cu", NVCC_FLAGS + LIBRARY_FLAGS[name], verbose)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dxk_fused_step_prepped_launch if prepped \
        else lib.dxk_fused_step_launch
    fn.restype = i
    fn.argtypes = (
        [ctypes.POINTER(ctypes.c_int), fl, fl]      # dims, omega, inv_dt
        + [p] * 10                                  # per-env inputs
        + ([p, i, i, p, i] if prepped else [])      # jrows, sequential,
                                                    # rows passed, passed
                                                    # contact rows, points
        + [p, p]                                    # itab, ftab
        + [p, p, p]                                 # point, row-delta, hull
                                                    # scratch
        + [p] * 4                                   # outputs
        + [i, i, i, p])                             # envs per block, warps
                                                    # per env, smem, stream
    _LIBS[name] = lib
    return lib


def joint_rows_field_major(tab: FusedTables, tables, like):
    """The packed joint tables (joint-major, one per joint type of the
    scene) as the one (B, sum of J * ROWS) row of floats per env the
    prepped kernel stages into shared memory: per type in JOINT_ORDER,
    field-major (row r of joint j at r * J + j). `like` gives B and the
    device."""
    lanes = joint_table_rows(tab, tables)           # checks the shapes
    parts = [torch.stack(rows, dim=1).flatten(1) for rows in lanes]
    out = torch.cat(parts, dim=1).contiguous() if parts else torch.zeros(
        (like.shape[0], 0), dtype=torch.float32, device=like.device)
    if out.shape[1] != tab.joint_row_floats:
        raise ValueError(f"fused_step: {out.shape[1]} joint floats, the "
                         f"kernel's layout holds {tab.joint_row_floats}")
    return out


def scratch_shapes(tab: FusedTables, batch):
    """Shapes of the kernel's two float32 scratch tensors for `batch` envs:
    the contact points (B, num_points, POINT_FIELDS), a point's fields side
    by side (one lane reads and writes all of them, so a live point is 120
    contiguous bytes of cache), and the pair rows' velocity deltas
    (B, num_rows, 12)."""
    return ((batch, tab.num_points, POINT_FIELDS), (batch, tab.num_rows, 12))


def hull_lane_floats(tab: FusedTables) -> int:
    """Floats of one lane's slice of the hull scratch (csrc/fused_step.cu,
    hull_lane_floats): 0 for hulls within MAX_HULL_VERTS and MAX_HULL_LOOP,
    whose polytope buffers are held per thread; else both sides' world
    vertices (max(V, 8) each) and the clip's 2 S vertices and 2 S depths,
    S = 2 max(LM, 4)."""
    V, _F, _FU, LM, _EU = tab.hull_dims
    if V <= MAX_HULL_VERTS and LM <= MAX_HULL_LOOP:
        return 0
    return 6 * max(V, 8) + 16 * max(LM, 4)


def hull_scratch_shape(tab: FusedTables, batch, warps=None):
    """Shape of the kernel's hull scratch for `batch` envs launched with
    `warps` warps an env (default: the launch plan's), or None when the
    scene's hulls fit the per-thread buffers: (B, min(num_rows, 32 warps),
    hull_lane_floats), a slice for each lane of an env's team that takes
    pair rows (one row after another)."""
    floats = hull_lane_floats(tab)
    if floats == 0:
        return None
    if warps is None:
        warps = tab.launch_plan(batch).warps
    return (batch, min(tab.num_rows, 32 * warps), floats)


def _launch(tab: FusedTables, num_iterations, omega, inv_dt, v, w, inv_mass,
            inv_inertia, pos_cog, rot, ctl, col_a, col_b, col_rot,
            joint_tables=None, sequential=False, passed=None):
    """Check the inputs, allocate the outputs, launch the kernel on the
    current stream. No synchronisation. The base or shapes library serves
    the averaged solve with joint prep in the kernel (`ctl`); the prepped
    library the sequential solve, passed joint rows (`joint_tables`) and
    scenes with prep-passed contact rows (`passed`, a ContactPrep)."""
    prepped = sequential or joint_tables is not None or tab.passed_points > 0
    name = "prepped" if prepped else ("shapes" if tab.has_shapes else "base")
    lib = load_library(shapes=tab.has_shapes, prepped=prepped)
    B, nb, C = v.shape[0], tab.num_bodies, tab.num_colliders
    P, R1 = tab.num_rows, tab.ctl_rows + 1
    if B == 0:
        raise ValueError("fused_step: empty batch")
    build.check_cuda("fused_step", "v", v, (B, nb, 3))
    build.check_cuda("fused_step", "w", w, (B, nb, 3))
    build.check_cuda("fused_step", "inv_mass", inv_mass, (nb,))
    build.check_cuda("fused_step", "inv_inertia", inv_inertia, (B, nb, 3, 3))
    build.check_cuda("fused_step", "pos_cog", pos_cog, (B, nb, 3))
    build.check_cuda("fused_step", "rot", rot, (B, nb, 4))
    build.check_cuda("fused_step", "col_a", col_a, (B, C, 3))
    build.check_cuda("fused_step", "col_b", col_b, (B, C, 3))
    build.check_cuda("fused_step", "col_rot", col_rot, (B, C, 4))
    jrows = None
    if joint_tables is None:
        build.check_cuda("fused_step", "ctl", ctl, (B, R1))
    else:
        jrows = joint_rows_field_major(tab, joint_tables, v)
        build.check_cuda("fused_step", "joint rows", jrows,
                         (B, tab.joint_row_floats))
    crows = None
    if tab.passed_points:
        crows = passed_rows(tab, passed)
        build.check_cuda("fused_step", "passed contact rows", crows,
                         (B, POINT_FIELDS - 2, 4, tab.passed_points // 4))
    elif passed is not None:
        raise ValueError("fused_step: prep-passed contact rows given for a "
                         "scene without a heightfield")
    if v.device != tab.device:
        raise ValueError(f"fused_step: inputs on {v.device}, tables on "
                         f"{tab.device}")
    plan = tab.launch_plan(B)
    v_out = torch.empty_like(v)
    w_out = torch.empty_like(w)
    imp = torch.empty((B, P, 4), dtype=torch.float32, device=v.device)
    live = torch.empty((B, P), dtype=torch.uint8, device=v.device)
    # the kernel's scratch: each env's contact points and its pair rows'
    # velocity deltas; the kernel writes and reads live rows and points only
    pts, rdelta = scratch_shapes(tab, B)
    pts = torch.empty(pts, dtype=torch.float32, device=v.device)
    rdelta = torch.empty(rdelta, dtype=torch.float32, device=v.device)
    # the polytope recipes' buffers of hulls past the per-thread caps
    hull_shape = hull_scratch_shape(tab, B, plan.warps)
    hull = (torch.empty(hull_shape, dtype=torch.float32, device=v.device)
            if hull_shape is not None else None)
    dims = tab.dims(B, num_iterations)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    inputs = [v.data_ptr(), w.data_ptr(), inv_mass.data_ptr(),
              inv_inertia.data_ptr(), pos_cog.data_ptr(), rot.data_ptr(),
              ctl.data_ptr() if jrows is None else None, col_a.data_ptr(),
              col_b.data_ptr(), col_rot.data_ptr()]
    if prepped:
        launch = lib.dxk_fused_step_prepped_launch
        inputs += [jrows.data_ptr() if jrows is not None else None,
                   int(sequential), int(jrows is not None),
                   crows.data_ptr() if crows is not None else None,
                   tab.passed_points]
    else:
        launch = lib.dxk_fused_step_launch
    build.raise_on_error("fused_step", launch(
        dims_c, float(omega), float(inv_dt), *inputs, tab.itab.data_ptr(),
        tab.ftab.data_ptr(), pts.data_ptr(), rdelta.data_ptr(),
        hull.data_ptr() if hull is not None else None, v_out.data_ptr(),
        w_out.data_ptr(), imp.data_ptr(), live.data_ptr(), plan.envs,
        plan.warps, plan.smem_bytes, build.stream_of(v)))
    _LAUNCHES[name] += 1
    return v_out, w_out, imp, live


def fused_tables(scene, device) -> FusedTables:
    """The scene's FusedTables on `device`, built once and kept on the
    scene object."""
    cache = scene.__dict__.setdefault("_fused_tables", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = FusedTables(scene, device)
    return cache[key]


def make_fused_step_solver(scene, num_iterations, omega=1.0,
                           sequential=False, joint_prep_in_kernel=True):
    """Returns fn(bodies, world_colliders, joints, inv_dt, passed=None) ->
    (v (B, NB, 3), w (B, NB, 3), imp_n (B, P, 4), live (B, P) uint8 with
    bit k set when manifold point k of the pair row is live).

    bodies: integrator.SolverBodies; world_colliders: shapes.WorldColliders;
    joints: with `joint_prep_in_kernel`, the (B, R+1) controls pack
    (motor-control columns in cm_joint_prep.CTL_FIELDS order per joint, dt
    in the last column); without, the tuple of packed joint tables
    (batched_solver.pack_joint_type of ops/solver.py's preps, one per joint
    type of the scene in scene_joint_ab order); inv_dt: float; passed: for
    a scene with a heightfield, ops/solver.py's ContactPrep of its terrain
    rows (B, C, 4, ...), the trailing rows of the outputs.
    `sequential` selects the sequential solve (``solver_mode="fused_seq"``).

    CUDA tensors go through the kernel of csrc/fused_step.cu; CPU tensors
    through the plain version `_fused_core`. There is no other routing."""
    if not fused2_eligible(scene):
        raise NotImplementedError(
            "scene is not eligible for the fused step (capped pair tables "
            "or dynamic broadphase), and no other solver path is ported")

    def fused(bodies, wcol, joints, inv_dt, passed=None):
        dev = bodies.v.device
        tab = fused_tables(scene, dev)
        ctl, tables = (joints, None) if joint_prep_in_kernel \
            else (None, tuple(joints))
        if dev.type == "cpu":
            vw0 = torch.cat([bodies.v, bodies.w], dim=-1)
            vw, imp, live = _fused_core(
                tab, num_iterations, omega, inv_dt, vw0, bodies.inv_mass,
                bodies.inv_inertia, bodies.pos_cog, bodies.rot, ctl,
                wcol.a, wcol.b, wcol.rot, joint_tables=tables,
                sequential=sequential, passed=passed)
            return vw[..., :3], vw[..., 3:], imp, live
        return _launch(tab, num_iterations, omega, inv_dt, bodies.v,
                       bodies.w, bodies.inv_mass, bodies.inv_inertia,
                       bodies.pos_cog, bodies.rot, ctl, wcol.a, wcol.b,
                       wcol.rot, joint_tables=tables, sequential=sequential,
                       passed=passed)

    return fused
