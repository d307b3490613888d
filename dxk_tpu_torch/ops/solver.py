"""Contact prep and the iterated contact solve of the reference (non-fused)
step, batched over environments: the port's counterpart of the contact half
of the JAX package's ops/solver.py.

Layout is pair-major, as there: a narrowphase pair is one solver row with
its <= 4 contact points, solved in order against the pair's gathered body
velocities. Rows are grouped in static contact-phase slices; one solver
iteration runs the slices in order (Gauss-Seidel across slices), all rows of
a slice in parallel against the same velocities, with per-body deltas summed
by `index_add_` and scaled by 1/degree within the slice (averaged Jacobi).
Scenes built with contact phases hash pairs so that a slice rarely shares a
dynamic body, which makes the pass Gauss-Seidel.

Ported so far: contacts in modes "jacobi" and "colored" (the same pass for
contacts). The sequential "scan" pass and the joint types raise
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from dxk_tpu_torch.core.maths import cross, dot, noz
from dxk_tpu_torch.ops.integrator import SolverBodies

DT_THRESHOLD = 1e-5


def _inv_or_zero(x):
    return torch.where(x != 0.0, 1.0 / torch.where(x != 0.0, x, 1.0), 0.0)


def _mat_vec(m, v):
    return torch.sum(m * v[..., None, :], dim=-1)


def _rows(table, idx):
    """table (B, N, ...), idx (B, P) -> (B, P, ...)."""
    ar = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[ar, idx]


@dataclass
class ContactPrep:
    """Per-pair manifold prep: B envs x P pairs x up to 4 points.
    `phase_sizes` are static, contiguous slice sizes over the pair axis."""

    body_a: torch.Tensor        # (B, P) int64
    body_b: torch.Tensor        # (B, P)
    inv_ma: torch.Tensor        # (B, P)
    inv_mb: torch.Tensor        # (B, P)
    rel_a: torch.Tensor         # (B, P, 4, 3)
    rel_b: torch.Tensor         # (B, P, 4, 3)
    normal: torch.Tensor        # (B, P, 4, 3)
    tangent: torch.Tensor       # (B, P, 4, 3)
    eff_mass_n: torch.Tensor    # (B, P, 4)
    eff_mass_t: torch.Tensor    # (B, P, 4)
    bias: torch.Tensor          # (B, P, 4)
    friction: torch.Tensor      # (B, P, 4)
    n_to_wa: torch.Tensor       # (B, P, 4, 3)
    n_to_wb: torch.Tensor
    t_to_wa: torch.Tensor
    t_to_wb: torch.Tensor
    phase_sizes: tuple = ()

    def slice(self, start, size):
        return ContactPrep(**{
            f.name: (getattr(self, f.name)[:, start:start + size]
                     if f.name != "phase_sizes" else ())
            for f in fields(self)})


def prep_contacts(bodies: SolverBodies, body_a, body_b, point, normal, depth,
                  friction, restitution, mask, dt,
                  phase_sizes=()) -> ContactPrep:
    """body_a/body_b/friction/restitution: (B, P); point/normal:
    (B, P, 4, 3); depth/mask: (B, P, 4). Masked points get zero effective
    mass (zero impulses); fully dead pairs should already point at the dummy
    body so they do not inflate per-body degrees."""
    inv_dt = float(np.float32(1.0) / np.float32(dt))
    pa = _rows(bodies.pos_cog, body_a)
    pb = _rows(bodies.pos_cog, body_b)
    rel_a = point - pa[:, :, None, :]
    rel_b = point - pb[:, :, None, :]

    bva = _rows(bodies.v, body_a)[:, :, None, :]
    bwa = _rows(bodies.w, body_a)[:, :, None, :]
    bvb = _rows(bodies.v, body_b)[:, :, None, :]
    bwb = _rows(bodies.w, body_b)[:, :, None, :]
    va = bva + cross(bwa, rel_a)
    vb = bvb + cross(bwb, rel_b)
    rel_v = vb - va
    tangent = noz(rel_v - dot(normal, rel_v)[..., None] * normal)

    inv_ia = _rows(bodies.inv_inertia, body_a)[:, :, None]
    inv_ib = _rows(bodies.inv_inertia, body_b)[:, :, None]
    inv_ma = bodies.inv_mass[body_a]
    inv_mb = bodies.inv_mass[body_b]
    inv_m_sum = (inv_ma + inv_mb)[..., None]

    cr_at = cross(rel_a, tangent)
    cr_bt = cross(rel_b, tangent)
    im_t = (inv_m_sum + dot(cr_at, _mat_vec(inv_ia, cr_at))
            + dot(cr_bt, _mat_vec(inv_ib, cr_bt)))
    eff_t = _inv_or_zero(im_t) * mask

    cr_an = cross(rel_a, normal)
    cr_bn = cross(rel_b, normal)
    im_n = (inv_m_sum + dot(cr_an, _mat_vec(inv_ia, cr_an))
            + dot(cr_bn, _mat_vec(inv_ib, cr_bn)))
    eff_n = _inv_or_zero(im_n) * mask

    # restitution + Baumgarte bias with slop
    v_rel_n = dot(normal, rel_v)
    slop = -0.001
    active = (-depth < slop) & (v_rel_n < 0.0)
    bias = torch.where(active, -restitution[..., None] * v_rel_n
                       - 0.1 * (-depth - slop) * inv_dt, 0.0)
    if not float(dt) > DT_THRESHOLD:
        bias = torch.zeros_like(bias)

    return ContactPrep(
        body_a=body_a, body_b=body_b, inv_ma=inv_ma, inv_mb=inv_mb,
        rel_a=rel_a, rel_b=rel_b,
        normal=normal, tangent=tangent, eff_mass_n=eff_n, eff_mass_t=eff_t,
        bias=bias, friction=friction[..., None] * mask,
        n_to_wa=_mat_vec(inv_ia, cr_an), n_to_wb=_mat_vec(inv_ib, cr_bn),
        t_to_wa=_mat_vec(inv_ia, cr_at), t_to_wb=_mat_vec(inv_ib, cr_bt),
        phase_sizes=tuple(phase_sizes))


class _PointView:
    """Point-k view over pair-major ContactPrep fields."""

    __slots__ = ("rel_a", "rel_b", "normal", "tangent", "eff_mass_n",
                 "eff_mass_t", "bias", "friction", "n_to_wa", "n_to_wb",
                 "t_to_wa", "t_to_wb")

    def __init__(self, c, k):
        for f in self.__slots__:
            x = getattr(c, f)
            setattr(self, f, x[..., k, :] if x.dim() > c.bias.dim()
                    else x[..., k])


def _contact_solve_point(ck, inv_ma, inv_mb, va, wa, vb, wb, imp_n, imp_t):
    """One contact point: friction, then normal."""
    # tangent
    av = va + cross(wa, ck.rel_a)
    bv = vb + cross(wb, ck.rel_b)
    vt = dot(bv - av, ck.tangent)
    lam = -ck.eff_mass_t * vt
    max_f = ck.friction * imp_n
    new_imp = torch.clamp(imp_t + lam, -max_f, max_f)
    lam = new_imp - imp_t
    imp_t = new_imp
    P = lam[..., None] * ck.tangent
    va = va - inv_ma[..., None] * P
    wa = wa - ck.t_to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + ck.t_to_wb * lam[..., None]

    # normal
    av = va + cross(wa, ck.rel_a)
    bv = vb + cross(wb, ck.rel_b)
    vn = dot(bv - av, ck.normal)
    lam = -ck.eff_mass_n * (vn - ck.bias)
    new_imp = torch.clamp(imp_n + lam, min=0.0)
    lam = new_imp - imp_n
    imp_n = new_imp
    P = lam[..., None] * ck.normal
    va = va - inv_ma[..., None] * P
    wa = wa - ck.n_to_wa * lam[..., None]
    vb = vb + inv_mb[..., None] * P
    wb = wb + ck.n_to_wb * lam[..., None]
    return va, wa, vb, wb, imp_n, imp_t


def _contact_solve_one(points, inv_ma, inv_mb, va, wa, vb, wb, imp_n,
                       imp_t):
    """One pair: its <= 4 points (`_PointView`s) solved in order against the
    pair's gathered velocities. imp_n/imp_t: (..., 4)."""
    imp_n_out = []
    imp_t_out = []
    for k, ck in enumerate(points):
        va, wa, vb, wb, ik_n, ik_t = _contact_solve_point(
            ck, inv_ma, inv_mb, va, wa, vb, wb, imp_n[..., k], imp_t[..., k])
        imp_n_out.append(ik_n)
        imp_t_out.append(ik_t)
    return (va, wa, vb, wb, torch.stack(imp_n_out, -1),
            torch.stack(imp_t_out, -1))


def _phase_slices(prep):
    """Static (start, size) slices over the pair axis; a single full slice
    when the scene was built without contact phases."""
    sizes = prep.phase_sizes or (prep.body_a.shape[1],)
    starts, s = [], 0
    for sz in sizes:
        starts.append(s)
        s += sz
    return tuple(zip(starts, sizes))


def _flat_index(idx, num_rows):
    """(B, P) row indices -> indices into the (B * num_rows) flattened
    body axis."""
    off = torch.arange(idx.shape[0], device=idx.device)[:, None] * num_rows
    return (idx + off).reshape(-1)


def contact_phase_inv_degrees(prep: ContactPrep, num_rows: int):
    """1/degree per body per phase slice, (B, num_rows) each, where degree
    counts the pairs of that slice touching the body. Constant across
    solver iterations. Dead pairs must already point at the dummy row."""
    out = []
    B = prep.body_a.shape[0]
    for st, size in _phase_slices(prep):
        a = _flat_index(prep.body_a[:, st:st + size], num_rows)
        b = _flat_index(prep.body_b[:, st:st + size], num_rows)
        ones = torch.ones(a.shape[0], dtype=torch.float32,
                          device=a.device)
        deg = torch.zeros(B * num_rows, dtype=torch.float32, device=a.device)
        deg.index_add_(0, a, ones)
        deg.index_add_(0, b, ones)
        out.append((1.0 / torch.clamp(deg, min=1.0)).view(B, num_rows))
    return tuple(out)


def _phase_views(prep: ContactPrep, num_rows: int):
    """Per non-empty phase slice: (start, size, slice index, sliced prep,
    its point views, flat body indices of its a and b sides). Constant
    across solver iterations."""
    out = []
    for si, (st, size) in enumerate(_phase_slices(prep)):
        if size == 0:
            continue
        c = prep.slice(st, size)
        out.append((st, size, si, c,
                    [_PointView(c, k) for k in range(c.bias.shape[-1])],
                    _flat_index(c.body_a, num_rows),
                    _flat_index(c.body_b, num_rows)))
    return out


def _contact_phased_pass(views, v, w, accs, inv_deg_phases, omega=1.0):
    """One solver iteration over pair-major contacts (`views` from
    `_phase_views`): static phase slices in order; within a slice all pairs
    solve against the same velocities and per-body deltas are
    degree-averaged. Velocities are carried as one (B, N, 6) [v|w] array."""
    imp_n, imp_t = accs                                   # (B, P, 4)
    B, n = v.shape[0], v.shape[1]
    vw = torch.cat([v, w], dim=-1)
    imp_n_parts, imp_t_parts = [], []
    for st, size, si, c, points, fa, fb in views:
        ga = _rows(vw, c.body_a)
        gb = _rows(vw, c.body_b)
        va, wa = ga[..., :3], ga[..., 3:]
        vb, wb = gb[..., :3], gb[..., 3:]
        nva, nwa, nvb, nwb, ni, nt = _contact_solve_one(
            points, c.inv_ma, c.inv_mb, va, wa, vb, wb,
            imp_n[:, st:st + size], imp_t[:, st:st + size])
        imp_n_parts.append(ni)
        imp_t_parts.append(nt)
        da = torch.cat([nva - va, nwa - wa], dim=-1)
        db = torch.cat([nvb - vb, nwb - wb], dim=-1)
        delta = torch.zeros((B * n, 6), dtype=vw.dtype, device=vw.device)
        delta.index_add_(0, fa, da.reshape(-1, 6))
        delta.index_add_(0, fb, db.reshape(-1, 6))
        vw = vw + delta.view(B, n, 6) * (omega * inv_deg_phases[si])[..., None]
    if imp_n_parts:
        imp_n = torch.cat(imp_n_parts, dim=1)
        imp_t = torch.cat(imp_t_parts, dim=1)
    return vw[..., :3], vw[..., 3:], (imp_n, imp_t)


def solve_constraints(bodies: SolverBodies, contacts: ContactPrep,
                      num_iterations: int, mode: str = "jacobi",
                      omega: float = 1.0):
    """Run `num_iterations` rounds of the phased contact pass. Returns
    (bodies, contact_imp_n (B, P, 4) or None): the accumulated normal
    impulses per pair point."""
    if mode not in ("jacobi", "colored"):
        raise NotImplementedError(
            f"solver_mode={mode!r} on the reference step is not ported to "
            "dxk_tpu_torch yet; only 'jacobi' and 'colored' (the sequential "
            "'scan' contact pass is ROADMAP Queue A 5)")
    if contacts is None:
        return bodies, None
    v, w = bodies.v, bodies.w
    z = torch.zeros(contacts.bias.shape, dtype=v.dtype, device=v.device)
    accs = (z, z.clone())
    inv_deg_phases = contact_phase_inv_degrees(contacts, v.shape[1])
    views = _phase_views(contacts, v.shape[1])
    for _ in range(num_iterations):
        v, w, accs = _contact_phased_pass(views, v, w, accs, inv_deg_phases,
                                          omega=omega)
    return bodies.replace(v=v, w=w), accs[0]
