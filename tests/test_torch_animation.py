"""Port parity, module ops/animation.py: clip sampling (loop wrap and
clamp, the rotation hemisphere fix, unanimated rows), every combination
of the bake flags, blending, global_transforms, skinning and
instance_update over several steps, on the same seeded clips, against the
JAX package (vmapped over times and instances); and the carriers of
utils/convert.py.

The port gathers the two keys by index where the JAX package sums one-hot
products (exact for finite values), and runs the same float32 operations
in the same order; 4x4 and skinning products are broadcast sums where
XLA:CPU runs a dot, whose multiply-adds may round differently. So poses
are held within TOL of max(1, their largest) and skinned points within
SKIN_TOL of it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.ops import animation as ja
from dxk_tpu_torch.ops import animation as ta
from dxk_tpu_torch.utils.convert import (animation_clip_from_numpy,
                                         animation_instance_from_numpy,
                                         trs_from_numpy)

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

TOL = 2e-6
SKIN_TOL = 4e-6
J = 6
PARENTS = np.array([-1, 0, 1, 1, 3, 0])


def _quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _tracks(rng, dim, n_keys, length, quat=False):
    """Per joint: keys at sorted times in [0, length], a few joints
    unanimated or single-keyed; rotations with flipped signs so that the
    hemisphere fix acts."""
    out = []
    for j in range(J):
        n = n_keys[j]
        if n == 0:
            out.append(([], []))
            continue
        ts = np.sort(rng.uniform(0, length, n)).astype(np.float32)
        ts[0] = 0.0
        if quat:
            v = _quat(rng, n)
            v[1::2] *= -1.0
        else:
            v = rng.normal(size=(n, dim)).astype(np.float32)
            if dim == 3 and j % 2:
                v = np.abs(v) + 0.5                  # positive scales
        out.append((ts.tolist(), v.tolist()))
    return out


def clips(seed, **flags):
    """The same seeded clip in both packages."""
    rng = np.random.default_rng(seed)
    length = 2.5
    kw = dict(pos_tracks=_tracks(rng, 3, [4, 0, 3, 1, 5, 2], length),
              rot_tracks=_tracks(rng, 4, [3, 5, 0, 2, 4, 1], length,
                                 quat=True),
              scale_tracks=_tracks(rng, 3, [0, 2, 3, 0, 1, 4], length),
              length=length,
              root_pos=([0.0, 1.0, 2.5], [(0, 0, 0), (1, 0.5, 2),
                                          (3, 1, -1)]),
              root_rot=([0.0, 2.5], _quat(rng, 2).tolist()), **flags)
    return ja.make_clip(**kw), ta.make_clip(**kw, device="cpu")


def _trs_np(t):
    return {k: np.asarray(getattr(t, k)) for k in ("pos", "rot", "scale")}


def _hold_trs(got, want, tol=TOL):
    for k, w in _trs_np(want).items():
        g = getattr(got, k).numpy()
        assert g.shape == w.shape, k
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, (k, np.abs(g - w).max())


TIMES = np.array([-0.5, 0.0, 0.3, 0.999, 1.0, 1.7, 2.4999, 2.5, 3.9],
                 np.float32)
FLAGS = [dict(bake_root_rotation=r, bake_root_xz=x, bake_root_y=y)
         for r in (False, True) for x in (False, True) for y in (False, True)]


@pytest.mark.parametrize("flags", FLAGS, ids=[
    "".join("RXY"[i] for i, v in enumerate(f.values()) if v) or "none"
    for f in FLAGS])
def test_sample_clip(flags):
    """Times before, on and between keys, at and past the end (clamped);
    each bake flag combination."""
    jclip, tclip = clips(3, **flags)
    jloc, jroot = jax.vmap(lambda t: ja.sample_clip(jclip, t))(
        jnp.asarray(TIMES))
    loc, root = ta.sample_clip(tclip, torch.from_numpy(TIMES))
    _hold_trs(loc, jloc)
    _hold_trs(root, jroot)
    # one time as a 0-d tensor: the unbatched shapes
    l1, r1 = ta.sample_clip(tclip, 1.7)
    jl1, jr1 = ja.sample_clip(jclip, 1.7)
    _hold_trs(l1, jl1)
    _hold_trs(r1, jr1)
    for first in (True, False):
        fn = "first_root_transform" if first else "last_root_transform"
        _hold_trs(getattr(ta, fn)(tclip), getattr(ja, fn)(jclip))


def test_blend_global_and_skinning():
    jclip, tclip = clips(5)
    t2 = np.float32(0.9)
    jl1, _ = ja.sample_clip(jclip, 0.4)
    jl2, _ = ja.sample_clip(jclip, 2.1)
    l1, _ = ta.sample_clip(tclip, 0.4)
    l2, _ = ta.sample_clip(tclip, 2.1)
    for t in (-0.2, 0.35, 1.4):                 # clipped to [0, 1]
        _hold_trs(ta.blend_local(l1, l2, t), ja.blend_local(jl1, jl2, t))
    jbl = ja.blend_local(jl1, jl2, t2)
    bl = ta.blend_local(l1, l2, float(t2))
    rng = np.random.default_rng(7)
    world = dict(pos=rng.normal(size=3).astype(np.float32),
                 rot=_quat(rng, 1)[0], scale=np.full(3, 1.5, np.float32))
    jw = ja.Trs(**{k: jnp.asarray(v) for k, v in world.items()})
    for w in (None, world):
        jg = ja.global_transforms(PARENTS, jbl, None if w is None else jw)
        g = ta.global_transforms(PARENTS, bl, None if w is None else
                                 trs_from_numpy(w, device="cpu"))
        _hold_trs(g, jg)
    inv_bind = rng.normal(size=(J, 4, 4)).astype(np.float32)
    jm = ja.skinning_matrices(jg, inv_bind)
    m = ta.skinning_matrices(g, torch.from_numpy(inv_bind))
    scale = max(1.0, float(np.abs(np.asarray(jm)).max()))
    assert np.abs(m.numpy() - np.asarray(jm)).max() <= SKIN_TOL * scale
    V, W = 200, 3
    pts = rng.normal(size=(V, 3)).astype(np.float32)
    ids = rng.integers(0, J, (V, W)).astype(np.int32)
    wts = rng.dirichlet(np.ones(W), V).astype(np.float32)
    jp = ja.skin_points(jm, jnp.asarray(pts), jnp.asarray(ids),
                        jnp.asarray(wts))
    p = ta.skin_points(m, torch.from_numpy(pts), torch.from_numpy(ids),
                       torch.from_numpy(wts))
    scale = max(1.0, float(np.abs(np.asarray(jp)).max()))
    assert np.abs(p.numpy() - np.asarray(jp)).max() <= SKIN_TOL * scale
    _hold_trs(ta.trs_invert(g), ja.trs_invert(jg))
    assert np.abs(ta.trs_to_mat4(g).numpy()
                  - np.asarray(ja.trs_to_mat4(jg))).max() <= TOL * scale


@pytest.mark.parametrize("looping", [True, False])
def test_instance_update(looping):
    """Eight instances from seeded start times, twelve updates of 0.37 s
    (past the clip's end: wrap or clamp), held every step."""
    jclip, tclip = clips(9, looping=looping, bake_root_xz=True)
    start = np.random.default_rng(2).uniform(0, 2.5, 8).astype(np.float32)
    jinst = jax.vmap(lambda t: ja.instance_init(jclip, t))(
        jnp.asarray(start))
    inst = ta.instance_init(tclip, torch.from_numpy(start))
    step = jax.vmap(lambda i: ja.instance_update(jclip, i, 0.37))
    wraps = 0
    for _ in range(12):
        jinst, jloc, jdelta = step(jinst)
        before = inst.time
        inst, loc, delta = ta.instance_update(tclip, inst, 0.37)
        wraps += int((inst.time < before).sum())
        assert np.array_equal(inst.time.numpy(), np.asarray(jinst.time))
        _hold_trs(inst.last_root, jinst.last_root)
        _hold_trs(loc, jloc)
        _hold_trs(delta, jdelta)
    assert (wraps > 0) == looping


def test_carriers():
    """JAX clip, instance and Trs -> numpy -> port: equal arrays."""
    jclip, tclip = clips(11, looping=False, bake_root_y=True)
    fields = {"pos": None, "rot": None, "scale": None}
    for k in fields:
        ch = getattr(jclip, k)
        fields[k] = {f: np.asarray(getattr(ch, f))
                     for f in ("ts", "vals", "count")}
    fields.update(animated=np.asarray(jclip.animated),
                  length=np.asarray(jclip.length),
                  **{k: getattr(jclip, k) for k in (
                      "looping", "bake_root_rotation", "bake_root_xz",
                      "bake_root_y")})
    got = animation_clip_from_numpy(fields, device="cpu")
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(tclip, f.name)
        if isinstance(a, ta.Channel):
            for g in ("ts", "vals", "count"):
                assert torch.equal(getattr(a, g), getattr(b, g))
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    jinst = jax.vmap(lambda t: ja.instance_init(jclip, t))(
        jnp.asarray([0.0, 1.0], jnp.float32))
    inst = animation_instance_from_numpy(
        {"time": np.asarray(jinst.time),
         "last_root": _trs_np(jinst.last_root)}, device="cpu")
    _hold_trs(inst.last_root, jinst.last_root, 0.0)
    assert np.array_equal(inst.time.numpy(), np.asarray(jinst.time))
