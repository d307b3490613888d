"""Port parity, module utils/noise.py: perlin, fbm and the demo scene's
terrain_heightfield against the JAX package on the same numpy inputs, and
the lattice hash where its int32 products overflow.

The hash is integer arithmetic and is held exactly. The noise passes
through cos / sin, which PyTorch's CPU build and XLA:CPU round to within
an ulp of each other, so values are held to a stated absolute tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.utils import noise as jn
from dxk_tpu_torch.utils import noise as tn

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))

# noise in ~[-0.7, 0.7]: an ulp of cos / sin (6e-8) through four corner
# dot products and two lerps stays under 1e-6
NOISE_TOL = 1e-6
# the demo's heights reach ~6 m (height_scale 4 x an fbm range ~1.5)
HEIGHT_TOL = 4e-6


def test_hash_wraps_like_int32():
    """Coordinates where every product overflows int32, the int32 extremes
    and negative values: bit-equal hashes and gradients' angles."""
    rng = np.random.default_rng(3)
    ix = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(
        np.int32)
    iy = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(
        np.int32)
    ix[:4] = [2 ** 31 - 1, -2 ** 31, 0, -1]
    iy[:4] = [-2 ** 31, 2 ** 31 - 1, -1, 0]
    for seed in (0, 3, 2 ** 31 - 1):
        want = np.asarray(jn._hash2(jnp.asarray(ix), jnp.asarray(iy),
                                    jnp.int32(seed)))
        got = tn._hash2(torch.from_numpy(ix).long(),
                        torch.from_numpy(iy).long(), seed).numpy()
        assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("span", [4.0, 1e5])
def test_perlin(span):
    """Sample coordinates across a few cells and far from the origin
    (lattice products past int32), several seeds."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-span, span, 8192).astype(np.float32)
    y = rng.uniform(-span, span, 8192).astype(np.float32)
    x[:3] = [0.0, -1.0, 2.5]
    for seed in (0, 7):
        want = np.asarray(jn.perlin(jnp.asarray(x), jnp.asarray(y), seed))
        got = tn.perlin(torch.from_numpy(x), torch.from_numpy(y),
                        seed).numpy()
        assert np.abs(got - want).max() <= NOISE_TOL


def test_fbm():
    """Four octaves: each octave's error below NOISE_TOL, amplitudes sum
    to < 2."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-10, 10, (64, 64)).astype(np.float32)
    y = rng.uniform(-10, 10, (64, 64)).astype(np.float32)
    want = np.asarray(jn.fbm(jnp.asarray(x), jnp.asarray(y), seed=2))
    got = tn.fbm(torch.from_numpy(x), torch.from_numpy(y), seed=2).numpy()
    assert np.abs(got - want).max() <= 2 * NOISE_TOL


def test_demo_terrain():
    """The demo scene's terrain_heightfield(48, 2.0, 4.0, seed=3)."""
    want = np.asarray(jn.terrain_heightfield(size=48, cell_size=2.0,
                                             height_scale=4.0, seed=3))
    got = tn.terrain_heightfield(size=48, cell_size=2.0, height_scale=4.0,
                                 seed=3, device="cpu")
    assert got.shape == (48, 48) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= HEIGHT_TOL
