"""All-pairs AABB overlap matrix, batched over environments.

Replaces the JAX package's ``ops/pallas/broadphase_kernel.py::
aabb_overlap_matrix_pallas`` (body ``_overlap_kernel``), the TPU kernel
behind the dense branch of ``ops/broadphase.py::aabb_overlap_mask``. Holds

  - `aabb_overlap_matrix_plain`, the plain PyTorch version (the JAX
    package's dense XLA formulation);
  - `aabb_overlap_matrix`, the wrapper around ``overlap_matrix_kernel`` of
    ``csrc/broadphase.cu``: the plain version for tensors that lie on the
    CPU, the kernel for CUDA tensors, or it raises;
  - `load_library`, which builds ``csrc/broadphase.cu`` (all three
    broadphase kernels) and binds its entry points.

What bounds the kernel on an H100: bytes (B * C * C int8 written; six
float compares per byte). A block takes one env, a tile of 32 rows and the
whole row of columns, or, for envs wider than 1536 colliders or batches too
small to give every SM two blocks, a chunk of 256 to 1024 columns. It stages
the columns' AABBs in shared memory as six SoA float arrays, keeps four
rows' AABBs in each of its eight warps' registers, walks the columns a lane
each and tests them without a branch, writing the bytes into a shared tile
whose addresses match the output's modulo 16; then it copies the tile out
in 16-byte chunks aligned in global memory, a warp writing 512 contiguous
bytes. Row starts are not 16-byte
aligned when C % 16 != 0: a tile of whole rows is one contiguous range, so
only its first and last chunk are written byte by byte (a chunked tile's
rows each have a ragged head and tail). Not done: TMA staging, and a
bit-packed matrix, which would change the function this returns.
"""

from __future__ import annotations

import ctypes

import torch

from dxk_tpu_torch.ops.kernels import build

NVCC_FLAGS = list(build.BASE_FLAGS)
MAX_ROWS = 65535 * 8     # the most colliders a broadphase wrapper takes

_LIB = None
_LAUNCHES = 0
BUILD_LOG = ""


def launch_count() -> int:
    """Kernel launches made by the wrapper since the last reset."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def load_library(verbose: bool = False):
    """Compile csrc/broadphase.cu (once per source content) and bind the
    three launch entry points. Raises if nvcc is missing or fails."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = build.compile_library("broadphase.cu", NVCC_FLAGS,
                                           verbose)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dxk_overlap_matrix_launch.restype = i
    lib.dxk_overlap_matrix_launch.argtypes = [i, i, p, p, p, p]
    lib.dxk_kselect_launch.restype = i
    lib.dxk_kselect_launch.argtypes = [i, i, i, i] + [p] * 8 + [p]
    lib.dxk_sap_launch.restype = i
    lib.dxk_sap_launch.argtypes = [i, i, i, i, i] + [p] * 9 + [p]
    _LIB = lib
    return lib


def aabb_overlap_matrix_plain(aabb_min, aabb_max):
    """(B, C, 3) x2 -> (B, C, C) int8: 1 where AABB i overlaps AABB j."""
    no = (torch.any(aabb_min[:, :, None, :] > aabb_max[:, None, :, :], dim=-1)
          | torch.any(aabb_min[:, None, :, :] > aabb_max[:, :, None, :],
                      dim=-1))
    return (~no).to(torch.int8)


def aabb_overlap_matrix(aabb_min, aabb_max):
    """(B, C, 3) x2 float32 -> (B, C, C) int8 overlap {0, 1}. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global _LAUNCHES
    if aabb_min.device.type == "cpu":
        return aabb_overlap_matrix_plain(aabb_min, aabb_max)
    who = "aabb_overlap_matrix"
    B, C = aabb_min.shape[0], aabb_min.shape[1]
    build.check_cuda(who, "aabb_min", aabb_min, (B, C, 3))
    build.check_cuda(who, "aabb_max", aabb_max, (B, C, 3))
    if B == 0 or C == 0 or C > MAX_ROWS:
        raise ValueError(f"{who}: needs 0 < C <= {MAX_ROWS} and B > 0, "
                         f"got B={B}, C={C}")
    lib = load_library()
    out = torch.empty((B, C, C), dtype=torch.int8, device=aabb_min.device)
    build.raise_on_error(who, lib.dxk_overlap_matrix_launch(
        B, C, aabb_min.data_ptr(), aabb_max.data_ptr(), out.data_ptr(),
        build.stream_of(aabb_min)))
    _LAUNCHES += 1
    return out
