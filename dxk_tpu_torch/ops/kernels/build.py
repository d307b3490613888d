"""Build and bind the port's CUDA sources.

Every kernel file under ``csrc/`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into a shared library in ``<repo>/build/`` (git
ignored) the first time it is needed, named by a hash of the source and the
flags, and bound with ctypes. Nothing is compiled while a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    return os.path.join(root, "build")


def build_command(src: str, out_path: str, flags: List[str],
                  verbose: bool = False) -> List[str]:
    cand = "/usr/local/cuda/bin/nvcc"
    nvcc = cand if os.path.exists(cand) else "nvcc"
    flags = list(flags)
    if verbose:
        flags += ["-Xptxas", "-v"]
    return [nvcc] + flags + ["-o", out_path, src]


def compile_library(src_name: str, flags: List[str],
                    verbose: bool = False) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<src_name>`` with `flags` (once per source content
    and flags) and load it. Returns (library, compiler output; empty when
    the library was already built). Raises if nvcc is missing or fails."""
    src = os.path.join(CSRC, src_name)
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(flags).encode()
                           ).hexdigest()[:12]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(src_name)[0]
    path = os.path.join(out_dir, f"libdxk_{stem}_{tag}.so")
    log = ""
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(build_command(src, tmp, flags, verbose),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src_name}:\n{log}")
        os.replace(tmp, path)
    return ctypes.CDLL(path), log


def check_cuda(who, name, x, shape, dtype=torch.float32):
    """Raise unless `x` is a contiguous CUDA tensor of `shape` and `dtype`."""
    if x.device.type != "cuda":
        raise ValueError(f"{who}: {name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"{who}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def raise_on_error(who, err):
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")


def stream_of(x) -> int:
    """PyTorch's current stream on the device of `x`."""
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream
