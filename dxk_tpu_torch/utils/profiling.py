"""Profiling and metrics: the counterpart of the JAX package's
utils/profiling.py.

  - `profile_block(name)`: a `torch.profiler.record_function` range, and an
    NVTX range when a CUDA device is present, so blocks show in traces.
  - `trace(dir)`: `torch.profiler.profile` over the block (CPU, and CUDA
    when present), written to `dir/trace.json` as a Chrome trace.
  - `sync(tree)`: waits for the device that holds the first tensor of
    `tree` (CUDA launches return before the device is done).
  - `step_timer`: wall-clock timing of a block, synchronised first when
    given a result.
  - `StatsLogger`: host-side rows of per-step scalar metrics, written as
    CSV.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def profile_block(name: str):
    """Annotate a trace region."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the block (host ops, and CUDA kernels when a
    device is present) as `log_dir/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def sync(tree) -> None:
    """Wait for the CUDA device that holds the first tensor of `tree`
    (nothing to wait for on the CPU)."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def step_timer(out: Dict[str, float], key: str, result_tree=None):
    t0 = time.perf_counter()
    yield
    if result_tree is not None:
        sync(result_tree)
    out[key] = time.perf_counter() - t0


class StatsLogger:
    """Accumulates per-step metric dicts (scalars) and writes CSV."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: List[Dict[str, float]] = []

    def log(self, step: int, metrics: Dict) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self.rows.append(row)

    def flush(self) -> None:
        if not self.path or not self.rows:
            return
        keys = sorted({k for r in self.rows for k in r})
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)
