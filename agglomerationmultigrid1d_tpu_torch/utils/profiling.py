"""Profiling helpers: a wall timer, a rate, a forced device sync, and a
``torch.profiler`` trace written as a Chrome trace (CUDA activity included
when a card is there)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .precision import tree_map


def sync(x) -> float:
    """Wait for the work every tensor of ``x`` (any nesting of NamedTuples,
    tuples and lists) depends on, then return the sum of all their entries."""
    leaves = []
    tree_map(leaves.append, x)
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return float(sum(float(t.sum()) for t in leaves))


@contextlib.contextmanager
def wall_timer(label: str = "", sink=None):
    """``with wall_timer("solve") as t: ...`` then ``t()`` gives seconds;
    ``sink(label, seconds)`` is called on exit."""
    t0 = time.perf_counter()
    result = {}
    yield lambda: result.get("dt", time.perf_counter() - t0)
    result["dt"] = time.perf_counter() - t0
    if sink is not None:
        sink(label, result["dt"])


def nnz_per_second(nnz: int, seconds: float) -> float:
    return nnz / seconds


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed work with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto), with the device's kernels when a card is there; the profile
    object is yielded."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
