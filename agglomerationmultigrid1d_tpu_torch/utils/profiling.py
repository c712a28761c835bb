"""Profiling helpers: the span every timed region of the port is, a forced
device sync, and a ``torch.profiler`` trace written as a Chrome trace (CUDA
activity included when a card is there)."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast

from .precision import tree_map


def sync(x) -> float:
    """Wait for the work every tensor of ``x`` (any nesting of NamedTuples,
    tuples and lists) depends on, then return the sum of all their entries."""
    leaves = []
    tree_map(leaves.append, x)
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return float(sum(float(t.sum()) for t in leaves))


class span:
    """``with span("aggmg.smooth@2"): ...`` marks the enclosed host work for
    ``torch.profiler`` as a ``cpu_op`` event of that name: on the profiler's
    clock, beside the operators and kernel launches it encloses, and not a
    user annotation, which the profiler would mirror onto the device's
    timeline.  With no ``sink``, ``span(name)`` is the profiler's fast
    record function itself (half a microsecond to enter and leave with no
    profiler running, the cost of a hot path's span), and it never waits
    for the device.

    With a ``sink`` it also times the region on the host clock, the
    device's queue drained at both ends (``torch.cuda.synchronize`` once
    CUDA is in use), into ``seconds``; a dict sink adds them under the
    name's last dotted part, a callable gets ``(name, seconds)``."""

    __slots__ = ("name", "sink", "seconds", "_rf", "_t0")

    def __new__(cls, name: str, sink=None):
        if sink is None:
            return _RecordFunctionFast(name)
        return super().__new__(cls)

    def __init__(self, name: str, sink=None):
        self.name = name
        self.sink = sink
        self.seconds = None

    def __enter__(self):
        _drain()
        self._t0 = time.perf_counter()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _drain()
        self.seconds = time.perf_counter() - self._t0
        if callable(self.sink):
            self.sink(self.name, self.seconds)
        else:
            key = self.name.rsplit(".", 1)[-1]
            self.sink[key] = self.sink.get(key, 0.0) + self.seconds
        return False


def _drain() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
