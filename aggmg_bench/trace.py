"""The traced run: the profiler's events kept in memory and reduced to plain
lists, the device's busy time over the traced span, and the breakdown.

``busy_and_span`` is a frozen copy of the arithmetic of
``tools/trace_sharded_slice.py:43-56`` (``device_busy_ms``): the union of the
kernel, copy and memset intervals, and the span from the first to the last
event, here over this module's tuples instead of chrome-trace dicts.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

NAME_CUT = 100  # characters of a kernel's name kept in the breakdown


@dataclass
class Trace:
    """Times in ns on the profiler's clock, each event ``(name, start,
    dur)``: ``kernels``, ``copies`` (copies and memsets), and ``host``, the
    host's operators and CUDA runtime calls."""

    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host: list = field(default_factory=list)


def collect(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``, read from its
    Kineto result without building the profiler's Python event tree."""
    out = Trace()
    for e in prof.profiler.kineto_results.events():
        ev = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        if str(e.device_type()).endswith("CUDA"):
            (out.copies if ev[0].startswith(("Memcpy", "Memset")) else out.kernels).append(ev)
        else:
            out.host.append(ev)
    return out


def device_intervals(tr: Trace) -> list:
    return sorted((t0, t0 + d) for _, t0, d in tr.kernels + tr.copies)


def busy_and_span(tr: Trace) -> tuple:
    """(busy ns, span ns): the union of the device intervals, and the span
    from the first to the last event of any kind."""
    busy, end = 0, -1
    for t0, t1 in device_intervals(tr):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    timed = [(t0, t0 + d) for _, t0, d in tr.kernels + tr.copies + tr.host]
    span = max(t1 for _, t1 in timed) - min(t0 for t0, _ in timed)
    return busy, span


def idle_gaps(tr: Trace) -> list:
    """``[(start, end)]`` of the device's idle gaps between its first and
    last busy interval."""
    gaps, end = [], None
    for t0, t1 in device_intervals(tr):
        if end is not None and t0 > end:
            gaps.append((end, t0))
        end = t1 if end is None else max(end, t1)
    return gaps


def gaps_by_host(tr: Trace, top: int = 10) -> list:
    """The device's idle seconds by what the host was doing at each gap's
    midpoint: the innermost host operator or runtime call that covers it,
    or ``"host between operators"``; the ``top`` largest sums."""
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    sums = collections.Counter()
    for g0, g1 in idle_gaps(tr):
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host between operators"
        for j in range(i, max(i - 64, -1), -1):  # the latest-started cover is the innermost
            name, t0, d = host[j]
            if t0 + d >= mid:
                label = name
                break
        sums[label[:NAME_CUT]] += (g1 - g0) / 1e9
    return [[name, s] for name, s in sums.most_common(top)]


def device_ops(tr: Trace, top: int = 10) -> list:
    """``[[name, seconds]]`` of the device operations that took most time."""
    sums = collections.Counter()
    for name, _, d in tr.kernels + tr.copies:
        sums[name[:NAME_CUT]] += d / 1e9
    return [[name, s] for name, s in sums.most_common(top)]
