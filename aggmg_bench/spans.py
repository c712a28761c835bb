"""The port's own spans in a traced run: the ``aggmg.*`` host events that
``models/solvers.py`` opens (``utils.profiling.span``), read from
``rec.trace.host``, and the kernels launched inside them.

A V-cycle's work falls in four phases, ``aggmg.<phase>@<level>`` (the
coarse solve has no level), which never nest; each host read that waits
for the device is an ``aggmg.sync.<site>`` span outside them.  A kernel
belongs to the phase whose span encloses its launch call on the host: the
i-th launch call (sorted by start) made the i-th kernel (sorted by start),
since a cell runs on one stream, where launch order is execution order.
Every number is per V-cycle of the traced solves; a trace without the
spans (a program that opens none) reads nothing.
"""

from __future__ import annotations

import bisect

PHASES = ("smooth", "transfer", "coarse", "defect")
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"})
PREFIX = "aggmg."


def phase(name: str) -> str | None:
    """``"smooth"`` for ``aggmg.smooth@3``, ``"coarse"`` for ``aggmg.coarse``;
    None for any other event."""
    if not name.startswith(PREFIX):
        return None
    p = name[len(PREFIX):].split("@", 1)[0]
    return p if p in PHASES else None


def _traced(rec) -> bool:
    return (rec.trace is not None and rec.traced_cycles > 0
            and any(name.startswith(PREFIX) for name, _, _ in rec.trace.host))


def count_per_cycle(rec, prefix: str) -> float | None:
    """Host spans whose name starts with ``prefix``, per V-cycle."""
    if not _traced(rec):
        return None
    return sum(name.startswith(prefix) for name, _, _ in rec.trace.host) / rec.traced_cycles


def host_ms_per_cycle(rec, which: str) -> float | None:
    """Host milliseconds inside the spans of phase ``which`` (the union of
    their intervals, every level), per V-cycle."""
    if not _traced(rec):
        return None
    ns, end = 0, -1
    for t0, t1 in sorted((t0, t0 + d) for name, t0, d in rec.trace.host if phase(name) == which):
        if t1 > end:
            ns += t1 - max(t0, end)
            end = t1
    return ns / 1e6 / rec.traced_cycles


def kernel_spans(tr) -> list | None:
    """The name of the phase span that encloses each kernel's launch call,
    for the kernels of ``tr`` in start order (None outside every phase
    span); None where the launch calls and the kernels do not pair one to
    one."""
    launches = sorted(t0 for name, t0, _ in tr.host if name in LAUNCH_CALLS)
    if len(launches) != len(tr.kernels):
        return None
    spans = sorted((t0, t0 + d, name) for name, t0, d in tr.host if phase(name))
    starts = [s[0] for s in spans]
    out = []
    for t in launches:  # phase spans never nest: only the latest one started can enclose t
        i = bisect.bisect_right(starts, t) - 1
        out.append(spans[i][2] if i >= 0 and spans[i][1] >= t else None)
    return out


def device_ms_per_cycle(rec, which: str) -> float | None:
    """Device milliseconds of the kernels launched inside phase ``which``'s
    spans, per V-cycle."""
    if not _traced(rec) or not rec.trace.kernels:
        return None
    labels = kernel_spans(rec.trace)
    if labels is None:
        return None
    kernels = sorted(rec.trace.kernels, key=lambda k: k[1])
    ns = sum(d for (_, _, d), label in zip(kernels, labels) if label and phase(label) == which)
    return ns / 1e6 / rec.traced_cycles
