"""``schwarz_ms_per_cycle``: device milliseconds per V-cycle of the kernels
whose launch call falls inside an ``aggmg.schwarz@<k>`` span, one apply of
a Schwarz smoother on CG level ``k`` (the window gather, the window
contraction, the scatter-add and the multiplicity scale).  Launches pair
with kernels as ``cg_ms_per_cycle.cg_kernels`` pairs them (a copy, with
this span's prefix); the Schwarz spans never nest in each other.  Nothing
to read where the program opens no such span (a Jacobi-smoothed chain, or a
program without the span) or the launches and kernels do not pair one to
one."""

from __future__ import annotations

import bisect

from aggmg_bench import spans

PREFIX = "aggmg.schwarz@"


def schwarz_kernels(rec) -> list | None:
    """The kernel events ``(name, start, dur)`` launched inside a Schwarz span."""
    tr = rec.trace
    if tr is None or not rec.traced_cycles or not tr.kernels:
        return None
    marked = sorted((t0, t0 + d) for name, t0, d in tr.host if name.startswith(PREFIX))
    launches = sorted(t0 for name, t0, _ in tr.host if name in spans.LAUNCH_CALLS)
    if not marked or len(launches) != len(tr.kernels):
        return None
    starts = [s[0] for s in marked]
    out = []
    for t, k in zip(launches, sorted(tr.kernels, key=lambda k: k[1])):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and marked[i][1] >= t:
            out.append(k)
    return out


def read(rec):
    ks = schwarz_kernels(rec)
    return None if ks is None else sum(d for _, _, d in ks) / 1e6 / rec.traced_cycles
