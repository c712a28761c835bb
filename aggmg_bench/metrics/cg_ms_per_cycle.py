"""``cg_ms_per_cycle``: device milliseconds per V-cycle of the kernels whose
launch call falls inside an ``aggmg.cg@<k>`` span, the work the solvers do on
a CG level (its smoothing sweeps and their residuals, the CG and seam
transfers from it, its defects).  The i-th launch call (sorted by start)
made the i-th kernel (sorted by start), as ``spans.kernel_spans`` pairs them;
the CG spans never nest in each other.  Nothing to read where the program
opens no such span or the launches and kernels do not pair one to one."""

from __future__ import annotations

import bisect

from aggmg_bench import spans

PREFIX = "aggmg.cg@"


def cg_kernels(rec) -> list | None:
    """The kernel events ``(name, start, dur)`` launched inside a CG span."""
    tr = rec.trace
    if tr is None or not rec.traced_cycles or not tr.kernels:
        return None
    cg = sorted((t0, t0 + d) for name, t0, d in tr.host if name.startswith(PREFIX))
    launches = sorted(t0 for name, t0, _ in tr.host if name in spans.LAUNCH_CALLS)
    if not cg or len(launches) != len(tr.kernels):
        return None
    starts = [s[0] for s in cg]
    out = []
    for t, k in zip(launches, sorted(tr.kernels, key=lambda k: k[1])):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and cg[i][1] >= t:
            out.append(k)
    return out


def read(rec):
    ks = cg_kernels(rec)
    return None if ks is None else sum(d for _, _, d in ks) / 1e6 / rec.traced_cycles
