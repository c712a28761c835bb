"""``bcoo_host_ms_per_cycle``: host milliseconds per V-cycle inside the
``aggmg.bcoo@<k>`` spans (their union over the levels): the host's time
on the block-COO levels' work.  Nothing to read where the program opens no
such span."""

from aggmg_bench.metrics.bcoo_ms_per_cycle import PREFIX


def read(rec):
    if rec.trace is None or not rec.traced_cycles:
        return None
    marked = sorted((t0, t0 + d) for name, t0, d in rec.trace.host if name.startswith(PREFIX))
    if not marked:
        return None
    ns, end = 0, -1
    for t0, t1 in marked:
        if t1 > end:
            ns += t1 - max(t0, end)
            end = t1
    return ns / 1e6 / rec.traced_cycles
