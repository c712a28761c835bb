"""``schwarz_launches_per_cycle``: the kernels launched inside the
``aggmg.schwarz@<k>`` spans (``schwarz_ms_per_cycle.schwarz_kernels``) per
V-cycle: the host's launch work of the Schwarz window applies."""

from aggmg_bench.metrics.schwarz_ms_per_cycle import schwarz_kernels


def read(rec):
    ks = schwarz_kernels(rec)
    return None if ks is None else len(ks) / rec.traced_cycles
