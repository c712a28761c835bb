"""``bcoo_launches_per_cycle``: the kernels launched inside the
``aggmg.bcoo@<k>`` spans (``bcoo_ms_per_cycle.bcoo_kernels``) per V-cycle:
the host's launch work on the block-COO levels."""

from aggmg_bench.metrics.bcoo_ms_per_cycle import bcoo_kernels


def read(rec):
    ks = bcoo_kernels(rec)
    return None if ks is None else len(ks) / rec.traced_cycles
