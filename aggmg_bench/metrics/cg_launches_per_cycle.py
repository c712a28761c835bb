"""``cg_launches_per_cycle``: the kernels launched inside the
``aggmg.cg@<k>`` spans (``cg_ms_per_cycle.cg_kernels``) per V-cycle: the
host's launch work on the CG levels."""

from aggmg_bench.metrics.cg_ms_per_cycle import cg_kernels


def read(rec):
    ks = cg_kernels(rec)
    return None if ks is None else len(ks) / rec.traced_cycles
