"""``coarse_ms_per_cycle``: device milliseconds per V-cycle of the kernels
launched inside the ``aggmg.coarse`` spans: the coarsest level's solve
(``spans.device_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.device_ms_per_cycle(rec, "coarse")
