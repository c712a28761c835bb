"""``defect_ms_per_cycle``: device milliseconds per V-cycle of the kernels
launched inside the ``aggmg.defect`` spans: the residuals and norms computed
outside a smoother, the drivers' stopping tests at level 0
(``spans.device_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.device_ms_per_cycle(rec, "defect")
