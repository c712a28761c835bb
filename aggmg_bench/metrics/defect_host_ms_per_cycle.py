"""``defect_host_ms_per_cycle``: host milliseconds per V-cycle inside the
``aggmg.defect`` spans (their union over the levels): the residuals and
norms computed outside a smoother, the drivers' stopping tests at level 0
(``spans.host_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.host_ms_per_cycle(rec, "defect")
