"""``smooth_host_ms_per_cycle``: host milliseconds per V-cycle inside the
``aggmg.smooth`` spans (their union over the levels): the smoothing sweeps,
with a residual fused into them (``spans.host_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.host_ms_per_cycle(rec, "smooth")
