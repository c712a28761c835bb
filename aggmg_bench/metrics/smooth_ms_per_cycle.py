"""``smooth_ms_per_cycle``: device milliseconds per V-cycle of the kernels
launched inside the ``aggmg.smooth`` spans: the smoothing sweeps, with a
residual fused into them (``spans.device_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.device_ms_per_cycle(rec, "smooth")
