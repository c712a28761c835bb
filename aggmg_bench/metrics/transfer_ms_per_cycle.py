"""``transfer_ms_per_cycle``: device milliseconds per V-cycle of the kernels
launched inside the ``aggmg.transfer`` spans: the restrictions,
prolongations and correction adds (``spans.device_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.device_ms_per_cycle(rec, "transfer")
