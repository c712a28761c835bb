"""``transfer_host_ms_per_cycle``: host milliseconds per V-cycle inside the
``aggmg.transfer`` spans (their union over the levels): the restrictions,
prolongations and correction adds (``spans.host_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.host_ms_per_cycle(rec, "transfer")
