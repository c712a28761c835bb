"""``coarse_host_ms_per_cycle``: host milliseconds per V-cycle inside the
``aggmg.coarse`` spans (their union over the levels): the coarsest level's
solve (``spans.host_ms_per_cycle``)."""

from aggmg_bench import spans


def read(rec):
    return spans.host_ms_per_cycle(rec, "coarse")
