"""``host_syncs_per_cycle``: the host reads that wait for the device (the
solvers' ``aggmg.sync.*`` spans around each ``float(...)`` of a device
tensor) per V-cycle of the traced solves."""

from aggmg_bench import spans


def read(rec):
    return spans.count_per_cycle(rec, "aggmg.sync.")
