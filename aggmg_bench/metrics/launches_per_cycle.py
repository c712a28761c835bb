"""``launches_per_cycle``: device kernel launches of the traced solves over
their V-cycles (the host's launch work per cycle)."""


def read(rec):
    if rec.trace is None or not rec.traced_cycles:
        return None
    return len(rec.trace.kernels) / rec.traced_cycles
