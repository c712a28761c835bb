"""``device_idle_pct``: the share of the traced span in which no kernel,
copy or memset ran on the card (``trace.busy_and_span``)."""


def read(rec):
    if rec.trace is None or not rec.span_ns:
        return None
    return 100.0 * (1.0 - rec.busy_ns / rec.span_ns)
