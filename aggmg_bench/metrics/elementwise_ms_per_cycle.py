"""``elementwise_ms_per_cycle``: device milliseconds per V-cycle of
PyTorch's own elementwise and reduction kernels: the float-float chains of
``ops/df64.py``, the smoothing recurrences in plain torch, the float64
outer defect, norms.  The kernels whose names match ``PATTERN`` (cuBLAS's
split-K reduction is a contraction's, and is not matched)."""

import re

PATTERN = re.compile(r"elementwise_kernel|(?<![A-Za-z])reduce_kernel")


def read(rec):
    if rec.trace is None or not rec.traced_cycles:
        return None
    ns = sum(d for name, _, d in rec.trace.kernels if PATTERN.search(name))
    return ns / 1e6 / rec.traced_cycles
