"""``contraction_ms_per_cycle``: device milliseconds per V-cycle of the
block contractions (``torch.einsum`` over ``(bs, bs, n)`` blocks in
``ops/block_diag.py`` and ``ops/transfer_ops.py``), which PyTorch hands to
cuBLAS: the kernels whose names match ``PATTERN``."""

import re

PATTERN = re.compile(r"gemv|gemm|xmma|cutlass|splitKreduce|dot_kernel|cublas", re.IGNORECASE)


def read(rec):
    if rec.trace is None or not rec.traced_cycles:
        return None
    ns = sum(d for name, _, d in rec.trace.kernels if PATTERN.search(name))
    return ns / 1e6 / rec.traced_cycles
