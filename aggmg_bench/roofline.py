"""The kernels' bytes, operations and roofline bound, and which kernel a
profiler event's name is.

``col_bytes``, ``ghost_bytes``, ``col_ops`` and ``bound`` are a frozen copy of
``chip_smoke.py:376-425`` (with ``K7_FORMS``, ``PEAK_BPS`` and ``PEAK_FLOPS``
from ``chip_smoke.py:246-260``), kept here so that no later change to the
program moves the yardstick: each input read once, each output written once,
the float32 operations the kernel's arithmetic needs at that shape, and the
bound the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s
(NVIDIA H100 SXM data sheet).
"""

from __future__ import annotations

import re

PEAK_BPS = 3.35e12  # H100 SXM data sheet: HBM3 bytes/s
PEAK_FLOPS = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
K7_FORMS = {  # label: (ghosted wrapper, its launch counter, the unsharded kernel it extends)
    "K7": ("multisweep", "multisweep_ghost", "K2"),
    "K7r": ("multisweep_residual", "multisweep_residual_ghost", "K1"),
    "K7c": ("chebyshev_multisweep", "chebyshev_multisweep_ghost", "K5"),
    "K7cr": ("chebyshev_multisweep_residual", "chebyshev_multisweep_residual_ghost", "K5r"),
}


def col_bytes(name, bs):
    """Bytes per block column a kernel must move: each input read once, each
    output written once (K7: those of the kernel it extends; its ghosts are
    priced per launch by ``ghost_bytes``)."""
    name = K7_FORMS[name][2] if name in K7_FORMS else name
    return 4 * {
        "K1": 4 * bs * bs + 2 * bs + 2 * bs,
        "K2": 3 * bs * bs + 2 * bs + bs,
        "K3": 3 * bs * bs + bs + bs,
        "K5": 3 * bs * bs + 2 * bs + bs,
        "K5r": 4 * bs * bs + 2 * bs + 2 * bs,
        "K6": 6 * bs,
        "K8": 4 * bs * bs + 2 * bs + bs,
        "K4": 3 * bs * bs + 2 * bs + bs,
    }[name]


def ghost_bytes(name, bs):
    """K7's ghost columns a launch reads: ML, MU, S^-1, x, b of the
    ``k (+1)`` nearest ghost columns a side (the kernel's window halo)."""
    halo = 3 + (1 if name in ("K7r", "K7cr") else 0)
    return 4 * 2 * halo * (3 * bs * bs + 2 * bs)


def col_ops(name, bs, k=3):
    """Float32 operations per block column (an FMA is two): the
    contractions and updates of the kernel's arithmetic."""
    name = K7_FORMS[name][2] if name in K7_FORMS else name
    mat = 2 * bs * bs
    sweeps = 2 * mat + 4 * bs
    return {
        "K1": mat + k * sweeps + 2 * mat + 3 * bs + mat + bs,
        "K2": mat + k * sweeps,
        "K3": 3 * mat + 2 * bs,
        "K5": mat + k * (sweeps + 3 * bs),
        "K5r": mat + k * (sweeps + 3 * bs) + 2 * mat + 3 * bs + mat + bs,
        "K6": 105 * bs * bs,
        "K8": 4 * mat + 5 * bs,
        "K4": 3 * bs * bs + 2 * bs,
    }[name]


def bound(name, bs, n) -> tuple:
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes / 3.35 TB/s and operations / 67 TFLOP/s (float32)."""
    nbytes = col_bytes(name, bs) * n + (ghost_bytes(name, bs) if name in K7_FORMS else 0)
    t_bytes, t_ops = nbytes / PEAK_BPS * 1e3, col_ops(name, bs) * n / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# which kernel a profiler event is
# ---------------------------------------------------------------------------

_KERNEL = re.compile(
    r"\b(multisweep_kernel|bt_matvec_kernel|ff_stencil_defect_kernel|sweep_kernel|stream_kernel)"
    r"<\s*(\d+)\s*(?:,\s*(true|false)\s*,\s*(true|false)\s*)?>"
)
_SIMPLE = {"bt_matvec_kernel": "K3", "ff_stencil_defect_kernel": "K6", "sweep_kernel": "K8", "stream_kernel": "K4"}


def kernel_label(name: str):
    """``(label, bs)`` of a hand-written kernel's event name (K1-K6, K8,
    K4), or None for any other kernel (the edge pair and packing included:
    they bound nothing a whole pass does)."""
    m = _KERNEL.search(name)
    if m is None:
        return None
    fn, bs = m.group(1), int(m.group(2))
    if fn == "multisweep_kernel":
        residual, cheb = m.group(3) == "true", m.group(4) == "true"
        return ("K5r" if residual else "K5") if cheb else ("K1" if residual else "K2"), bs
    return _SIMPLE[fn], bs
