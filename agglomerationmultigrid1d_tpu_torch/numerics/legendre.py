"""Legendre polynomial evaluation (host-side NumPy, setup time only).

Mirrors the behavior of the reference's three-term recurrences
(``src/legendre.jl:14-25`` and ``:44-58``) but vectorized over evaluation points.
These tables are tiny and computed once per reference element at setup, so they
stay on the host; only the resulting dense basis tables ever reach the device.
"""

from __future__ import annotations

import numpy as np


def legendre_vals(x: np.ndarray, n: int) -> np.ndarray:
    """Values of P_0..P_n at points ``x``.

    Returns an array of shape ``(len(x), n + 1)``; column ``m`` is P_m evaluated at
    each point.  Uses the standard recurrence
    ``i * P_i = (2i - 1) x P_{i-1} - (i - 1) P_{i-2}`` (cf. ``src/legendre.jl:20``).
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.empty((x.shape[0], n + 1), dtype=np.float64)
    out[:, 0] = 1.0
    if n >= 1:
        out[:, 1] = x
    for i in range(2, n + 1):
        out[:, i] = ((2 * i - 1) * x * out[:, i - 1] - (i - 1) * out[:, i - 2]) / i
    return out


def legendre_vals_and_derivs(x: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of P_0..P_n at points ``x``.

    Derivative recurrence: ``P'_i = (2i - 1) P_{i-1} + P'_{i-2}``
    (cf. ``src/legendre.jl:53``).  Shapes ``(len(x), n + 1)`` each.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    fun = np.empty((x.shape[0], n + 1), dtype=np.float64)
    der = np.empty((x.shape[0], n + 1), dtype=np.float64)
    fun[:, 0] = 1.0
    der[:, 0] = 0.0
    if n >= 1:
        fun[:, 1] = x
        der[:, 1] = 1.0
    for i in range(2, n + 1):
        fun[:, i] = ((2 * i - 1) * x * fun[:, i - 1] - (i - 1) * fun[:, i - 2]) / i
        der[:, i] = (2 * i - 1) * fun[:, i - 1] + der[:, i - 2]
    return fun, der
