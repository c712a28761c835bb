"""Gauss-Legendre quadrature via Golub-Welsch (host-side NumPy).

Mirrors ``src/gauss_quad.jl:6-13``: for a requested degree of precision ``p`` the
rule uses ``n = ceil((p + 1) / 2)`` points, obtained from the symmetric eigenvalue
problem of the Jacobi tridiagonal matrix; weights are ``2 * (first eigvec row)^2``.

The reference's ``p = 0`` corner case (empty off-diagonal -> 1x1 zero matrix)
yields the midpoint rule ``([0.0], [2.0])``, which we reproduce.
"""

from __future__ import annotations

import math

import numpy as np


def gauss_quad(p: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and weights on [-1, 1] exact for polynomials of degree ``p``."""
    n = max(int(math.ceil((p + 1) / 2)), 1)
    if n == 1:
        return np.array([0.0]), np.array([2.0])
    k = np.arange(1, n, dtype=np.float64)
    b = k / np.sqrt(4.0 * k * k - 1.0)
    jacobi = np.diag(b, 1) + np.diag(b, -1)
    evals, evecs = np.linalg.eigh(jacobi)
    weights = 2.0 * evecs[0, :] ** 2
    return evals, weights
