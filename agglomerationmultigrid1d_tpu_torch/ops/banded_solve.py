"""Host-side banded direct solve of a fine operator, for the error history of
:func:`..models.solvers.multigrid` (the reference's ``u_exact = A \\ b``).
Every fine operator is scalar-banded — a CG DIA band of bandwidth ``p``, or
block-tridiagonal with block size ``bs``, bandwidth ``2 bs - 1`` — so this is
LAPACK ``dgbsv`` through ``scipy.linalg.solve_banded``: O(n b^2) time.
Observability only, never on the solve path.
"""

from __future__ import annotations

import numpy as np

from .block_tridiag import BlockTridiag
from .cg_operator import CgOperator


def _host(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def cg_banded_ab(a: CgOperator) -> tuple[int, np.ndarray]:
    """LAPACK banded storage ``ab[p + i - j, j] = A[i, j]`` from the DIA band."""
    band = _host(a.band)
    p, n = a.p, a.n_nodes
    ab = np.zeros((2 * p + 1, n))
    for off in range(-p, p + 1):
        # band[off + p, i] = A[i, i + off]  ->  ab[p - off, j] for j = i + off
        i = np.arange(max(0, -off), n - max(0, off))
        ab[p - off, i + off] = band[off + p, i]
    return p, ab


def bt_banded_ab(a: BlockTridiag) -> tuple[int, np.ndarray]:
    """LAPACK banded storage of the flattened operator (scalar row ``k * bs + i``)."""
    bs, n = a.block_size, a.n_blocks
    u = 2 * bs - 1
    ab = np.zeros((2 * u + 1, n * bs))
    mats = {
        0: (_host(a.diag), np.arange(n)),
        -1: (_host(a.lower)[:, :, 1:], np.arange(1, n)),
        1: (_host(a.upper)[:, :, :-1], np.arange(n - 1)),
    }
    for d, (mat, ks) in mats.items():
        for i in range(bs):
            for j in range(bs):
                cols = (ks + d) * bs + j
                ab[u - d * bs + i - j, cols] = mat[i, j, :]
    return u, ab


def fine_direct_solve(level, b_flat: np.ndarray) -> np.ndarray:
    """``A^-1 b`` for a CG or block level's operator; ``b_flat`` is the
    flattened DoF vector."""
    from scipy.linalg import solve_banded

    u, ab = cg_banded_ab(level.a) if isinstance(level.a, CgOperator) else bt_banded_ab(level.a)
    return solve_banded((u, u), ab, np.asarray(b_flat, dtype=np.float64))
