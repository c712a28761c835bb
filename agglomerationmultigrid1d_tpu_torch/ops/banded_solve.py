"""Host-side banded direct solve of a block-tridiagonal fine operator, for the
error history of :func:`..models.solvers.multigrid` (the reference's
``u_exact = A \\ b``).  A block-tridiagonal operator with block size ``bs`` is
scalar-banded with bandwidth ``2 bs - 1``, so this is LAPACK ``dgbsv`` through
``scipy.linalg.solve_banded``: O(n bs^2) time.  Observability only, never on
the solve path.
"""

from __future__ import annotations

import numpy as np

from .block_tridiag import BlockTridiag


def bt_banded_ab(a: BlockTridiag) -> tuple[int, np.ndarray]:
    """LAPACK banded storage of the flattened operator (scalar row ``k * bs + i``)."""
    bs, n = a.block_size, a.n_blocks
    u = 2 * bs - 1
    ab = np.zeros((2 * u + 1, n * bs))
    to_np = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    mats = {
        0: (to_np(a.diag), np.arange(n)),
        -1: (to_np(a.lower)[:, :, 1:], np.arange(1, n)),
        1: (to_np(a.upper)[:, :, :-1], np.arange(n - 1)),
    }
    for d, (mat, ks) in mats.items():
        for i in range(bs):
            for j in range(bs):
                cols = (ks + d) * bs + j
                ab[u - d * bs + i - j, cols] = mat[i, j, :]
    return u, ab


def fine_direct_solve(level, b_flat: np.ndarray) -> np.ndarray:
    """``A^-1 b`` for a block level's operator; ``b_flat`` is the flattened
    DoF vector."""
    from scipy.linalg import solve_banded

    u, ab = bt_banded_ab(level.a)
    return solve_banded((u, u), ab, np.asarray(b_flat, dtype=np.float64))
