"""Host-side banded direct solve of a fine operator, for the error history of
:func:`..models.solvers.multigrid` (the reference's ``u_exact = A \\ b``).
Every fine operator is scalar-banded — a CG DIA band of bandwidth ``p``,
block-tridiagonal with block size ``bs`` (bandwidth ``2 bs - 1``) or
block-pentadiagonal (bandwidth ``3 bs - 1``) — so this is
LAPACK ``dgbsv`` through ``scipy.linalg.solve_banded``: O(n b^2) time.
:func:`fine_refined_solve` adds the operator's condition estimate and a
solution refined in extended precision, the witness for how far two float64
solutions may differ.  Observability only, never on the solve path.
"""

from __future__ import annotations

import numpy as np

from .block_penta import BlockPenta
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


def bp5_banded_ab(a: BlockPenta) -> tuple[int, np.ndarray]:
    """LAPACK banded storage of a flattened block-pentadiagonal operator."""
    bs, n = a.block_size, a.n_blocks
    u = 3 * bs - 1
    ab = np.zeros((2 * u + 1, n * bs))
    for d, mat in zip((-2, -1, 0, 1, 2), a):
        m = _host(mat)
        ks = np.arange(max(0, -d), n - max(0, d))
        for i in range(bs):
            for j in range(bs):
                cols = (ks + d) * bs + j
                ab[u - d * bs + i - j, cols] = m[i, j, ks]
    return u, ab


REFINE_STEPS = 6  # corrections after the first solve; ~2 suffice at cond_1 * eps = 2e-3


def fine_banded_ab(level) -> tuple[int, np.ndarray]:
    """``(u, ab)``: LAPACK banded storage of a CG, block-tridiagonal or
    block-pentadiagonal level's operator, ``u`` sub- and super-diagonals."""
    op = level.a
    if isinstance(op, CgOperator):
        return cg_banded_ab(op)
    if isinstance(op, BlockTridiag):
        return bt_banded_ab(op)
    if isinstance(op, BlockPenta):
        return bp5_banded_ab(op)
    raise TypeError(f"unknown operator type {type(op)}")


def banded_solve(u: int, ab: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``A^-1 b`` from LAPACK banded storage with ``u`` sub- and super-diagonals."""
    from scipy.linalg import solve_banded

    return solve_banded((u, u), ab, b)


def fine_direct_solve(level, b_flat: np.ndarray) -> np.ndarray:
    """``A^-1 b`` for a CG, block-tridiagonal or block-pentadiagonal level's
    operator; ``b_flat`` is the flattened DoF vector."""
    u, ab = fine_banded_ab(level)
    return banded_solve(u, ab, np.asarray(b_flat, dtype=np.float64))


def _banded_matvec(u: int, ab: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``A x`` from banded storage, in ``x``'s dtype."""
    n = ab.shape[1]
    y = np.zeros_like(x)
    for r in range(2 * u + 1):
        off = r - u  # ab[r, j] = A[j + off, j]
        if off >= 0:
            y[off:] += ab[r, : n - off] * x[: n - off]
        else:
            y[: n + off] += ab[r, -off:] * x[-off:]
    return y


def _inv_norm1_estimate(solve, n: int) -> float:
    """Hager's estimate of ``||A^-1||_1`` with Higham's extra test vector,
    the estimator of LAPACK's ``gbcon`` (``dlacn2``); ``solve(r, trans)``
    applies ``A^-1`` (``trans=1``: ``A^-T``).  A lower bound, in practice
    within a small factor."""
    x = np.full(n, 1.0 / n)
    est = 0.0
    for k in range(5):
        y = solve(x)
        est = max(est, float(np.abs(y).sum()))
        z = solve(np.where(y >= 0, 1.0, -1.0), 1)
        j = int(np.argmax(np.abs(z)))
        if k and abs(z[j]) <= float(z @ x):
            break
        x = np.zeros(n)
        x[j] = 1.0
    alt = (-1.0) ** np.arange(n) * (1.0 + np.arange(n) / max(n - 1, 1))
    return max(est, 2.0 * float(np.abs(solve(alt)).sum()) / (3.0 * n))


def fine_refined_solve(level, b_flat: np.ndarray) -> tuple[float, np.ndarray, float]:
    """``(cond_1, x, last)``: an estimate of the 1-norm condition number of a
    level's operator (:func:`_inv_norm1_estimate` of ``||A^-1||_1`` through
    its banded LU factors, times ``||A||_1``), ``A^-1 b`` refined
    ``REFINE_STEPS`` times with residuals computed in ``np.longdouble``, and
    ``last``, the final correction's max over max|x|.  A float64 solve is
    accurate to about ``cond_1 * eps``; the refined ``x`` (returned in
    ``np.longdouble``) converges, to about ``cond_1 * eps_longdouble``,
    while ``cond_1 * eps < 1``, so it tells which of two float64 solutions
    is the accurate one."""
    from scipy.linalg import lapack

    u, ab = fine_banded_ab(level)
    n = ab.shape[1]
    lu, piv, info = lapack.dgbtrf(np.concatenate([np.zeros((u, n)), ab]), u, u)
    if info:
        raise np.linalg.LinAlgError(f"dgbtrf: info {info}")

    def solve(r, trans=0):
        return lapack.dgbtrs(lu, u, u, np.asarray(r, dtype=np.float64).reshape(n, -1), piv, trans=trans)[0][:, 0]

    cond = float(np.abs(ab).sum(axis=0).max()) * _inv_norm1_estimate(solve, n)
    ab_ld, b = ab.astype(np.longdouble), np.asarray(b_flat, dtype=np.longdouble)
    x = np.zeros_like(b)
    for _ in range(REFINE_STEPS + 1):
        dx = solve((b - _banded_matvec(u, ab_ld, x)).astype(np.float64)).astype(np.longdouble)
        x = x + dx
    return cond, x, float(np.abs(dx).max() / np.abs(x).max())
