"""Coarsest-level direct solve: an explicit dense inverse, factorized on the
host at setup, plus one iterative-refinement step at solve time.

Block cyclic reduction for large coarsest levels is not ported; the slice's
coarsest level is far below ``hierarchy.DENSE_COARSE_MAX``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CoarseSolver(NamedTuple):
    a_dense: torch.Tensor  # (n, n)
    a_inv: torch.Tensor  # (n, n) host-computed inverse

    @property
    def n(self) -> int:
        return self.a_dense.shape[0]


def make_coarse_solver(a_dense: torch.Tensor) -> CoarseSolver:
    """The inverse is taken with NumPy's LAPACK in f64 on the host, the same
    routine the JAX package uses, so both packages hold the same inverse."""
    inv = np.linalg.inv(a_dense.detach().cpu().numpy())
    return CoarseSolver(a_dense=a_dense, a_inv=torch.from_numpy(inv).to(a_dense.device))


def coarse_solve(f: CoarseSolver, b: torch.Tensor) -> torch.Tensor:
    """``A^-1 b`` with one iterative-refinement correction."""
    x = f.a_inv @ b
    r = b - f.a_dense @ x
    return x + f.a_inv @ r
