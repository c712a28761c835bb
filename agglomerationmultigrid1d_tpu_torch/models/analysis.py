"""Smoother analysis mirroring the reference's smoother studies
(``cg_smoother_test.jl:83-126``, ``dg_smoother_test.jl:105-116``): the dense
smoother iteration matrix ``E = I - alpha S A``, its spectrum, and the
damping of sine error modes.  Dense linear algebra in float64 NumPy on the
host, from a level on any device; analysis only, at small sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.block_tridiag import bt_to_dense
from ..ops.cg_operator import cg_to_dense
from ..smoothers.smoother import apply_smoother
from .hierarchy import CgLevel


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def level_dense_operator(level) -> np.ndarray:
    """The level's operator as a dense float64 matrix (a block level's
    unknowns in element-major order, ``k * bs + i``)."""
    return _host(cg_to_dense(level.a) if isinstance(level, CgLevel) else bt_to_dense(level.a))


def smoother_dense_matrix(level) -> np.ndarray:
    """S, materialized by applying the smoother to each unit vector."""
    n = level_dense_operator(level).shape[0]
    like = level.a.band if isinstance(level, CgLevel) else level.a.diag
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    cols = []
    for i in range(n):
        e = eye[i] if isinstance(level, CgLevel) else eye[i].reshape(-1, level.a.block_size).T
        y = apply_smoother(level.smoother, e)
        cols.append(_host(y if isinstance(level, CgLevel) else y.T.reshape(-1)))
    return np.stack(cols, axis=1)


def smoother_iteration_matrix(level, alpha: float = 2.0 / 3.0) -> np.ndarray:
    """``E = I - alpha S A`` (cf. ``cg_smoother_test.jl:111-117``)."""
    a = level_dense_operator(level)
    return np.eye(a.shape[0]) - alpha * smoother_dense_matrix(level) @ a


def smoother_spectrum(level, alpha: float = 2.0 / 3.0) -> np.ndarray:
    """Eigenvalues of the smoother iteration matrix, largest magnitude first."""
    ev = np.linalg.eigvals(smoother_iteration_matrix(level, alpha))
    return ev[np.argsort(-np.abs(ev))]


def mode_damping(level, modes: int = 10, sweeps: int = 10, alpha: float = 2.0 / 3.0) -> np.ndarray:
    """``||E^sweeps v_i|| / ||v_i||`` for the error modes ``v_i = sin(i pi x)``,
    ``i = 1 .. modes``, after ``sweeps`` damped smoother applications
    (cf. ``cg_smoother_test.jl:83-109``)."""
    e_mat = smoother_iteration_matrix(level, alpha)
    x = np.linspace(0.0, 1.0, e_mat.shape[0])
    out = np.empty(modes)
    for i in range(1, modes + 1):
        v = np.sin(i * np.pi * x)
        w = v.copy()
        for _ in range(sweeps):
            w = e_mat @ w
        out[i - 1] = np.linalg.norm(w) / np.linalg.norm(v)
    return out
