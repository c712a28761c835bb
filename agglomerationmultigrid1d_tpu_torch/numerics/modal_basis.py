"""Local modal basis for agglomerated-DG elements (host-side NumPy).

Mirrors ``src/agglomerated_dg_mesh.jl:297-327``: on an agglomerate with bounding
box [x0, x1] the basis is phi_0 = 1 and (for p = 1) phi_1 = 2 (x - xc) / h with
xc = (x0 + x1)/2, h = x1 - x0.  Only p in {0, 1} exists, as in the reference.
"""

from __future__ import annotations

import numpy as np


def modal_basis_vals(p: int, box: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Basis values at points ``x``; shape ``(len(x), p + 1)``.

    ``box`` is ``(2,)`` (single box) or broadcastable against ``x``'s leading axes.
    """
    x = np.asarray(x, dtype=np.float64)
    if p == 0:
        return np.ones(x.shape + (1,))
    if p == 1:
        x0, x1 = np.asarray(box, dtype=np.float64)
        xc = 0.5 * (x0 + x1)
        h = x1 - x0
        out = np.empty(x.shape + (2,))
        out[..., 0] = 1.0
        out[..., 1] = 2.0 * (x - xc) / h
        return out
    raise ValueError("agglomerated modal basis only implemented for p = 0 and p = 1")


def modal_basis_vals_batched(p: int, boxes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Basis values for a whole batch of agglomerates at once.

    ``boxes`` is ``(m, 2)``; ``x`` is ``(m, ...)`` points inside agglomerate m.
    Returns ``(m, ..., p + 1)``.  Replaces an m-long Python loop over
    :func:`modal_basis_vals` in mesh/transfer setup (hot at 10^6 elements).
    """
    x = np.asarray(x, dtype=np.float64)
    if p == 0:
        return np.ones(x.shape + (1,))
    if p == 1:
        boxes = np.asarray(boxes, dtype=np.float64)
        bshape = (boxes.shape[0],) + (1,) * (x.ndim - 1)
        xc = (0.5 * (boxes[:, 0] + boxes[:, 1])).reshape(bshape)
        h = (boxes[:, 1] - boxes[:, 0]).reshape(bshape)
        out = np.empty(x.shape + (2,))
        out[..., 0] = 1.0
        out[..., 1] = 2.0 * (x - xc) / h
        return out
    raise ValueError("agglomerated modal basis only implemented for p = 0 and p = 1")


def modal_basis_derivs(p: int, box: np.ndarray) -> np.ndarray:
    """Constant basis derivatives; shape ``(p + 1,)``."""
    if p == 0:
        return np.array([0.0])
    if p == 1:
        x0, x1 = np.asarray(box, dtype=np.float64)
        return np.array([0.0, 2.0 / (x1 - x0)])
    raise ValueError("agglomerated modal basis only implemented for p = 0 and p = 1")
