"""Assembled CG operators: overlapping element windows + scalar DIA band.

With the spatially sorted ("grid-order") CG node numbering — element ``k`` of
order ``p`` owns nodes ``k*p .. k*p + p``, sharing endpoints with its
neighbours — every CG operator is a scalar banded matrix of bandwidth ``p``.
Two coupled representations are kept:

* ``windows``: the unassembled per-element ``(p+1) x (p+1)`` contributions,
  ``(w, w, n_el)``.  Galerkin coarsening and assembly read these.
* ``band``: the assembled DIA band ``(2p+1, n_nodes)`` with
  ``band[off + p, i] = A[i, i + off]``.  Matvecs, diagonals and Schwarz blocks
  read this; a matvec is ``2p+1`` shifted multiply-adds.

Strong-Dirichlet row/col surgery is folded into the windows of the boundary
element that owns each Dirichlet node (``assembly.cg_assembly``); a 1D domain
boundary node belongs to exactly one element, so the folded assembly equals
post-assembly surgery exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .shifts import shift


class CgOperator(NamedTuple):
    windows: torch.Tensor  # (w, w, n_el), w = p + 1, position (left-to-right) order
    band: torch.Tensor  # (2p+1, n_nodes)

    @property
    def p(self) -> int:
        return self.windows.shape[0] - 1

    @property
    def n_el(self) -> int:
        return self.windows.shape[2]

    @property
    def n_nodes(self) -> int:
        return self.n_el * self.p + 1


def cg_element_nodes(p: int, n_el: int, device) -> torch.Tensor:
    """``idx[a, k] = k * p + a``: the grid nodes of element ``k``, ``(p+1, n_el)``."""
    return p * torch.arange(n_el, device=device)[None, :] + torch.arange(p + 1, device=device)[:, None]


def assemble_band(windows: torch.Tensor) -> torch.Tensor:
    """Scatter-add element windows ``(w, w, n_el)`` into the DIA band."""
    w = windows.shape[0]
    p = w - 1
    n_el = windows.shape[2]
    band = torch.zeros((2 * p + 1, n_el * p + 1), dtype=windows.dtype, device=windows.device)
    starts = p * torch.arange(n_el, device=windows.device)
    for a in range(w):
        for b in range(w):
            band[b - a + p].index_add_(0, starts + a, windows[a, b, :])
    return band


def cg_from_windows(windows: torch.Tensor) -> CgOperator:
    return CgOperator(windows=windows, band=assemble_band(windows))


def cg_matvec(a: CgOperator, x: torch.Tensor, halo: tuple | None = None) -> torch.Tensor:
    """``y[i] = sum_off band[off + p, i] * x[i + off]`` for x of shape
    ``(n_nodes,)``.  ``halo``, on a shard: ``(left, right)``, the ``p`` nodes
    before the shard's first and after its last (the neighbours'); zeros by
    default."""
    p = a.p
    if halo is None:
        shifted = lambda off: shift(x, off)  # noqa: E731
    else:
        ext, n = torch.cat([halo[0], x, halo[1]]), x.shape[0]
        shifted = lambda off: ext[p + off : p + off + n]  # noqa: E731
    y = a.band[p] * x
    for off in range(1, p + 1):
        y = y + a.band[off + p] * shifted(off)
        y = y + a.band[-off + p] * shifted(-off)
    return y


def cg_diagonal(a: CgOperator) -> torch.Tensor:
    return a.band[a.p]


def cg_assembled_windows(a: CgOperator) -> torch.Tensor:
    """Windows of the *assembled* matrix: ``W[a, b, k] = A[k p + a, k p + b]``,
    which include the neighbour-element contributions at the shared endpoints
    (the blocks the Schwarz smoothers invert)."""
    p, w, n_el = a.p, a.p + 1, a.n_el
    starts = p * torch.arange(n_el, device=a.band.device)
    out = torch.empty((w, w, n_el), dtype=a.band.dtype, device=a.band.device)
    for aa in range(w):
        for bb in range(w):
            out[aa, bb] = a.band[bb - aa + p, starts + aa]
    return out


def cg_to_dense(a: CgOperator) -> torch.Tensor:
    """Materialize dense (tests / coarse solves only)."""
    p, n = a.p, a.n_nodes
    dense = torch.zeros((n, n), dtype=a.band.dtype, device=a.band.device)
    idx = torch.arange(n, device=a.band.device)
    for off in range(-p, p + 1):
        rows = idx[max(0, -off) : n - max(0, off)]
        dense[rows, rows + off] = a.band[off + p, rows]
    return dense


def cg_node_multiplicity(p: int, n_el: int, dtype=torch.float64, *, device) -> torch.Tensor:
    """How many elements contain each grid node (2 at interior vertices, else 1)."""
    mult = torch.ones((n_el * p + 1,), dtype=dtype, device=device)
    if n_el > 1:
        mult[p * torch.arange(1, n_el, device=device)] += 1.0
    return mult
