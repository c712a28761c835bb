"""Transfers to and from scattered (non-contiguous) agglomeration levels.

The prolongation from a scattered level is *one dense block per fine
element*: fine element ``e`` reads only its owner agglomerate ``cols[e]``.
That makes prolongation one gather and one broadcast block product,
restriction the row sums of ``ops.block_coo`` over each agglomerate's fine
elements (its ``members`` table, in element order), and the Galerkin
projection a re-keying of the fine operator's entries:

    (P^T B P)[cols[r], cols[c]]  +=  P_r^T  B[r, c]  P_c

for every block entry ``(r, c)`` of the fine operator (host NumPy, setup
only).  The constructors follow the contiguous interpolations: modal -> nodal
evaluation onto a DG base, and the exact linear-in-linear re-expansion
between agglomeration levels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mesh.dg_mesh import DgMesh
from ..mesh.scattered_agg import ScatteredAggMesh
from ..numerics import modal_basis_vals_batched
from ..ops.block_coo import (
    BlockCOO,
    _bt_entries,
    _contract,
    _host,
    _np,
    _to,
    bcoo_coalesce,
    entry_table,
    row_sums,
)
from ..ops.block_tridiag import BlockTridiag


class ScatteredProlong(NamedTuple):
    """Per-fine-element dense blocks into an arbitrary owner map."""

    cols: torch.Tensor  # (n_f,) int64 owner agglomerate of each fine element
    blocks: torch.Tensor  # (bs_f, bs_c, n_f)
    n_coarse: int  # coarse block count
    members: torch.Tensor  # (n_coarse, K) each agglomerate's fine elements, padded with n_f

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_fine(self) -> int:
        return self.blocks.shape[2]


def sp_prolong(l: ScatteredProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs_c, n_c) -> (bs_f, n_f)``."""
    return _contract(l.blocks, xc[:, l.cols])


def sp_restrict(l: ScatteredProlong, rf: torch.Tensor) -> torch.Tensor:
    """``P^T r``: ``(bs_f, n_f) -> (bs_c, n_c)``."""
    return row_sums(_contract(l.blocks.transpose(0, 1), rf), l.members)


def scattered_prolong(cols, blocks, n_coarse: int, device) -> ScatteredProlong:
    """A ScatteredProlong from a host owner array and blocks (a NumPy array
    or a tensor), with its ``members`` table, on ``device``."""
    cols = np.asarray(cols, dtype=np.int64)
    return ScatteredProlong(cols=_to(cols, device), blocks=_to(blocks, device), n_coarse=int(n_coarse),
                            members=_to(entry_table(cols, n_coarse), device))


def scattered_dg_interpolation(sa: ScatteredAggMesh, base: DgMesh) -> ScatteredProlong:
    """Modal -> nodal: the owner agglomerate's basis at each base element's
    nodes (the scattered counterpart of ``aggdg_dg_interpolation``)."""
    centers, jacs = base.mesh.centers, base.mesh.jacobians
    xn = centers[:, None] + jacs[:, None] * np.asarray(base.ref.nodes_x)[None, :]
    per_el = modal_basis_vals_batched(sa.p, sa.boxes[sa.assign], xn)  # (n, w, bs)
    return scattered_prolong(sa.assign, np.moveaxis(per_el, 0, -1), sa.n_agg, "cpu")


def scattered_scattered_interpolation(coarse: ScatteredAggMesh, fine) -> ScatteredProlong:
    """Exact re-expansion of the coarse modal basis in each fine
    agglomerate's (both linear):

        1                  = phi_f0
        2 (x - Xc) / H     = (h_f / H) phi_f1 + (2 (xc_f - Xc) / H) phi_f0

    ``fine`` is a scattered or a contiguous agglomerated level."""
    if coarse.p != fine.p:
        raise ValueError("the two agglomerated meshes must have the same p")
    owner = coarse.sub_assign  # (n_fine_agg,)
    if owner.shape[0] != fine.n_agg:
        raise ValueError(
            "coarse.sub_assign does not index the fine level — build the "
            "coarse mesh with coarsen_scattered_agg_mesh(fine, groups)"
        )
    nf = fine.n_agg
    if coarse.p == 0:
        blocks = np.ones((1, 1, nf))
    else:
        hf = fine.boxes[:, 1] - fine.boxes[:, 0]
        cf = 0.5 * (fine.boxes[:, 0] + fine.boxes[:, 1])
        hc = (coarse.boxes[:, 1] - coarse.boxes[:, 0])[owner]
        cc = (0.5 * (coarse.boxes[:, 0] + coarse.boxes[:, 1]))[owner]
        blocks = np.zeros((2, 2, nf))
        blocks[0, 0] = 1.0
        blocks[0, 1] = 2.0 * (cf - cc) / hc
        blocks[1, 1] = hf / hc
    return scattered_prolong(owner, blocks, coarse.n_agg, "cpu")


def scattered_galerkin(l: ScatteredProlong, b) -> BlockCOO:
    """``P^T B P`` for ``B`` block-tridiagonal or block-COO over the fine
    blocks: every fine entry ``(r, c)`` re-keyed to ``(cols[r], cols[c])``
    with the two-sided block sandwich, then coalesced (host, setup only).
    The result lies on ``l``'s device."""
    cols = _np(l.cols).astype(np.int64)
    pb = _np(l.blocks)  # (bs_f, bs_c, n_f)
    if isinstance(b, BlockTridiag):
        rows_f, cols_f, blocks_f = _bt_entries(b)
    elif isinstance(b, BlockCOO):
        rows_f, cols_f, blocks_f = _host(b)
    else:
        raise TypeError(type(b))
    # P_r^T B[r, c] P_c, batched over the fine entries (one three-operand
    # sum, the JAX package's order of operations)
    sandw = np.einsum("abt,bct,cdt->adt", pb[:, :, rows_f].transpose(1, 0, 2), blocks_f, pb[:, :, cols_f])
    return bcoo_coalesce(cols[rows_f], cols[cols_f], sandw, l.n_coarse, l.n_coarse, device=l.blocks.device)
