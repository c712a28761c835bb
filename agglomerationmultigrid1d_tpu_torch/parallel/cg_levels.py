"""CG levels on a shard: the matvec, the smoothers and the CG and seam
transfers of a CG level sharded by ``parallel.distributed.shard_hierarchy``.

The layout (``multihost.node_range``): rank ``r`` of ``W`` owns the elements
``[r n_el / W, (r + 1) n_el / W)`` and the nodes ``[r m, (r + 1) m)``,
``m = n_el p / W``; the last rank also owns node ``n_el p``.  Its element
windows (``CgOperator.windows``, Schwarz ``inv_windows``, seam ``n_win``)
cover its own nodes and one more, the vertex its last element shares with
the next rank, which that rank owns.  So:

* the matvec reads ``p`` halo nodes a side (:func:`cg_matvec_sharded`);
* what reads an element's nodes (a Schwarz window, a restriction's window,
  a prolongation's coarse window) takes the shared vertex from its owner
  first (``halo.with_right_vertex``);
* what scatter-adds into an element's nodes (a Schwarz window, a
  restriction, the seam's prolongation) sends its part of the shared vertex
  back to the owner, who adds it after its own (``halo.fold_right_vertex``),
  so every node is summed in the order of the whole level;
* the CG prolongation writes the shared vertex from the left element, as the
  whole level does (``halo.take_left_vertex``).

Every function returns the rank's own nodes (or coarse columns), and equals
the same nodes of the unsharded function bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.cg_operator import CgOperator, cg_matvec
from ..ops.transfer_ops import CgProlong, SeamProlong, cgp_prolong, cgp_restrict_windows, seam_gather, seam_scatter
from ..smoothers.smoother import SchwarzSmoother, apply_smoother, schwarz_windows
from .halo import edge_columns, fold_right_vertex, take_left_vertex, with_right_vertex
from .multihost import SolverGroup


def cg_matvec_sharded(a: CgOperator, x: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """``A x`` on the rank's nodes, with the neighbours' ``p`` edge nodes."""
    return cg_matvec(a, x, edge_columns(x, g, width=a.p))


def apply_smoother_sharded(s, r: torch.Tensor, alpha: float, g: SolverGroup) -> torch.Tensor:
    """``alpha S r`` on the rank's nodes: a Schwarz smoother's windows read
    the shared vertex and add their part of it back to its owner; a Jacobi
    (or block-Jacobi) smoother is local."""
    if not isinstance(s, SchwarzSmoother):
        return apply_smoother(s, r, alpha)
    y = fold_right_vertex(schwarz_windows(s, with_right_vertex(r, g)), g)
    if s.mult_inv is not None:
        y = y * s.mult_inv
    return alpha * y


def cgp_prolong_sharded(l: CgProlong, xc: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The CG prolongation from the rank's coarse nodes to its fine nodes."""
    return take_left_vertex(cgp_prolong(l, with_right_vertex(xc, g)), g)


def cgp_restrict_sharded(l: CgProlong, rf: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """``L^T rf`` from the rank's fine nodes to its coarse nodes."""
    rc = cgp_restrict_windows(l, with_right_vertex(rf, g))
    if g.rank == 0:
        rc[0] += rf[0]
    return fold_right_vertex(rc, g)


def seam_prolong_sharded(l: SeamProlong, xc: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The seam's prolongation from the rank's coarse columns to its CG
    nodes (``l`` holds the rank's coarse columns and its nodes' ``inv_lump``)."""
    n_ext = l.n_coarse * l.r * (l.w_cg - 1) + 1
    return l.inv_lump * fold_right_vertex(seam_scatter(l, xc, n_ext), g)


def seam_restrict_sharded(l: SeamProlong, rf: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """``L^T rf`` from the rank's CG nodes to its coarse columns."""
    return seam_gather(l, with_right_vertex(l.inv_lump * rf, g))
