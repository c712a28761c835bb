"""Agglomerated-DG flux operator assembly, for the CG -> agglomerated seam of
a CG-topped hierarchy (the only place an agglomerated level assembles its own
operators; below DG or agglomerated levels they are Galerkin products).

The flux scheme is the DG level's, but the vertex terms are rank-1 outer
products of the agglomerates' boundary modal-basis values.  On the lite mesh
everything is closed form: the modal basis {1, 2(x - xc)/h} has boundary
values (1, -1) on the left and (1, 1) on the right, derivatives (0, 2/h), and
integrates to (h, 0).  An explicit switch mirrors the couplings at its
flipped vertices, as on the DG level.  Assembled on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.topology import BoundaryCondition
from ..ops.block_tridiag import BlockTridiag


def _closed_form_traces(agg: AggMesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(deriv_vals, bd_left, bd_right)``, each ``(m, p+1)``."""
    m, p = agg.n_agg, agg.p
    bd_left = np.ones((m, p + 1))
    bd_right = np.ones((m, p + 1))
    if p == 0:
        return np.zeros((m, 1)), bd_left, bd_right
    bd_left[:, 1] = -1.0
    h = agg.boxes[:, 1] - agg.boxes[:, 0]
    return np.stack([np.zeros(m), 2.0 / h], axis=1), bd_left, bd_right


def agg_flux_operators(
    agg: AggMesh, bc: BoundaryCondition, c_dir: float
) -> tuple[BlockTridiag, BlockTridiag, BlockTridiag]:
    """(G, D, C) over agglomerates, in one vectorised O(m) host pass."""
    m = agg.n_agg
    bs = agg.block_size
    deriv_vals, bl, br = _closed_form_traces(agg)

    # volume: temp[i, j] = deriv_i * integral of phi_j over the agglomerate
    q = np.zeros((m, bs))
    q[:, 0] = agg.boxes[:, 1] - agg.boxes[:, 0]
    vol = np.einsum("ci,cj->ijc", deriv_vals, q)  # (bs, bs, m)

    g_diag = vol.copy()
    d_diag = vol.copy()
    g_lower = np.zeros((bs, bs, m))
    g_upper = np.zeros((bs, bs, m))
    d_lower = np.zeros((bs, bs, m))
    d_upper = np.zeros((bs, bs, m))
    c_diag = np.zeros((bs, bs, m))

    # interior vertex between agglomerates c (left) and c+1 (right): u-hat is
    # the left agglomerate's right trace, q-hat the right one's left trace;
    # at a flipped vertex of an explicit switch the couplings are mirrored
    if m > 1:
        sw = np.ones(m - 1) if agg.u_hat_left is None else np.asarray(agg.u_hat_left, dtype=np.float64)
        fl = 1.0 - sw
        g_lower[:, :, 1:] += sw * np.einsum("ci,cj->ijc", bl[1:], br[:-1])
        g_diag[:, :, :-1] -= sw * np.einsum("ci,cj->ijc", br[:-1], br[:-1])
        d_diag[:, :, 1:] += sw * np.einsum("ci,cj->ijc", bl[1:], bl[1:])
        d_upper[:, :, :-1] -= sw * np.einsum("ci,cj->ijc", br[:-1], bl[1:])
        if agg.u_hat_left is not None:
            g_diag[:, :, 1:] += fl * np.einsum("ci,cj->ijc", bl[1:], bl[1:])
            g_upper[:, :, :-1] -= fl * np.einsum("ci,cj->ijc", br[:-1], bl[1:])
            d_diag[:, :, :-1] -= fl * np.einsum("ci,cj->ijc", br[:-1], br[:-1])
            d_lower[:, :, 1:] += fl * np.einsum("ci,cj->ijc", bl[1:], br[:-1])

    bl0 = np.outer(bl[0], bl[0])
    brn = np.outer(br[-1], br[-1])
    if bc.dir_left:
        d_diag[:, :, 0] += bl0
        c_diag[:, :, 0] += c_dir * bl0
    elif bc.neu_left:
        g_diag[:, :, 0] += bl0
    if bc.dir_right:
        d_diag[:, :, -1] -= brn
        c_diag[:, :, -1] += c_dir * brn
    elif bc.neu_right:
        g_diag[:, :, -1] -= brn

    t = torch.from_numpy
    zero = torch.zeros((bs, bs, m), dtype=torch.float64)
    g = BlockTridiag(lower=t(g_lower), diag=t(g_diag), upper=t(g_upper))
    d = BlockTridiag(lower=t(d_lower), diag=t(d_diag), upper=t(d_upper))
    c = BlockTridiag(lower=zero, diag=t(c_diag), upper=zero)
    return g, d, c
