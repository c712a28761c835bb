"""Inter-level prolongation builders for the DG-topped chain.

``<coarse>_<fine>_interpolation`` builds the prolongation L mapping the coarse
space into the fine space; restriction is L^T, applied by the solver.  Only
uniform groupings are ported (every level of a power-of-two chain); a ragged
partition raises.
"""

from __future__ import annotations

import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.dg_mesh import DgMesh
from ..numerics import evaluate_nodal_basis
from ..ops.transfer_ops import BlockProlong, block_prolong_constant

_RAGGED = (
    "ragged agglomerates need RaggedBlockProlong, which the torch port does not "
    "have yet (ROADMAP queue 1, item 14)"
)


def dg_dg_interpolation(low: DgMesh, high: DgMesh) -> BlockProlong:
    """Coarse nodal basis at fine nodes, slot order; one constant block."""
    e = evaluate_nodal_basis(low.ref.basis_coeff, high.ref.nodes_x)  # (w_f, w_c)
    return block_prolong_constant(torch.from_numpy(e), high.n_elements)


def _aggdg_dg_blocks_uniform(p: int, r: int, centers, jacs, nodes_x, boxes) -> torch.Tensor:
    """Agglomerate modal basis at the base-element nodes, directly in the
    ``(r, w, bs, m)`` BlockProlong layout."""
    m = boxes.shape[0]
    cen = centers.reshape(m, r).T[None]  # (1, r, m)
    jac = jacs.reshape(m, r).T[None]
    xn = cen + jac * nodes_x[:, None, None]  # (w, r, m)
    phi0 = torch.ones_like(xn)
    if p == 0:
        return phi0.permute(1, 0, 2)[:, :, None, :]
    xc = 0.5 * (boxes[:, 0] + boxes[:, 1])
    h = boxes[:, 1] - boxes[:, 0]
    phi1 = 2.0 * (xn - xc[None, None, :]) / h[None, None, :]
    return torch.stack([phi0, phi1], dim=2).permute(1, 0, 2, 3)  # (r, w, 2, m)


def aggdg_dg_interpolation(agg: AggMesh, base: DgMesh) -> BlockProlong:
    """Modal -> nodal evaluation of the agglomerate basis at base-element nodes."""
    r = agg.uniform_r
    if r is None:
        raise NotImplementedError(_RAGGED)
    t = torch.from_numpy
    return BlockProlong(
        _aggdg_dg_blocks_uniform(
            agg.p, r, t(base.mesh.centers), t(base.mesh.jacobians),
            t(base.ref.nodes_x), t(agg.boxes),
        )
    )


def _aggdg_aggdg_blocks_uniform(p: int, r: int, cb, fb) -> torch.Tensor:
    """Closed-form re-expansion of the coarse modal basis on each fine
    agglomerate, in the ``(r, bs, bs, mc)`` BlockProlong layout: on the fine
    interval ``1 -> 1`` and ``xi_c -> 2(cf - cc)/hc + (hf/hc) xi_f``, which is
    exactly the L2 projection."""
    mc = cb.shape[0]
    if p == 0:
        return torch.ones((r, 1, 1, mc), dtype=cb.dtype, device=cb.device)
    fbr = fb.reshape(mc, r, 2)
    hf = (fbr[:, :, 1] - fbr[:, :, 0]).T  # (r, mc)
    cf = (0.5 * (fbr[:, :, 0] + fbr[:, :, 1])).T
    hc = cb[:, 1] - cb[:, 0]
    cc = 0.5 * (cb[:, 0] + cb[:, 1])
    one = torch.ones_like(hf)
    zero = torch.zeros_like(hf)
    l01 = 2.0 * (cf - cc[None, :]) / hc[None, :]
    l11 = hf / hc[None, :]
    row0 = torch.stack([one, l01], dim=1)  # (r, 2, mc)
    row1 = torch.stack([zero, l11], dim=1)
    return torch.stack([row0, row1], dim=1)  # (r, 2, 2, mc)


def aggdg_aggdg_interpolation(coarse: AggMesh, fine: AggMesh) -> BlockProlong:
    """L2 projection between two agglomerated levels of the same order."""
    if coarse.p != fine.p:
        raise ValueError("the two agglomerated meshes must have the same p")
    r, rf = coarse.sub_uniform_r, fine.uniform_r
    if r is None or rf is None:
        raise NotImplementedError(_RAGGED)
    return BlockProlong(
        _aggdg_aggdg_blocks_uniform(
            coarse.p, r, torch.from_numpy(coarse.boxes), torch.from_numpy(fine.boxes)
        )
    )
