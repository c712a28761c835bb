"""Inter-level prolongation constructors.

``<coarse>_<fine>_interpolation`` builds the prolongation L mapping the coarse
space into the fine space; restriction is L^T, applied by the solver.  Only
uniform groupings are ported (every level of a power-of-two chain); a ragged
partition raises.  Built on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.cg_mesh import CgMesh
from ..mesh.dg_mesh import DgMesh
from ..numerics import evaluate_nodal_basis, gauss_quad, modal_basis_vals_batched
from ..ops.transfer_ops import BlockProlong, CgProlong, SeamProlong, block_prolong_constant

_RAGGED = (
    "ragged agglomerates need RaggedBlockProlong, which the torch port does not "
    "have yet (ROADMAP queue 1, item 14)"
)


def cg_cg_interpolation(low: CgMesh, high: CgMesh) -> CgProlong:
    """Coarse (low-order) nodal basis evaluated at fine nodes, grid order."""
    x_fine_pos = high.ref.nodes_x[high.ref.pos_to_slot]
    e_slotcols = evaluate_nodal_basis(low.ref.basis_coeff, x_fine_pos)  # (w_f, w_c slots)
    return CgProlong(e=torch.from_numpy(np.ascontiguousarray(e_slotcols[:, low.ref.pos_to_slot])))


def dg_cg_interpolation(low: DgMesh, high: CgMesh) -> SeamProlong:
    """Lumped-mass-scaled L2 projection of the DG space into the CG space (the
    hierarchy's seam, ``interp_flag = 1`` of the reference)."""
    qx, qw = gauss_quad(low.p + high.p)
    cg_b = evaluate_nodal_basis(high.ref.basis_coeff, qx)[:, high.ref.pos_to_slot]
    dg_b = evaluate_nodal_basis(low.ref.basis_coeff, qx)  # (n_q, bs) slot order
    n_ref = torch.from_numpy(np.einsum("l,la,lm->am", qw, cg_b, dg_b))  # (w_cg, bs)
    n_win = n_ref[:, :, None, None] * torch.from_numpy(high.mesh.jacobians)
    return SeamProlong(n_win=n_win, inv_lump=1.0 / high.lumped_mass)


def aggdg_cg_interpolation(agg: AggMesh, base: CgMesh) -> SeamProlong:
    """Lumped-mass-scaled L2 projection of the agglomerate modal basis into the
    base CG space, integrated base element by base element (``interp_flag =
    1`` of the reference)."""
    r = agg.uniform_r
    if r is None:
        raise NotImplementedError(_RAGGED)
    m = agg.n_agg
    ref = base.ref
    centers = base.mesh.centers.reshape(m, r)
    jacs = base.mesh.jacobians.reshape(m, r)
    xq = centers[:, :, None] + jacs[:, :, None] * ref.quad_nodes[None, None, :]
    cg_b = ref.basis_at_quad[:, ref.pos_to_slot]  # (n_q, w_cg) position order
    agg_b = modal_basis_vals_batched(agg.p, agg.boxes, xq)  # (m, r, n_q, bs)
    n_win = np.einsum("cs,l,la,cslm->csam", jacs, ref.quad_weights, cg_b, agg_b)
    # (m, r, w_cg, bs) -> (w_cg, bs, r, m)
    return SeamProlong(
        n_win=torch.from_numpy(np.ascontiguousarray(n_win.transpose(2, 3, 1, 0))),
        inv_lump=1.0 / base.lumped_mass,
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
