"""Inter-level prolongation constructors.

``<coarse>_<fine>_interpolation`` builds the prolongation L mapping the coarse
space into the fine space; restriction is L^T, applied by the solver.
Uniform groupings give the reshape-based :class:`BlockProlong`, ragged ones
(element counts the coarsening factors do not divide) a
:class:`RaggedBlockProlong` or a :class:`SeamProlong` with ``offsets``.
Built on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.cg_mesh import CgMesh
from ..mesh.dg_mesh import DgMesh
from ..numerics import evaluate_nodal_basis, gauss_quad, modal_basis_vals_batched
from ..ops.cg_operator import cg_to_dense
from ..ops.transfer_ops import (
    BlockProlong,
    CgProlong,
    RaggedBlockProlong,
    SeamProlong,
    block_prolong_constant,
    ragged_prolong,
)


def cg_cg_interpolation(low: CgMesh, high: CgMesh) -> CgProlong:
    """Coarse (low-order) nodal basis evaluated at fine nodes, grid order."""
    x_fine_pos = high.ref.nodes_x[high.ref.pos_to_slot]
    e_slotcols = evaluate_nodal_basis(low.ref.basis_coeff, x_fine_pos)  # (w_f, w_c slots)
    return CgProlong(e=torch.from_numpy(np.ascontiguousarray(e_slotcols[:, low.ref.pos_to_slot])))


_FLAG_ERROR = "interp_flag must be 1 or 2 (0 = dense projection: use *_dense)"


def dg_cg_interpolation(low: DgMesh, high: CgMesh, interp_flag: int = 1) -> SeamProlong:
    """The DG space into the CG space: the lumped-mass-scaled L2 projection
    (``interp_flag = 1``, the hierarchy's seam, ``mesh_heirarchy.jl:62-63``)
    or nodal averaging (``interp_flag = 2``: the DG function at the CG
    nodes, the two values at an interior vertex averaged)."""
    if interp_flag == 1:
        qx, qw = gauss_quad(low.p + high.p)
        cg_b = evaluate_nodal_basis(high.ref.basis_coeff, qx)[:, high.ref.pos_to_slot]
        dg_b = evaluate_nodal_basis(low.ref.basis_coeff, qx)  # (n_q, bs) slot order
        n_ref = torch.from_numpy(np.einsum("l,la,lm->am", qw, cg_b, dg_b))  # (w_cg, bs)
        n_win = n_ref[:, :, None, None] * torch.from_numpy(high.mesh.jacobians)
        return SeamProlong(n_win=n_win, inv_lump=1.0 / high.lumped_mass)
    if interp_flag == 2:
        e = evaluate_nodal_basis(low.ref.basis_coeff, high.ref.nodes_x[high.ref.pos_to_slot])  # (w_cg, bs)
        weights = np.ones((high.p + 1, high.n_elements))
        weights[0, 1:] = 0.5  # an interior vertex averages its two elements
        weights[-1, :-1] = 0.5
        n_win = torch.from_numpy(weights[:, None, None, :] * e[:, :, None, None])
        return SeamProlong(n_win=n_win, inv_lump=torch.ones((high.n_nodes,), dtype=torch.float64))
    raise ValueError(_FLAG_ERROR)


def aggdg_cg_interpolation(agg: AggMesh, base: CgMesh, interp_flag: int = 1) -> SeamProlong:
    """The agglomerate modal basis into the base CG space: the
    lumped-mass-scaled L2 projection integrated base element by base element
    (``interp_flag = 1``), or nodal averaging (``interp_flag = 2``).  Each
    agglomerate's base elements are gathered into ``r_max`` padded slots; a
    padding slot has a zero jacobian (flag 1) or weight (flag 2), hence a zero
    window, so its clamped scatter index adds nothing."""
    ref = base.ref
    n_el = base.n_elements
    j_idx = np.minimum(agg.offsets[:, None] + np.arange(agg.r_max)[None, :], n_el - 1)
    valid = np.arange(agg.r_max)[None, :] < agg.sizes[:, None]
    centers = base.mesh.centers[j_idx]
    jacs = np.where(valid, base.mesh.jacobians[j_idx], 0.0)
    offsets = None if agg.uniform_r is not None else torch.from_numpy(agg.offsets.astype(np.int32))
    if interp_flag == 1:
        xq = centers[:, :, None] + jacs[:, :, None] * ref.quad_nodes[None, None, :]
        cg_b = ref.basis_at_quad[:, ref.pos_to_slot]  # (n_q, w_cg) position order
        agg_b = modal_basis_vals_batched(agg.p, agg.boxes, xq)  # (m, r_max, n_q, bs)
        n_win = np.einsum("cs,l,la,cslm->csam", jacs, ref.quad_weights, cg_b, agg_b)
        inv_lump = 1.0 / base.lumped_mass
    elif interp_flag == 2:
        xn = centers[:, :, None] + jacs[:, :, None] * ref.nodes_x[ref.pos_to_slot][None, None, :]
        weights = np.ones((n_el, base.p + 1))
        weights[1:, 0] = 0.5
        weights[:-1, -1] = 0.5
        e = modal_basis_vals_batched(agg.p, agg.boxes, xn)  # (m, r_max, w_cg, bs)
        n_win = e * np.where(valid[:, :, None], weights[j_idx], 0.0)[:, :, :, None]
        inv_lump = torch.ones((base.n_nodes,), dtype=torch.float64)
    else:
        raise ValueError(_FLAG_ERROR)
    # (m, r_max, w_cg, bs) -> (w_cg, bs, r_max, m)
    return SeamProlong(
        n_win=torch.from_numpy(np.ascontiguousarray(n_win.transpose(2, 3, 1, 0))),
        inv_lump=inv_lump,
        offsets=offsets,
    )


def _seam_to_dense_n(l: SeamProlong) -> torch.Tensor:
    """The unscaled cross-mass N of a seam transfer, dense ``(n_cg_nodes,
    bs n_c)`` (analysis and the dense projections)."""
    w_cg, bs, r, n_c = l.n_win.shape
    p_cg = w_cg - 1
    n_rows = l.inv_lump.shape[0]
    n_el = (n_rows - 1) // p_cg
    base_el = torch.arange(n_c) * r if l.offsets is None else l.offsets.cpu().long()
    out = torch.zeros((n_rows, bs * n_c), dtype=l.n_win.dtype)
    n_win = l.n_win.cpu()
    for j in range(r):
        for a in range(w_cg):
            rows = torch.clamp(base_el + j, max=n_el - 1) * p_cg + a
            for m_ in range(bs):
                out.index_put_((rows, torch.arange(n_c) * bs + m_), n_win[a, m_, j], accumulate=True)
    return out


def _dense_projection(seam: SeamProlong, cg: CgMesh) -> torch.Tensor:
    """``M^-1 N``: the consistent-mass L2 projection, dense."""
    return torch.linalg.solve(cg_to_dense(cg.mass).cpu(), _seam_to_dense_n(seam))


def dg_cg_interpolation_dense(low: DgMesh, high: CgMesh) -> torch.Tensor:
    """The consistent-mass L2 projection of the DG space into the CG space
    (``interp_flag = 0``; dense, analysis only)."""
    return _dense_projection(dg_cg_interpolation(low, high, 1), high)


def aggdg_cg_interpolation_dense(agg: AggMesh, base: CgMesh) -> torch.Tensor:
    """The consistent-mass L2 projection of the agglomerate space into the CG
    space (``interp_flag = 0``; dense, analysis only)."""
    return _dense_projection(aggdg_cg_interpolation(agg, base, 1), base)


def cg_cg_interpolation2(low: CgMesh, high: CgMesh) -> torch.Tensor:
    """The consistent-mass L2 projection between CG spaces
    (``interpolation.jl:57-85``; dense, analysis only: the hierarchy takes
    :func:`cg_cg_interpolation`)."""
    qx, qw = gauss_quad(low.p + high.p)
    hi_b = evaluate_nodal_basis(high.ref.basis_coeff, qx)[:, high.ref.pos_to_slot]
    lo_b = evaluate_nodal_basis(low.ref.basis_coeff, qx)[:, low.ref.pos_to_slot]
    n_ref = np.einsum("l,la,lb->ab", qw, hi_b, lo_b)  # (w_h, w_l)
    p_h, p_l = high.p, low.p
    n_dense = np.zeros((high.n_nodes, low.n_nodes))
    for k, jac in enumerate(high.mesh.jacobians):
        n_dense[k * p_h : k * p_h + p_h + 1, k * p_l : k * p_l + p_l + 1] += jac * n_ref
    return torch.linalg.solve(cg_to_dense(high.mass).cpu(), torch.from_numpy(n_dense))


def dg_dg_interpolation(low: DgMesh, high: DgMesh) -> BlockProlong:
    """Coarse nodal basis at fine nodes, slot order; one constant block."""
    e = evaluate_nodal_basis(low.ref.basis_coeff, high.ref.nodes_x)  # (w_f, w_c)
    return block_prolong_constant(torch.from_numpy(e), high.n_elements)


def dg_dg_interpolation2(low: DgMesh, high: DgMesh) -> BlockProlong:
    """The reference's duplicate-avoiding build (``interpolation.jl:111-139``):
    its entries equal :func:`dg_dg_interpolation`'s exactly (a nodal basis is
    zero at the other endpoints), so it is the same operator."""
    return dg_dg_interpolation(low, high)


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


def aggdg_dg_interpolation(agg: AggMesh, base: DgMesh):
    """Modal -> nodal evaluation of the agglomerate basis at base-element nodes."""
    r = agg.uniform_r
    if r is None:
        parent = np.repeat(np.arange(agg.n_agg), agg.sizes)  # (n_base,)
        xn = base.mesh.centers[:, None] + base.mesh.jacobians[:, None] * base.ref.nodes_x[None, :]
        per_el = modal_basis_vals_batched(agg.p, agg.boxes[parent], xn)  # (n_base, w, bs)
        return _pack_ragged_blocks(per_el, agg.sizes, agg.offsets)
    t = torch.from_numpy
    return BlockProlong(
        _aggdg_dg_blocks_uniform(
            agg.p, r, t(base.mesh.centers), t(base.mesh.jacobians),
            t(base.ref.nodes_x), t(agg.boxes),
        )
    )


def aggdg_dg_interpolation2(agg: AggMesh, base: DgMesh):
    """The agglomerate space into the DG space by L2 projection through the
    base mass (``interpolation.jl:294-324``), per base element."""
    ref = base.ref
    m, w = agg.n_agg, base.p + 1
    parent = np.repeat(np.arange(m), agg.sizes)
    centers, jacs = base.mesh.centers, base.mesh.jacobians
    xq = centers[:, None] + jacs[:, None] * ref.quad_nodes[None, :]  # (n_base, n_q)
    agg_b = modal_basis_vals_batched(agg.p, agg.boxes[parent], xq)  # (n_base, n_q, bs)
    n_blocks = np.einsum("e,l,li,elm->eim", jacs, ref.quad_weights, ref.basis_at_quad, agg_b)
    minv = base.mass_inv.blocks.detach().cpu().numpy().transpose(2, 0, 1)  # (n_base, w, w)
    per_el = np.einsum("eik,ekm->eim", minv, n_blocks)
    r = agg.uniform_r
    if r is None:
        return _pack_ragged_blocks(per_el, agg.sizes, agg.offsets)
    blocks = np.moveaxis(per_el.reshape(m, r, w, agg.block_size), (0, 1), (-1, 0))
    return BlockProlong(torch.from_numpy(np.ascontiguousarray(blocks)))


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


def aggdg_aggdg_interpolation(coarse: AggMesh, fine: AggMesh):
    """L2 projection between two agglomerated levels of the same order:
    a :class:`BlockProlong` for uniform groupings, else a
    :class:`RaggedBlockProlong` of the same closed form per fine agglomerate."""
    if coarse.p != fine.p:
        raise ValueError("the two agglomerated meshes must have the same p")
    r, rf = coarse.sub_uniform_r, fine.uniform_r
    if r is not None and rf is not None:
        return BlockProlong(
            _aggdg_aggdg_blocks_uniform(
                coarse.p, r, torch.from_numpy(coarse.boxes), torch.from_numpy(fine.boxes)
            )
        )
    # the coarse modal basis restricted to a fine interval: 1 -> 1,
    # xi_c -> 2 (cf - cc) / hc + (hf / hc) xi_f, exactly the L2 projection
    cb = coarse.boxes[np.repeat(np.arange(coarse.n_agg), coarse.sub_sizes)]
    fb = fine.boxes
    hc, hf = cb[:, 1] - cb[:, 0], fb[:, 1] - fb[:, 0]
    cf, cc = 0.5 * (fb[:, 0] + fb[:, 1]), 0.5 * (cb[:, 0] + cb[:, 1])
    bs = coarse.block_size
    l_f = np.zeros((fine.n_agg, bs, bs))
    l_f[:, 0, 0] = 1.0
    if coarse.p == 1:
        l_f[:, 0, 1] = 2.0 * (cf - cc) / hc
        l_f[:, 1, 1] = hf / hc
    return _pack_ragged_blocks(l_f, coarse.sub_sizes, coarse.sub_offsets)


def _pack_ragged_blocks(per_fine: np.ndarray, sizes, offsets) -> RaggedBlockProlong:
    """``(n_f, bs_f, bs_c)`` per-fine-block matrices -> a RaggedBlockProlong,
    zero past each group's size."""
    r_max = int(np.max(sizes))
    n_f = per_fine.shape[0]
    idx = np.minimum(offsets[:, None] + np.arange(r_max)[None, :], n_f - 1)
    valid = np.arange(r_max)[None, :] < np.asarray(sizes)[:, None]
    blocks = np.where(valid[:, :, None, None], per_fine[idx], 0.0)  # (m, r_max, bs_f, bs_c)
    return ragged_prolong(torch.from_numpy(np.ascontiguousarray(np.moveaxis(blocks, (0, 1), (-1, 0)))), sizes)
