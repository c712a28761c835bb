"""Flux operators and right-hand sides over scattered (non-contiguous)
agglomeration levels.

The flux scheme of the contiguous agglomerated assembly
(:mod:`.agg_assembly`), with the vertex terms enumerated over the mesh's
interface list instead of the implicit ``c | c+1`` adjacency.  Per interface
with left agglomerate ``L``, right ``R`` and traces ``tL``, ``tR``:

* default (u-hat left, q-hat right):
  ``G[R,L] += tR tL^T``, ``G[L,L] -= tL tL^T``,
  ``D[R,R] += tR tR^T``, ``D[L,R] -= tL tR^T``
* flipped (u-hat right, q-hat left):
  ``G[R,R] += tR tR^T``, ``G[L,R] -= tL tR^T``,
  ``D[L,L] -= tL tL^T``, ``D[R,L] += tR tL^T``

Domain-boundary terms and the penalty ``C`` are single-agglomerate patches,
as in the contiguous case.  The results are block-COO operators, assembled
on the host in float64.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..mesh.scattered_agg import ScatteredAggMesh, _sum_by_owner
from ..mesh.topology import BoundaryCondition
from ..numerics import modal_basis_vals_batched
from ..ops.block_coo import BlockCOO, bcoo_add, bcoo_coalesce, bcoo_scale_cols, bcoo_spgemm
from ..ops.block_diag import BlockDiag


def _end_traces(sa: ScatteredAggMesh) -> tuple:
    """``(a0, an, t0, tn)``: the agglomerates owning the first and last base
    elements and their basis at the domain's two ends."""
    a0, an = int(sa.assign[0]), int(sa.assign[-1])
    vx = sa.mesh.vertex_x
    t0 = modal_basis_vals_batched(sa.p, sa.boxes[[a0]], vx[:1][None, :])[0, 0]
    tn = modal_basis_vals_batched(sa.p, sa.boxes[[an]], vx[-1:][None, :])[0, 0]
    return a0, an, t0, tn


def scattered_flux_operators(
    sa: ScatteredAggMesh, bc: BoundaryCondition, c_dir: float
) -> tuple[BlockCOO, BlockCOO, BlockCOO]:
    """(G, D, C) block-COO over scattered agglomerates, on the host."""
    m = sa.n_agg
    bs = sa.block_size

    # volume: vol[i, j, c] = deriv_i(c) * integral of phi_j over the members
    q_el = np.einsum("e,l,elj->ej", sa.mesh.jacobians, sa.quad_weights, sa.basis_q)
    q = _sum_by_owner(q_el, sa.assign, m)
    vol = np.einsum("ci,cj->ijc", sa.deriv_vals, q)  # (bs, bs, m)

    diag_ids = np.arange(m)
    g_rows, g_cols, g_blocks = [diag_ids], [diag_ids], [vol.copy()]
    d_rows, d_cols, d_blocks = [diag_ids], [diag_ids], [vol.copy()]
    c_diag = np.zeros((bs, bs, m))

    n_if = sa.n_interfaces
    if n_if:
        sw = np.ones(n_if) if sa.u_hat_left is None else np.asarray(sa.u_hat_left, dtype=np.float64)
        fl = 1.0 - sw
        L, R = sa.iface_left, sa.iface_right
        tL, tR = sa.trace_left, sa.trace_right  # (n_if, bs)

        def outer(w, a, b):
            return np.einsum("v,vi,vj->ijv", w, a, b)

        g_rows += [R, L]
        g_cols += [L, L]
        g_blocks += [outer(sw, tR, tL), -outer(sw, tL, tL)]
        d_rows += [R, L]
        d_cols += [R, R]
        d_blocks += [outer(sw, tR, tR), -outer(sw, tL, tR)]
        if sa.u_hat_left is not None:
            g_rows += [R, L]
            g_cols += [R, R]
            g_blocks += [outer(fl, tR, tR), -outer(fl, tL, tR)]
            d_rows += [L, R]
            d_cols += [L, L]
            d_blocks += [-outer(fl, tL, tL), outer(fl, tR, tL)]

    a0, an, t0, tn = _end_traces(sa)
    bl0 = np.outer(t0, t0)
    brn = np.outer(tn, tn)
    if bc.dir_left:
        d_rows.append([a0])
        d_cols.append([a0])
        d_blocks.append(bl0[:, :, None])
        c_diag[:, :, a0] += c_dir * bl0
    elif bc.neu_left:
        g_rows.append([a0])
        g_cols.append([a0])
        g_blocks.append(bl0[:, :, None])
    if bc.dir_right:
        d_rows.append([an])
        d_cols.append([an])
        d_blocks.append(-brn[:, :, None])
        c_diag[:, :, an] += c_dir * brn
    elif bc.neu_right:
        g_rows.append([an])
        g_cols.append([an])
        g_blocks.append(-brn[:, :, None])

    def coalesce(rows, cols, blocks):
        cat = lambda xs: np.concatenate([np.asarray(x) for x in xs])  # noqa: E731
        return bcoo_coalesce(cat(rows), cat(cols), np.concatenate(blocks, axis=2), m, m, device="cpu")

    return (
        coalesce(g_rows, g_cols, g_blocks),
        coalesce(d_rows, d_cols, d_blocks),
        bcoo_coalesce(diag_ids, diag_ids, c_diag, m, m, device="cpu"),
    )


def scattered_load_vector(sa: ScatteredAggMesh, func: Callable) -> torch.Tensor:
    """Volume load ``f[i, c]`` = sum over the members of ``J_e sum_l w_l
    phi_i f(x)``, as ``(bs, m)``; ``func`` maps a float64 tensor of points to
    values."""
    fv = func(torch.from_numpy(sa.x_quad)).numpy()
    per_el = np.einsum("e,l,eli,el->ei", sa.mesh.jacobians, sa.quad_weights, sa.basis_q, fv)
    return torch.from_numpy(np.ascontiguousarray(_sum_by_owner(per_el, sa.assign, sa.n_agg).T))


def scattered_flux_rhs(
    sa: ScatteredAggMesh, func: Callable, bc: BoundaryCondition, c_dir: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(f, r) right-hand sides, the boundary patches as in the contiguous case."""
    f = scattered_load_vector(sa, func)
    r = torch.zeros_like(f)
    a0, an, t0, tn = _end_traces(sa)
    t0, tn = torch.from_numpy(t0), torch.from_numpy(tn)
    if bc.dir_left:
        g = bc.left[1]
        f[:, a0] += c_dir * g * t0
        r[:, a0] += -g * t0
    elif bc.neu_left:
        f[:, a0] += -bc.left[1] * t0
    if bc.dir_right:
        g = bc.right[1]
        f[:, an] += c_dir * g * tn
        r[:, an] += g * tn
    elif bc.neu_right:
        f[:, an] += bc.right[1] * tn
    return f, r


def scattered_schur(g: BlockCOO, d: BlockCOO, c: BlockCOO, mass_inv: BlockDiag | torch.Tensor) -> BlockCOO:
    """``A = C - D M^-1 G`` over block-COO (host SpGEMM at setup)."""
    return bcoo_add(c, bcoo_spgemm(bcoo_scale_cols(d, mass_inv), g), beta=-1.0)
