"""Agglomerated-DG flux operator and right-hand side assembly.  In a
hierarchy an agglomerated level assembles its own operators only at the
CG -> agglomerated seam of a CG-topped chain (below DG or agglomerated levels
they are Galerkin products); the right-hand sides discretize a problem on
the agglomerated level itself.

The flux scheme is the DG level's, but the vertex terms are rank-1 outer
products of the agglomerates' boundary modal-basis values.  The modal basis
{1, 2(x - xc)/h} has boundary values (1, -1) on the left and (1, 1) on the
right, derivatives (0, 2/h), and integrates to (h, 0): on a lite mesh the
volume moment is that closed form, on a tabled one the quadrature sum over
the base elements (equal to rounding).  The load vector needs the tables.
An explicit switch mirrors the couplings at its flipped vertices, as on the
DG level.  Assembled on the host in float64.
"""

from __future__ import annotations

from typing import Callable

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
    if agg.has_tables:
        q = np.einsum("cs,l,cslj->cj", agg.base_jacobians(), agg.quad_weights, agg.basis_q)
    else:
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


def agg_load_vector(agg: AggMesh, func: Callable) -> torch.Tensor:
    """Volume load ``f[i, c] = sum_s J_cs sum_l w_l phi_i(x_csl) f(x_csl)`` as
    ``(p+1, m)``; ``func`` maps a float64 tensor of points to values.  Needs a
    tabled mesh."""
    t = torch.from_numpy
    return torch.einsum(
        "cs,l,csli,csl->ic", t(agg.base_jacobians()), t(agg.quad_weights), t(agg.basis_q),
        func(t(agg.x_quad)),
    )


def agg_flux_rhs(
    agg: AggMesh, func: Callable, bc: BoundaryCondition, c_dir: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(f, r) right-hand sides over agglomerates (``agglomerated_dg_mesh.jl:875-994``)."""
    f = agg_load_vector(agg, func)
    r = torch.zeros_like(f)
    _, bl, br = _closed_form_traces(agg)
    bl0, brn = torch.from_numpy(bl[0]), torch.from_numpy(br[-1])
    if bc.dir_left:
        g = bc.left[1]
        f[:, 0] += c_dir * g * bl0
        r[:, 0] += -g * bl0
    elif bc.neu_left:
        f[:, 0] += -bc.left[1] * bl0
    if bc.dir_right:
        g = bc.right[1]
        f[:, -1] += c_dir * g * brn
        r[:, -1] += g * brn
    elif bc.neu_right:
        f[:, -1] += bc.right[1] * brn
    return f, r


# -- the standalone single-operator forms (cf. agglomerated_dg_mesh.jl:1012-1381) --


def agg_gradient(agg: AggMesh, bc: BoundaryCondition) -> BlockTridiag:
    g, _, _ = agg_flux_operators(agg, bc, 0.0)
    return g


def agg_divergence(agg: AggMesh, bc: BoundaryCondition) -> BlockTridiag:
    _, d, _ = agg_flux_operators(agg, bc, 0.0)
    return d


def agg_c_matrix(agg: AggMesh, bc: BoundaryCondition, c_dir: float) -> BlockTridiag:
    """The penalty factor C of :func:`agg_flux_operators` (the reference's
    standalone p = 0 ``C_matrix`` has a dead-code typo,
    ``agglomerated_dg_mesh.jl:1362``; this is the C the hierarchy uses)."""
    _, _, c = agg_flux_operators(agg, bc, c_dir)
    return c


def agg_r_vector(agg: AggMesh, bc: BoundaryCondition) -> torch.Tensor:
    _, r = agg_flux_rhs(agg, torch.zeros_like, bc, 0.0)
    return r


def agg_f_vector(agg: AggMesh, func: Callable, bc: BoundaryCondition, c_dir: float) -> torch.Tensor:
    f, _ = agg_flux_rhs(agg, func, bc, c_dir)
    return f
