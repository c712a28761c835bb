"""CG stiffness / rhs assembly.

Every element contribution is one constant reference matrix scaled by 1/J
(1D Laplacian), so assembly is a broadcast plus the banded window scatter-add
of :mod:`..ops.cg_operator`.  Strong Dirichlet surgery is folded into the
boundary element windows (exact; see ``ops.cg_operator``).  Assembled on the
host in float64, vectorised over elements.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..mesh.cg_mesh import CgMesh
from ..mesh.topology import BoundaryCondition
from ..ops.cg_operator import CgOperator, cg_element_nodes, cg_from_windows


def _stiffness_ref_pos(cg: CgMesh) -> np.ndarray:
    """Reference stiffness ``K[i,j] = sum_l w_l phi'_i phi'_j`` in grid-position order."""
    ref = cg.ref
    k_slot = np.einsum("l,li,lj->ij", ref.quad_weights, ref.deriv_at_quad, ref.deriv_at_quad)
    pos = ref.pos_to_slot
    return k_slot[np.ix_(pos, pos)]


def _fold_dirichlet(windows: torch.Tensor, bc: BoundaryCondition) -> torch.Tensor:
    """Zero the Dirichlet row/col and set a unit diagonal inside the owning
    element window."""
    w = windows.shape[0]
    windows = windows.clone()
    if bc.dir_left:
        windows[0, :, 0] = 0.0
        windows[:, 0, 0] = 0.0
        windows[0, 0, 0] = 1.0
    if bc.dir_right:
        windows[w - 1, :, -1] = 0.0
        windows[:, w - 1, -1] = 0.0
        windows[w - 1, w - 1, -1] = 1.0
    return windows


def _raw_stiffness_windows(cg: CgMesh) -> torch.Tensor:
    k_pos = torch.from_numpy(_stiffness_ref_pos(cg))
    inv_jac = 1.0 / torch.from_numpy(cg.mesh.jacobians)
    return k_pos[:, :, None] * inv_jac[None, None, :]


def cg_stiffness(cg: CgMesh, bc: BoundaryCondition) -> CgOperator:
    """The assembled stiffness with the Dirichlet surgery, alone."""
    return cg_from_windows(_fold_dirichlet(_raw_stiffness_windows(cg), bc))


def _load_vector(cg: CgMesh, func: Callable) -> torch.Tensor:
    """Volume load ``f[node] = sum_el J w_l phi_i f(x_l)`` in grid order;
    ``func`` maps a float64 tensor of points to values."""
    ref = cg.ref
    t = torch.from_numpy
    basis_pos = t(np.ascontiguousarray(ref.basis_at_quad[:, ref.pos_to_slot]))  # (n_q, w)
    jac = t(cg.mesh.jacobians)
    xq = t(cg.mesh.centers)[:, None] + jac[:, None] * t(ref.quad_nodes)[None, :]
    fe = torch.einsum("k,l,la,kl->ak", jac, t(ref.quad_weights), basis_pos, func(xq))
    f = torch.zeros((cg.n_nodes,), dtype=fe.dtype)
    idx = cg_element_nodes(cg.p, cg.n_elements, "cpu")
    return f.index_add_(0, idx.reshape(-1), fe.reshape(-1))


def _apply_neumann(f: torch.Tensor, bc: BoundaryCondition) -> torch.Tensor:
    """Neumann flux terms: -g at the left end, +g at the right."""
    if bc.neu_left:
        f[0] += -bc.left[1]
    if bc.neu_right:
        f[-1] += bc.right[1]
    return f


def cg_stiffness_and_rhs(
    cg: CgMesh, func: Callable, bc: BoundaryCondition
) -> tuple[CgOperator, torch.Tensor]:
    """Stiffness + load with full BC treatment.  The Dirichlet lift
    ``f -= A[:, dir] g`` uses the raw (pre-surgery) stiffness column, which
    lives entirely inside the boundary element window."""
    raw = _raw_stiffness_windows(cg)
    f = _apply_neumann(_load_vector(cg, func), bc)

    w = raw.shape[0]
    if bc.dir_left:
        g = bc.left[1]
        f[:w] += -raw[:, 0, 0] * g
        f[0] = g
    if bc.dir_right:
        g = bc.right[1]
        f[cg.n_nodes - w :] += -raw[:, w - 1, -1] * g
        f[-1] = g

    return cg_from_windows(_fold_dirichlet(raw, bc)), f


def cg_rhs(cg: CgMesh, func: Callable, bc: BoundaryCondition) -> torch.Tensor:
    """The right-hand side of :func:`cg_stiffness_and_rhs`, alone."""
    _, f = cg_stiffness_and_rhs(cg, func, bc)
    return f
