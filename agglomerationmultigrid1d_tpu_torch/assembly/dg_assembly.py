"""DG first-order-system ("flux") operator and rhs assembly.

The LDG-with-penalty scheme builds three block-tridiagonal operators — G
(gradient), D (divergence), C (Dirichlet penalty) — and the caller forms the
Schur stiffness ``A = C - D M^-1 G``.  In 1D with the default upwinding (u-hat
from the left element, q-hat from the right) every interior vertex touches
four scalar entries and every domain end one, so assembly is pure slicing on
the ``(bs, bs, n)`` diagonals.  An explicit per-vertex switch mirrors the
couplings at its flipped vertices (G then has an upper and D a lower
diagonal; a mixed switch makes A block-pentadiagonal).  Assembled on the host
in float64.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..mesh.dg_mesh import DgMesh
from ..mesh.topology import BoundaryCondition
from ..ops.block_tridiag import BlockTridiag


def _volume_ref(dg: DgMesh) -> np.ndarray:
    ref = dg.ref
    return np.einsum("l,li,lj->ij", ref.quad_weights, ref.deriv_at_quad, ref.basis_at_quad)


def dg_flux_operators(
    dg: DgMesh, bc: BoundaryCondition, c_dir: float
) -> tuple[BlockTridiag, BlockTridiag, BlockTridiag]:
    """(G, D, C) block-tridiagonal operators."""
    p = dg.p
    bs = p + 1
    n = dg.n_elements
    s1 = 1 if p >= 1 else 0  # slot of the right endpoint value

    g_lower = np.zeros((bs, bs, n))
    g_diag = np.zeros((bs, bs, n))
    g_upper = np.zeros((bs, bs, n))
    d_lower = np.zeros((bs, bs, n))
    d_diag = np.zeros((bs, bs, n))
    d_upper = np.zeros((bs, bs, n))
    c_diag = np.zeros((bs, bs, n))

    if p >= 1:
        k_vol = _volume_ref(dg)
        g_diag += k_vol[:, :, None]
        d_diag += k_vol[:, :, None]

    # interior vertices: left-element row -1, right-element row +1
    if n > 1 and dg.u_hat_left is None:
        g_lower[0, s1, 1:] += 1.0
        g_diag[s1, s1, :-1] += -1.0
        d_diag[0, 0, 1:] += 1.0
        d_upper[s1, 0, :-1] += -1.0
    elif n > 1:
        # at a flipped vertex u-hat comes from the RIGHT element's
        # left-endpoint trace and q-hat from the LEFT element's right-endpoint
        # trace: the mirrored couplings (the JAX package's consistent
        # alternating flux, not the reference's literal flipped trace)
        sw = np.asarray(dg.u_hat_left, dtype=np.float64)
        fl = 1.0 - sw
        g_lower[0, s1, 1:] += sw
        g_diag[s1, s1, :-1] += -sw
        g_diag[0, 0, 1:] += fl
        g_upper[s1, 0, :-1] += -fl
        d_diag[0, 0, 1:] += sw
        d_upper[s1, 0, :-1] += -sw
        d_diag[s1, s1, :-1] += -fl
        d_lower[0, s1, 1:] += fl

    # domain boundary vertices
    if bc.dir_left:
        d_diag[0, 0, 0] += 1.0
        c_diag[0, 0, 0] += c_dir
    elif bc.neu_left:
        g_diag[0, 0, 0] += 1.0
    if bc.dir_right:
        d_diag[s1, s1, -1] += -1.0
        c_diag[s1, s1, -1] += c_dir
    elif bc.neu_right:
        g_diag[s1, s1, -1] += -1.0

    t = torch.from_numpy
    zero = torch.zeros((bs, bs, n), dtype=torch.float64, device="cpu")
    default = dg.u_hat_left is None
    g = BlockTridiag(lower=t(g_lower), diag=t(g_diag), upper=zero if default else t(g_upper))
    d = BlockTridiag(lower=zero if default else t(d_lower), diag=t(d_diag), upper=t(d_upper))
    c = BlockTridiag(lower=zero, diag=t(c_diag), upper=zero)
    return g, d, c


def dg_load(jac, centers, quad_nodes, wphi, func: Callable) -> torch.Tensor:
    """Volume load from per-element jacobians and centers (``(n,)``), the
    reference quadrature nodes ``(n_q,)`` and ``wphi = w_l phi_i(x_l)``
    ``(n_q, bs)``, on the tensors' device: the JAX package's ``_dg_load_jit``.
    The stencil setup calls it on the card in float64 for the full-size rhs."""
    xq = centers[None, :] + jac[None, :] * quad_nodes[:, None]  # (n_q, n)
    fv = func(xq) * jac[None, :]
    out = wphi[0][:, None] * fv[0][None, :]
    for l in range(1, wphi.shape[0]):
        out = out + wphi[l][:, None] * fv[l][None, :]
    return out


def dg_load_vector(dg: DgMesh, func: Callable) -> torch.Tensor:
    """Volume load  f[i, k] = J_k sum_l w_l phi_i f(x_kl)  as ``(bs, n)``;
    ``func`` maps a float64 tensor of points to values."""
    ref = dg.ref
    t = torch.from_numpy
    return dg_load(
        t(dg.mesh.jacobians), t(dg.mesh.centers), t(ref.quad_nodes),
        t(ref.quad_weights[:, None] * ref.basis_at_quad), func,
    )


def dg_flux_rhs(
    dg: DgMesh, func: Callable, bc: BoundaryCondition, c_dir: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(f, r) right-hand sides; the solved system's rhs is ``b = f - D M^-1 r``."""
    s1 = 1 if dg.p >= 1 else 0
    f = dg_load_vector(dg, func)
    r = torch.zeros_like(f)
    if bc.dir_left:
        g = bc.left[1]
        f[0, 0] += c_dir * g
        r[0, 0] += -g
    elif bc.neu_left:
        f[0, 0] += -bc.left[1]
    if bc.dir_right:
        g = bc.right[1]
        f[s1, -1] += c_dir * g
        r[s1, -1] += g
    elif bc.neu_right:
        f[s1, -1] += bc.right[1]
    return f, r


# -- the standalone single-operator forms (cf. dg_mesh.jl:474-943) --


def gradient(dg: DgMesh, bc: BoundaryCondition) -> BlockTridiag:
    g, _, _ = dg_flux_operators(dg, bc, 0.0)
    return g


def divergence(dg: DgMesh, bc: BoundaryCondition) -> BlockTridiag:
    _, d, _ = dg_flux_operators(dg, bc, 0.0)
    return d


def c_matrix(dg: DgMesh, bc: BoundaryCondition, c_dir: float) -> BlockTridiag:
    _, _, c = dg_flux_operators(dg, bc, c_dir)
    return c


def r_vector(dg: DgMesh, bc: BoundaryCondition) -> torch.Tensor:
    _, r = dg_flux_rhs(dg, torch.zeros_like, bc, 0.0)
    return r


def f_vector(dg: DgMesh, func: Callable, bc: BoundaryCondition, c_dir: float) -> torch.Tensor:
    f, _ = dg_flux_rhs(dg, func, bc, c_dir)
    return f
