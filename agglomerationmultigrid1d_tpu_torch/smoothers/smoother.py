"""Smoothers, applied as  x += alpha * S * r.

* :class:`JacobiSmoother` — pointwise diagonal scaling; works on CG node
  vectors ``(n_nodes,)`` and block vectors ``(bs, n)`` alike.
* :class:`BlockJacobiSmoother` — per-element block solve on DG / agglomerated
  levels; the per-block LU backsolves of the reference become one batched
  product with block inverses precomputed at setup.
* :class:`SchwarzSmoother` — overlapping element-block solves on CG levels:
  additive (overlaps summed) or hybrid (divided by node multiplicity),
  depending on ``mult_inv``.
* :class:`ChebyshevSmoother` — Chebyshev acceleration over any of the above
  (an extension of the JAX package beyond the reference's damped sweeps).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..ops.block_diag import BlockDiag, bd_inverse, bd_matvec
from ..ops.block_tridiag import BlockTridiag, block_mul, bt_diag_blocks
from ..ops.cg_operator import (
    CgOperator,
    cg_element_nodes,
    cg_assembled_windows,
    cg_diagonal,
    cg_node_multiplicity,
)


class JacobiSmoother(NamedTuple):
    inv_diag: torch.Tensor  # same shape as the level's vectors


class BlockJacobiSmoother(NamedTuple):
    inv: torch.Tensor  # (bs, bs, n) inverse diagonal blocks
    # M-form streams for the fused multisweep kernels (float32 levels only):
    # ml = inv @ a.lower, mu = inv @ a.upper, precomputed once at setup, so the
    # kernel streams 3 operators instead of 4 and skips the diagonal
    # contraction (S^-1 A_D = I).  None on float64 levels.
    ml: torch.Tensor | None = None
    mu: torch.Tensor | None = None
    # On a sharded float32 level: the ring neighbours' edge columns of ml, mu
    # and inv, (3, bs, bs, 2 g), left neighbour's last g then right's first g
    # (kernel K7's operator ghosts), exchanged once when the level is sharded
    # (parallel.distributed.attach_operator_ghosts).  None elsewhere.
    ghosts: torch.Tensor | None = None
    # With the ghosts: the level's parallel.sharded_kernels.edge_plan (an
    # ops.kernels.block_kernels.EdgePlan bound to inv, ml, mu, the level's
    # a.diag and the ghosts, owning the messages of the per-smoothing
    # exchange).  Not a tensor: casting or moving the smoother leaves it bound
    # to the old tensors, and the sharded smoother then builds one per call
    # until attach_operator_ghosts makes a new one.
    plan: object | None = None


class SchwarzSmoother(NamedTuple):
    inv_windows: torch.Tensor  # (w, w, n_el) inverses of assembled element windows
    mult_inv: torch.Tensor | None  # (n_nodes,): set => hybrid, None => additive

    @property
    def p(self) -> int:
        return self.inv_windows.shape[0] - 1

    @property
    def n_el(self) -> int:
        return self.inv_windows.shape[2]


class ChebyshevSmoother(NamedTuple):
    """Chebyshev-accelerated smoothing over a base smoother.

    ``k`` applications target the interval ``[lam_lo, lam_hi]`` of the
    preconditioned spectrum ``S A``: a degree-k Chebyshev polynomial damps the
    upper part of the spectrum far faster than k fixed-damping sweeps.
    ``coef`` is the recurrence table of
    :func:`..ops.kernels.block_kernels.chebyshev_coefficients` for
    ``MAX_SWEEPS`` steps, as host floats, on float32 levels only (filled by
    ``models.hierarchy.prepare_fast_smoothers``), and ``theta`` the
    interval's float32 centre beside it: the fused kernels (K5, K14) take
    them by value, so smoothing reads no scalar back from the device."""

    base: "Smoother"
    lam_lo: torch.Tensor  # 0-d, lower edge of the damped interval
    lam_hi: torch.Tensor  # 0-d, estimate of lambda_max(S A), slightly inflated
    coef: tuple | None = None  # ((c_d, c_z), ...) float32 values, MAX_SWEEPS rows
    theta: float | None = None  # float32 value of 0.5 (lam_hi + lam_lo), with coef


Smoother = Union[JacobiSmoother, BlockJacobiSmoother, SchwarzSmoother, ChebyshevSmoother]


def apply_smoother(s: Smoother, r: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``alpha * S r``."""
    if isinstance(s, JacobiSmoother):
        return alpha * (s.inv_diag * r)
    if isinstance(s, BlockJacobiSmoother):
        return alpha * bd_matvec(BlockDiag(s.inv), r)
    if isinstance(s, SchwarzSmoother):
        y = schwarz_windows(s, r)
        if s.mult_inv is not None:
            y = y * s.mult_inv
        return alpha * y
    raise TypeError(f"unknown smoother {type(s)}")


def schwarz_windows(s: SchwarzSmoother, r: torch.Tensor) -> torch.Tensor:
    """The overlapping window solves of a Schwarz smoother, scatter-added:
    ``r`` holds the ``n_el p + 1`` nodes of ``s``'s elements (on a shard, its
    own nodes and the vertex it shares with the next rank), and so does the
    result."""
    idx = cg_element_nodes(s.p, s.n_el, r.device)
    y_win = torch.einsum("abn,bn->an", s.inv_windows, r[idx])
    return torch.zeros((s.n_el * s.p + 1,), dtype=r.dtype, device=r.device).index_add_(
        0, idx.reshape(-1), y_win.reshape(-1)
    )


def _inv_windows_2x2(w: torch.Tensor) -> torch.Tensor:
    """Cofactor inverse of ``(2, 2, n)`` blocks, on the same layout (any device)."""
    a, b, c, d = w[0, 0], w[0, 1], w[1, 0], w[1, 1]
    idet = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) * idet


def _invert_windows(windows: torch.Tensor) -> torch.Tensor:
    """(w, w, n) -> per-slice inverse, same layout: closed form for w <= 2,
    ``bd_inverse`` otherwise (setup only)."""
    bs = windows.shape[0]
    if bs == 1:
        return 1.0 / windows
    if bs == 2:
        return _inv_windows_2x2(windows)
    return bd_inverse(BlockDiag(windows)).blocks


def cg_smoother(a: CgOperator, kind: str = "jac") -> Smoother:
    """Smoother of a CG level: ``"jac"``, ``"addSchwarz"`` or ``"hybridSchwarz"``."""
    if kind == "jac":
        return JacobiSmoother(inv_diag=1.0 / cg_diagonal(a))
    if kind in ("addSchwarz", "hybridSchwarz"):
        inv_win = _invert_windows(cg_assembled_windows(a))
        mult_inv = None
        if kind == "hybridSchwarz":
            mult_inv = 1.0 / cg_node_multiplicity(
                a.p, a.n_el, dtype=a.band.dtype, device=a.band.device
            )
        return SchwarzSmoother(inv_windows=inv_win, mult_inv=mult_inv)
    raise ValueError(f"unknown CG smoother kind {kind!r}")


def dg_smoother(a, kind: str = "blockJac") -> Smoother:
    """Smoother of a DG / agglomerated level: ``"jac"`` (pointwise) or
    ``"blockJac"`` (inverted diagonal blocks).  ``a`` is block-tridiagonal,
    block-pentadiagonal or block-COO; a float32 block-tridiagonal level also
    gets the M-form streams (no kernel takes the other two)."""
    from ..ops.block_coo import BlockCOO, bcoo_diag_blocks

    d = bcoo_diag_blocks(a) if isinstance(a, BlockCOO) else bt_diag_blocks(a).blocks
    if kind == "jac":
        return JacobiSmoother(inv_diag=1.0 / torch.stack([d[i, i] for i in range(d.shape[0])]))
    if kind != "blockJac":
        raise ValueError(f"unknown DG smoother kind {kind!r}")
    inv = _invert_windows(d)
    ml = mu = None
    if isinstance(a, BlockTridiag) and a.diag.dtype == torch.float32:
        ml = block_mul(inv, a.lower)
        mu = block_mul(inv, a.upper)
    return BlockJacobiSmoother(inv=inv, ml=ml, mu=mu)
