"""Block-Jacobi smoothing, applied as  x += alpha * S * r.

The per-block LU backsolves of the reference become one batched product with
block inverses precomputed at setup.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.block_diag import BlockDiag, bd_matvec
from ..ops.block_tridiag import BlockTridiag, block_mul, bt_diag_blocks


class BlockJacobiSmoother(NamedTuple):
    inv: torch.Tensor  # (bs, bs, n) inverse diagonal blocks
    # M-form streams for the fused multisweep kernels (float32 levels only):
    # ml = inv @ a.lower, mu = inv @ a.upper, precomputed once at setup, so the
    # kernel streams 3 operators instead of 4 and skips the diagonal
    # contraction (S^-1 A_D = I).  None on float64 levels.
    ml: torch.Tensor | None = None
    mu: torch.Tensor | None = None


def apply_smoother(s: BlockJacobiSmoother, r: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``alpha * S r``."""
    return alpha * bd_matvec(BlockDiag(s.inv), r)


def _invert_windows(windows: torch.Tensor) -> torch.Tensor:
    """(w, w, n) -> per-slice inverse, same layout: closed form for w <= 2,
    ``torch.linalg.inv`` on the ``(n, w, w)`` view otherwise (setup only)."""
    bs = windows.shape[0]
    if bs == 1:
        return 1.0 / windows
    if bs == 2:
        a, b, c, d = windows[0, 0], windows[0, 1], windows[1, 0], windows[1, 1]
        idet = 1.0 / (a * d - b * c)
        return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) * idet
    return torch.movedim(torch.linalg.inv(torch.movedim(windows, -1, 0)), 0, -1).contiguous()


def dg_smoother(a: BlockTridiag, kind: str = "blockJac") -> BlockJacobiSmoother:
    """Block-Jacobi smoother of a DG / agglomerated level: its inverted
    diagonal blocks, plus the M-form streams on a float32 level."""
    if kind != "blockJac":
        raise NotImplementedError(
            f"smoother kind {kind!r} is not ported yet; the torch port has blockJac only"
        )
    inv = _invert_windows(bt_diag_blocks(a).blocks)
    ml = mu = None
    if a.diag.dtype == torch.float32:
        ml = block_mul(inv, a.lower)
        mu = block_mul(inv, a.upper)
    return BlockJacobiSmoother(inv=inv, ml=ml, mu=mu)
