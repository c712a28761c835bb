"""Block-aligned prolongation (coarse -> fine), its transpose and the Galerkin
triple product.

:class:`BlockProlong` covers every transfer of a DG-topped chain: DG -> DG
p-coarsening (r = 1), DG -> agglomerated (r = 4) and agg -> agg (r = 2).  Fine
block ``r*c + j`` receives coarse block ``c`` through ``blocks[j][:, :, c]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .block_tridiag import BlockTridiag, block_mul
from .shifts import shift


class BlockProlong(NamedTuple):
    blocks: torch.Tensor  # (r, bs_f, bs_c, n_c)

    @property
    def r(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[3]


def block_prolong_constant(e: torch.Tensor, n: int) -> BlockProlong:
    """r = 1 prolongation with the same ``(bs_f, bs_c)`` matrix on every element."""
    return BlockProlong(e[None, :, :, None].expand(1, *e.shape, n))


def bp_prolong(l: BlockProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs_c, n_c) -> (bs_f, r * n_c)``: fine column ``r*c + j`` is
    ``blocks[j, :, :, c] @ xc[:, c]``."""
    t = torch.einsum("jibn,bn->jin", l.blocks, xc)  # (r, bs_f, n_c)
    return t.permute(1, 2, 0).reshape(l.bs_fine, l.r * xc.shape[-1])


def bp_restrict(l: BlockProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf``: ``(bs_f, r * n_c) -> (bs_c, n_c)``, one strided slice per
    offset ``j``, summed in ascending ``j``."""
    r = l.r
    out = None
    for j in range(r):
        oj = torch.einsum("ibn,in->bn", l.blocks[j], rf[:, j::r])
        out = oj if out is None else out + oj
    return out


def _sandwich(ba: torch.Tensor, m: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """``Ba^T M Bb`` per element: (bs_f,bs_c,n),(bs_f,bs_f,n),(bs_f,bs_c,n)->(bs_c,bs_c,n)."""
    return block_mul(ba.transpose(0, 1), block_mul(m, bb))


def bp_galerkin(l: BlockProlong, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` for block-tridiagonal fine X; the coarse result is
    block-tridiagonal because X couples only +-1 fine neighbours."""
    r, nc = l.r, l.n_coarse
    bs = x.block_size
    dg = x.diag.reshape(bs, bs, nc, r)
    lg = x.lower.reshape(bs, bs, nc, r)
    ug = x.upper.reshape(bs, bs, nc, r)
    b = l.blocks

    diag = _sandwich(b[0], dg[..., 0], b[0])
    for j in range(1, r):
        diag = diag + _sandwich(b[j], dg[..., j], b[j])
    for j in range(r - 1):
        diag = diag + _sandwich(b[j + 1], lg[..., j + 1], b[j])
        diag = diag + _sandwich(b[j], ug[..., j], b[j + 1])

    upper = _sandwich(b[r - 1], ug[..., r - 1], shift(b[0], +1))
    lower = _sandwich(b[0], lg[..., 0], shift(b[r - 1], -1))
    return BlockTridiag(lower=lower, diag=diag, upper=upper)
