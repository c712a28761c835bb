"""Block-pentadiagonal operators: the Schur stiffness of *mixed-switch* DG.

With the default (or any uniform) switch the DG Schur stiffness
``A = C - D M^-1 G`` is block-tridiagonal.  A *mixed* per-vertex switch
breaks that: D and M^-1 G then carry lower *and* upper couplings at flipped
vertices, so their product can have distance-2 blocks (nonzero where a
(True, False) vertex pair u-traps an element; zero for a non-trapping
switch, which still takes this exact product).  Same SoA layout
as :class:`~.block_tridiag.BlockTridiag`, five diagonals: ``lower2[:, :, k]``
couples block-row ``k`` to block-col ``k - 2`` (entries 0, 1 unused),
``upper2`` to ``k + 2`` (entries n-2, n-1 unused).

Only ``A`` is pentadiagonal: G, D, C and their Galerkin projections stay
block-tridiagonal, so the solver needs the matvec, the diagonal blocks (the
smoother) and a direct solve, the latter by *pair-merging* adjacent blocks
into a tridiagonal operator of block size ``2 bs``
(``ops.coarse_solve.make_penta_coarse_solver``).  No fused kernel takes a
pentadiagonal level: it smooths in plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_tridiag import BlockTridiag, block_mul
from .shifts import shift


class BlockPenta(NamedTuple):
    lower2: torch.Tensor  # (bs, bs, n) couples row k to col k-2
    lower: torch.Tensor  # (bs, bs, n) couples row k to col k-1
    diag: torch.Tensor  # (bs, bs, n)
    upper: torch.Tensor  # (bs, bs, n) couples row k to col k+1
    upper2: torch.Tensor  # (bs, bs, n) couples row k to col k+2

    @property
    def block_size(self) -> int:
        return self.diag.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.diag.shape[2]

    @property
    def n_dof(self) -> int:
        return self.diag.shape[0] * self.diag.shape[2]


_OFFSETS = (-2, -1, 0, 1, 2)  # of the fields, in order


def bp5_matvec(a: BlockPenta, x: torch.Tensor, left=None, right=None) -> torch.Tensor:
    """``y[:, k] = sum_d A[k, k+d] x_{k+d}`` over d in [-2, 2]; x is ``(bs, n)``.
    ``left`` / ``right`` are the two columns beyond x's first and last where
    the caller has them (a shard's, from its neighbours); by default zeros."""
    if left is None:
        xs = {d: shift(x, d) for d in (-2, -1, 1, 2)}
    else:
        xe = torch.cat([left, x, right], dim=-1)
        n = x.shape[-1]
        xs = {d: xe[..., 2 + d : 2 + d + n] for d in (-2, -1, 1, 2)}
    y = torch.einsum("ijn,jn->in", a.diag, x)
    y = y + torch.einsum("ijn,jn->in", a.lower, xs[-1])
    y = y + torch.einsum("ijn,jn->in", a.upper, xs[+1])
    y = y + torch.einsum("ijn,jn->in", a.lower2, xs[-2])
    y = y + torch.einsum("ijn,jn->in", a.upper2, xs[+2])
    return y


def bt_as_penta(a: BlockTridiag) -> BlockPenta:
    z = torch.zeros_like(a.diag)
    return BlockPenta(lower2=z, lower=a.lower, diag=a.diag, upper=a.upper, upper2=z)


def bp5_sub(a: BlockPenta, b: BlockPenta) -> BlockPenta:
    return BlockPenta(*(x - y for x, y in zip(a, b)))


def bt_mul_bt_full(a: BlockTridiag, b: BlockTridiag) -> BlockPenta:
    """``A @ B`` of two block-tridiagonals, keeping the distance-2 blocks that
    :func:`~.block_tridiag.bt_mul_bt` does not form."""
    mm = block_mul
    diag = mm(a.lower, shift(b.upper, -1)) + mm(a.diag, b.diag) + mm(a.upper, shift(b.lower, +1))
    lower = mm(a.lower, shift(b.diag, -1)) + mm(a.diag, b.lower)
    upper = mm(a.diag, b.upper) + mm(a.upper, shift(b.diag, +1))
    lower2 = mm(a.lower, shift(b.lower, -1))
    upper2 = mm(a.upper, shift(b.upper, +1))
    return BlockPenta(lower2=lower2, lower=lower, diag=diag, upper=upper, upper2=upper2)


def bp5_diag_blocks(a: BlockPenta) -> torch.Tensor:
    return a.diag


def bp5_to_dense(a: BlockPenta) -> torch.Tensor:
    """Materialize dense (tests / small coarse factorization only)."""
    bs, n = a.block_size, a.n_blocks
    dev = a.diag.device
    blocks = torch.zeros((n, bs, n, bs), dtype=a.diag.dtype, device=dev)  # [k, i, m, j]
    for d, mat in zip(_OFFSETS, a):
        k = torch.arange(max(0, -d), n - max(0, d), device=dev)
        blocks[k, :, k + d, :] = torch.movedim(mat[:, :, k], -1, 0)
    return blocks.reshape(n * bs, n * bs)


def bp5_pair_merge(a: BlockPenta) -> BlockTridiag:
    """Re-block a pentadiagonal operator into a tridiagonal one of block size
    ``2 bs`` by merging adjacent block pairs; an odd ``n`` pads one trailing
    identity block (the matching rhs padding is zero, see
    ``ops.coarse_solve.PaddedBTCoarseSolver``).  Host NumPy, setup only; the
    result lies on ``a``'s device."""
    bs, n = a.block_size, a.n_blocks
    n_pad = n + (n % 2)
    m = {}
    for d, mat in zip(_OFFSETS, a):
        x = np.zeros((bs, bs, n_pad), dtype=np.float64)
        x[:, :, :n] = mat.detach().cpu().double().numpy()
        # zero the convention-unused band slots so nothing stale merges in
        x[:, :, : max(0, -d)] = 0.0
        if d > 0:
            x[:, :, n_pad - d :] = 0.0
        m[d] = x
    if n_pad != n:
        m[0][:, :, n] = np.eye(bs)  # inert padding row (its rhs is zero)

    n2 = n_pad // 2
    diag = np.zeros((2 * bs, 2 * bs, n2))
    lower = np.zeros_like(diag)
    upper = np.zeros_like(diag)
    lo, hi = slice(0, bs), slice(bs, 2 * bs)
    ev = (slice(None), slice(None), slice(0, None, 2))
    od = (slice(None), slice(None), slice(1, None, 2))
    # merged block j spans fine blocks (2j, 2j+1); a fine coupling row k ->
    # col k+d lands at merged offset (k+d)//2 - k//2, sub-slot (k%2, (k+d)%2)
    lower[lo, lo, :] = m[-2][ev]
    lower[lo, hi, :] = m[-1][ev]
    diag[lo, lo, :] = m[0][ev]
    diag[lo, hi, :] = m[1][ev]
    upper[lo, lo, :] = m[2][ev]
    lower[hi, hi, :] = m[-2][od]
    diag[hi, lo, :] = m[-1][od]
    diag[hi, hi, :] = m[0][od]
    upper[hi, lo, :] = m[1][od]
    upper[hi, hi, :] = m[2][od]
    t = lambda x: torch.from_numpy(x).to(device=a.diag.device, dtype=a.diag.dtype)  # noqa: E731
    return BlockTridiag(t(lower), t(diag), t(upper))
