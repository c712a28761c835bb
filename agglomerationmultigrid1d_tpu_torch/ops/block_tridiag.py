"""Block-tridiagonal operators with uniform block size, in SoA layout.

Every DG / agglomerated-DG operator (G, D, C, the Schur stiffness
``A = C - D M^-1 G`` and its Galerkin coarse versions) is stored as three
diagonals of shape ``(bs, bs, n)``:

* ``lower[:, :, k]`` couples block-row ``k`` to block-col ``k - 1`` (entry 0 unused),
* ``diag [:, :, k]`` the diagonal block,
* ``upper[:, :, k]`` couples block-row ``k`` to block-col ``k + 1`` (entry n-1 unused).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .block_diag import BlockDiag
from .shifts import shift


class BlockTridiag(NamedTuple):
    lower: torch.Tensor  # (bs, bs, n)
    diag: torch.Tensor  # (bs, bs, n)
    upper: torch.Tensor  # (bs, bs, n)

    @property
    def block_size(self) -> int:
        return self.diag.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.diag.shape[2]

    @property
    def n_dof(self) -> int:
        return self.diag.shape[0] * self.diag.shape[2]


def bt_zeros(bs: int, n: int, dtype=torch.float64, device="cuda") -> BlockTridiag:
    z = torch.zeros((bs, bs, n), dtype=dtype, device=device)
    return BlockTridiag(z, z, z)


def block_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched per-block product ``C[:, :, k] = A[:, :, k] @ B[:, :, k]`` on
    ``(bs, bs, n)`` tensors, summed over ``j`` in ascending order (the JAX
    package's order, so f64 setups agree to the last few bits)."""
    acc = a[:, 0, None, :] * b[None, 0, :, :]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j, None, :] * b[None, j, :, :]
    return acc


def bt_matvec(a: BlockTridiag, x: torch.Tensor, xm=None, xp=None) -> torch.Tensor:
    """``y[:, k] = lower_k x_{k-1} + diag_k x_k + upper_k x_{k+1}``; x is ``(bs, n)``.
    ``xm`` / ``xp`` are ``x_{k-1}`` / ``x_{k+1}`` where the caller has them
    (a shard's, with its neighbours' edge columns); by default the
    zero-padded shifts of ``x``."""
    y = torch.einsum("ijn,jn->in", a.diag, x)
    y = y + torch.einsum("ijn,jn->in", a.lower, shift(x, -1) if xm is None else xm)
    y = y + torch.einsum("ijn,jn->in", a.upper, shift(x, +1) if xp is None else xp)
    return y


def bt_add(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    return BlockTridiag(a.lower + b.lower, a.diag + b.diag, a.upper + b.upper)


def bt_sub(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    return BlockTridiag(a.lower - b.lower, a.diag - b.diag, a.upper - b.upper)


def bt_scale(a: BlockTridiag, s) -> BlockTridiag:
    return BlockTridiag(s * a.lower, s * a.diag, s * a.upper)


def bd_mul_bt(m: BlockDiag, a: BlockTridiag) -> BlockTridiag:
    """``M @ A`` with M block-diagonal: scales every diagonal by the row block."""
    mm = m.blocks
    return BlockTridiag(block_mul(mm, a.lower), block_mul(mm, a.diag), block_mul(mm, a.upper))


def bt_mul_bd(a: BlockTridiag, m: BlockDiag) -> BlockTridiag:
    """``A @ M`` with M block-diagonal: (AM)[k, k+d] = A[k, k+d] M[k+d]."""
    mm = m.blocks
    return BlockTridiag(
        block_mul(a.lower, shift(mm, -1)),
        block_mul(a.diag, mm),
        block_mul(a.upper, shift(mm, +1)),
    )


def bt_mul_bt(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    """``A @ B`` assuming the result is still block-tridiagonal.

    Structurally exact for the solver's one use, ``D @ (M^-1 G)``: D has only
    diag + upper and M^-1 G only diag + lower, so the distance-2 products
    vanish and are not formed.
    """
    #  C[k,k]   = L_a[k] U_b[k-1] + D_a[k] D_b[k] + U_a[k] L_b[k+1]
    diag = (
        block_mul(a.lower, shift(b.upper, -1))
        + block_mul(a.diag, b.diag)
        + block_mul(a.upper, shift(b.lower, +1))
    )
    #  C[k,k-1] = L_a[k] D_b[k-1] + D_a[k] L_b[k]
    lower = block_mul(a.lower, shift(b.diag, -1)) + block_mul(a.diag, b.lower)
    #  C[k,k+1] = D_a[k] U_b[k] + U_a[k] D_b[k+1]
    upper = block_mul(a.diag, b.upper) + block_mul(a.upper, shift(b.diag, +1))
    return BlockTridiag(lower, diag, upper)


def bt_distance2_residual(a: BlockTridiag, b: BlockTridiag) -> torch.Tensor:
    """Max |distance-2 blocks| of A @ B: ~0 where ``bt_mul_bt`` is exact."""
    lo2 = block_mul(a.lower, shift(b.lower, -1))
    up2 = block_mul(a.upper, shift(b.upper, +1))
    return torch.maximum(lo2.abs().max(), up2.abs().max())


def bt_diagonal(a: BlockTridiag) -> torch.Tensor:
    """Scalar main diagonal as ``(bs, n)``."""
    i = torch.arange(a.block_size, device=a.diag.device)
    return a.diag[i, i, :]


def bt_diag_blocks(a: BlockTridiag) -> BlockDiag:
    return BlockDiag(a.diag)


def bt_to_dense(a: BlockTridiag) -> torch.Tensor:
    """Materialize dense (tests / coarse-level factorization only)."""
    bs, n = a.block_size, a.n_blocks
    dev = a.diag.device
    # blocks[k, i, m, j] is dense entry (k*bs + i, m*bs + j)
    blocks = torch.zeros((n, bs, n, bs), dtype=a.diag.dtype, device=dev)
    k = torch.arange(n, device=dev)
    blocks[k, :, k, :] = torch.movedim(a.diag, -1, 0)
    if n > 1:
        blocks[k[1:], :, k[:-1], :] = torch.movedim(a.lower[:, :, 1:], -1, 0)
        blocks[k[:-1], :, k[1:], :] = torch.movedim(a.upper[:, :, :-1], -1, 0)
    return blocks.reshape(n * bs, n * bs)


def bt_from_dense(dense: torch.Tensor, bs: int) -> BlockTridiag:
    """Inverse of :func:`bt_to_dense` (tests; entries off the band are ignored)."""
    n = dense.shape[0] // bs
    blocks = dense.reshape(n, bs, n, bs)
    k = torch.arange(n, device=dense.device)
    diag = torch.movedim(blocks[k, :, k, :], 0, -1)
    lower = torch.zeros_like(diag)
    upper = torch.zeros_like(diag)
    if n > 1:
        lower[:, :, 1:] = torch.movedim(blocks[k[1:], :, k[:-1], :], 0, -1)
        upper[:, :, :-1] = torch.movedim(blocks[k[:-1], :, k[1:], :], 0, -1)
    return BlockTridiag(lower, diag.contiguous(), upper)
