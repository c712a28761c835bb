"""Block-diagonal operators with a uniform block size, in SoA layout.

Blocks are stored as ``(bs, bs, n)`` with the element axis trailing, the same
layout as the JAX package, so the two can be compared array for array.  The
inverse and the solves are setup and analysis helpers: they run in the
blocks' own precision on the blocks' device, batched over ``n``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BlockDiag(NamedTuple):
    """Uniform block-diagonal operator; ``blocks[i, j, k]`` = entry (i, j) of block k."""

    blocks: torch.Tensor  # (bs, bs, n)

    @property
    def block_size(self) -> int:
        return self.blocks.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_dof(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[2]


def bd_from_dense_blocks(blocks_nij: torch.Tensor) -> BlockDiag:
    """Build from an ``(n, bs, bs)`` (batch-leading) block stack."""
    return BlockDiag(torch.movedim(blocks_nij, 0, -1).contiguous())


def bd_to_dense_blocks(bd: BlockDiag) -> torch.Tensor:
    """The blocks as ``(n, bs, bs)``."""
    return torch.movedim(bd.blocks, -1, 0)


def bd_matvec(bd: BlockDiag, x: torch.Tensor) -> torch.Tensor:
    """``y[:, k] = blocks[:, :, k] @ x[:, k]`` for ``x`` of shape ``(bs, n)``;
    on the card one launch of ``bd_gemv_kernel`` (``ops.kernels.block_kernels.bd_gemv``)."""
    if x.is_cuda:
        from .kernels.block_kernels import bd_gemv  # block_kernels imports this module's package

        return bd_gemv(bd.blocks, x)
    return torch.einsum("ijn,jn->in", bd.blocks, x)


def bd_inverse(bd: BlockDiag) -> BlockDiag:
    """Explicit per-block inverse (LU with partial pivoting per block)."""
    return bd_from_dense_blocks(torch.linalg.inv(bd_to_dense_blocks(bd)))


def bd_solve(bd: BlockDiag, x: torch.Tensor) -> torch.Tensor:
    """Solve ``blocks @ y = x`` per block, ``x`` of shape ``(bs, n)``."""
    return torch.linalg.solve(bd_to_dense_blocks(bd), x.T.unsqueeze(-1))[..., 0].T


def bd_solve_mat(bd: BlockDiag, rhs_nij: torch.Tensor) -> torch.Tensor:
    """Per-block solve with a matrix right-hand side ``(n, bs, m)`` -> ``(n, bs, m)``."""
    return torch.linalg.solve(bd_to_dense_blocks(bd), rhs_nij)


def bd_to_dense(bd: BlockDiag) -> torch.Tensor:
    """Materialize the full dense matrix (tests and analysis only)."""
    return torch.block_diag(*bd_to_dense_blocks(bd))
