"""Block-diagonal operators with a uniform block size, in SoA layout.

Blocks are stored as ``(bs, bs, n)`` with the element axis trailing, the same
layout as the JAX package, so the two can be compared array for array.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BlockDiag(NamedTuple):
    """Uniform block-diagonal operator; ``blocks[i, j, k]`` = entry (i, j) of block k."""

    blocks: torch.Tensor  # (bs, bs, n)


def bd_matvec(bd: BlockDiag, x: torch.Tensor) -> torch.Tensor:
    """``y[:, k] = blocks[:, :, k] @ x[:, k]`` for ``x`` of shape ``(bs, n)``."""
    return torch.einsum("ijn,jn->in", bd.blocks, x)
