"""Zero-padded shifts along the trailing (element) axis.

Every operator is block-tridiagonal, so a matvec touches at most the +-1
neighbour; this is the only neighbour primitive the solver needs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """``out[..., k] = x[..., k + d]`` with zero fill outside the range.

    ``d = +1`` pulls the right neighbour, ``d = -1`` the left neighbour.
    """
    if d == 0:
        return x
    n = x.shape[-1]
    if d > 0:
        return F.pad(x[..., d:], (0, d))
    return F.pad(x[..., : n + d], (-d, 0))
