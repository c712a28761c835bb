"""Hand a hierarchy built by another package to this one.

:func:`hierarchy_from_numpy` reads a hierarchy whose leaves are NumPy arrays —
for example the JAX package's ``Hierarchy`` after
``jax.tree_util.tree_map(np.asarray, h)`` — by field name alone, so this
module never imports the other package.  The tests use it to feed one
hierarchy to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hierarchy import BlockLevel, Hierarchy
from ..ops.block_tridiag import BlockTridiag
from ..ops.coarse_solve import CoarseSolver
from ..ops.transfer_ops import BlockProlong
from ..smoothers.smoother import BlockJacobiSmoother


def hierarchy_from_numpy(h, device="cpu", dtype: torch.dtype | None = None) -> Hierarchy:
    """Duck-typed conversion: reads ``levels`` (each with ``a``, ``g``, ``d``,
    ``c`` as ``lower/diag/upper``, ``mass_inv`` and ``smoother.inv/ml/mu``),
    ``transfers`` (each with ``blocks``) and ``coarse`` (``a_dense``,
    ``a_inv``).  ``dtype`` None keeps each array's own precision."""

    def t(x):
        if x is None:
            return None
        out = torch.tensor(np.asarray(x), device=device)  # copies: the source may be read-only
        return out if dtype is None else out.to(dtype)

    def bt(op) -> BlockTridiag:
        return BlockTridiag(lower=t(op.lower), diag=t(op.diag), upper=t(op.upper))

    levels = []
    for lv in h.levels:
        s = lv.smoother
        levels.append(
            BlockLevel(
                a=bt(lv.a), g=bt(lv.g), d=bt(lv.d), c=bt(lv.c), mass_inv=t(lv.mass_inv),
                smoother=BlockJacobiSmoother(
                    inv=t(s.inv), ml=t(getattr(s, "ml", None)), mu=t(getattr(s, "mu", None))
                ),
            )
        )
    transfers = tuple(BlockProlong(t(tr.blocks)) for tr in h.transfers)
    coarse = CoarseSolver(a_dense=t(h.coarse.a_dense), a_inv=t(h.coarse.a_inv))
    return Hierarchy(levels=tuple(levels), transfers=transfers, coarse=coarse)
