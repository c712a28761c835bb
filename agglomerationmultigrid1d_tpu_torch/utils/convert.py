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

from ..models.hierarchy import BlockLevel, CgLevel, Hierarchy, _chebyshev_table
from ..ops.block_tridiag import BlockTridiag
from ..ops.cg_operator import CgOperator
from ..ops.coarse_solve import CoarseSolver
from ..ops.transfer_ops import BlockProlong, CgProlong, SeamProlong
from ..smoothers.smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    JacobiSmoother,
    SchwarzSmoother,
)


def hierarchy_from_numpy(h, device="cpu", dtype: torch.dtype | None = None) -> Hierarchy:
    """Duck-typed conversion.  Reads ``levels`` — block levels with ``a``,
    ``g``, ``d``, ``c`` as ``lower/diag/upper`` and ``mass_inv``, CG levels
    with ``a`` as ``windows/band`` — each with a ``smoother`` (block-Jacobi
    ``inv/ml/mu``, Jacobi ``inv_diag``, Schwarz ``inv_windows/mult_inv``, or a
    Chebyshev ``base/lam_lo/lam_hi`` over one of them); ``transfers`` (block
    ``blocks``, CG ``e``, seam ``n_win/inv_lump``); and ``coarse``
    (``a_dense``, ``a_inv``).  ``dtype`` None keeps each array's own
    precision; a float32 Chebyshev level gets its recurrence table."""

    def t(x):
        if x is None:
            return None
        out = torch.tensor(np.asarray(x), device=device)  # copies: the source may be read-only
        return out if dtype is None else out.to(dtype)

    def bt(op) -> BlockTridiag:
        return BlockTridiag(lower=t(op.lower), diag=t(op.diag), upper=t(op.upper))

    def smoother(s):
        if hasattr(s, "base"):
            cheb = ChebyshevSmoother(base=smoother(s.base), lam_lo=t(s.lam_lo), lam_hi=t(s.lam_hi))
            if cheb.lam_hi.dtype == torch.float32:
                cheb = cheb._replace(coef=_chebyshev_table(cheb))
            return cheb
        if hasattr(s, "inv_diag"):
            return JacobiSmoother(inv_diag=t(s.inv_diag))
        if hasattr(s, "inv_windows"):
            return SchwarzSmoother(inv_windows=t(s.inv_windows), mult_inv=t(s.mult_inv))
        return BlockJacobiSmoother(
            inv=t(s.inv), ml=t(getattr(s, "ml", None)), mu=t(getattr(s, "mu", None))
        )

    def level(lv):
        if hasattr(lv, "g"):
            return BlockLevel(
                a=bt(lv.a), g=bt(lv.g), d=bt(lv.d), c=bt(lv.c), mass_inv=t(lv.mass_inv),
                smoother=smoother(lv.smoother),
            )
        return CgLevel(a=CgOperator(windows=t(lv.a.windows), band=t(lv.a.band)),
                       smoother=smoother(lv.smoother))

    def transfer(tr):
        if getattr(tr, "sizes", None) is not None or getattr(tr, "offsets", None) is not None:
            raise NotImplementedError(
                "ragged transfers are not ported yet (ROADMAP queue 1, item 14)"
            )
        if hasattr(tr, "e"):
            return CgProlong(e=t(tr.e))
        if hasattr(tr, "n_win"):
            return SeamProlong(n_win=t(tr.n_win), inv_lump=t(tr.inv_lump))
        return BlockProlong(t(tr.blocks))

    coarse = CoarseSolver(a_dense=t(h.coarse.a_dense), a_inv=t(h.coarse.a_inv))
    return Hierarchy(
        levels=tuple(level(lv) for lv in h.levels),
        transfers=tuple(transfer(tr) for tr in h.transfers),
        coarse=coarse,
    )
