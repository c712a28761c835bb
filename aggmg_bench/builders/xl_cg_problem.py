"""Builder ``xl_cg_problem``: ``models.build_xl_problem(spec, n,
ff_levels=True)`` of a CG-topped chain, the stencil-inflated build on the
card (``builders/xl_problem.py``'s ``build``).  The problem is the tuple ``(h_low, ffops, b_ff, norm_b)``: the float32
hierarchy, the ``FFOps`` whose ``a_ffs[0]`` is the fine operator (a
``CgBandFF``, the ``(2p+1, N)`` band as a float-float pair), and the flat
``(N,)`` right-hand side as a float-float pair."""

from __future__ import annotations

import torch

from aggmg_bench.builders.xl_problem import build  # noqa: F401  (the same call, a CG-topped spec)
from aggmg_bench.reference import Columns

FORM = "xl_cg"


def _joined(pair) -> torch.Tensor:
    return pair.hi.detach().to("cpu", torch.float64) + pair.lo.detach().to("cpu", torch.float64)


def snapshot(prob) -> dict:
    """The fine band (hi + lo joined in float64 on the host), read by node
    columns, and the program's own right-hand side as ``(1, N)``."""
    band = prob[1].a_ffs[0]
    if band.hi.ndim != 2:
        raise ValueError("the xl_cg_problem snapshot reads a CG band fine operator (cg_orders non-empty)")
    return dict(operator=Columns((_joined(band),)), rhs=_joined(prob[2]).reshape(1, -1))
