"""Entry ``multigrid_true``: ``models.multigrid_true(h_low, ffops, b_ff,
norm_b, **args)``, the TRUE-precision progressive cycles on a
``build_xl_problem(..., ff_levels=True)`` bundle (kernel K6 for the
stencil fine level's defects).  The right-hand side is handed over as the
float-float split of the float64 vector and its norm, made in set-up.
Cycles: its iterations, one V-cycle each."""

from __future__ import annotations

import torch

FORM = "xl"


def prepare(prob, args: dict) -> dict:
    return dict(h_low=prob[0], ffops=prob[1])


def inputs(state: dict, b64: torch.Tensor):
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_split

    return ff_split(b64), float(torch.linalg.vector_norm(b64))


def solve(state: dict, rhs, args: dict) -> tuple:
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    b_ff, norm_b = rhs
    res = solvers.multigrid_true(state["h_low"], state["ffops"], b_ff, norm_b, **args)
    return res.x, int(res.iterations)


def warmup(state: dict, rhs, args: dict, warm: dict) -> None:
    solve(state, rhs, {**args, **warm})
