"""Entry ``multigrid_mixed``: ``models.multigrid_mixed(h, h_low, 0, b,
**args)``, float32 V-cycles (kernels K1-K3 on the card) inside a float64
refinement; ``h_low`` is made once, in set-up.  Cycles: every float32
V-cycle (``inner_cycles``)."""

from __future__ import annotations

import torch

FORM = "hierarchy"


def prepare(prob, args: dict) -> dict:
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy

    return dict(h=prob.hierarchy, h_low=make_low_precision_hierarchy(prob.hierarchy))


def inputs(state: dict, b64: torch.Tensor):
    return b64


def solve(state: dict, b, args: dict) -> tuple:
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    res = solvers.multigrid_mixed(state["h"], state["h_low"], torch.zeros_like(b), b, **args)
    return res.x, int(res.inner_cycles)


def warmup(state: dict, b, args: dict, warm: dict) -> None:
    solve(state, b, {**args, **warm})
