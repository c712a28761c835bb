"""Entry ``multigrid``: ``models.multigrid(h, 0, b, **args)``, the float64
V-cycle iteration (the reference solver's own solve; no hand-written kernel
runs on float64 levels).  Cycles: its iterations, one V-cycle each."""

from __future__ import annotations

import torch

FORM = "hierarchy"


def prepare(prob, args: dict) -> dict:
    return dict(h=prob.hierarchy)


def inputs(state: dict, b64: torch.Tensor):
    return b64


def solve(state: dict, b, args: dict) -> tuple:
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    res = solvers.multigrid(state["h"], torch.zeros_like(b), b, **args)
    return res.x, int(res.iterations)


def warmup(state: dict, b, args: dict, warm: dict) -> None:
    solve(state, b, {**args, **warm})
