"""Entry ``handover``: ``models.solvers._mixed_loop_ff(h_low, a_ffs[0], 0,
b_ff, 1 / ||b||, ffops=ffops, **args)``, the guarded float-float refinement
(float32 inner V-cycles through K5 / K5r, K6 defects) that hands over to
the TRUE-precision cycles, on a ``build_xl_problem(..., ff_levels=True)``
bundle.  The answer is the float-float pair it returns.  Cycles: every
V-cycle, the guarded phase's float32 ones and the true ones."""

from __future__ import annotations

import numpy as np
import torch

FORM = "xl"


def prepare(prob, args: dict) -> dict:
    return dict(h_low=prob[0], ffops=prob[1])


def inputs(state: dict, b64: torch.Tensor):
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_split

    return ff_split(b64), float(torch.linalg.vector_norm(b64))


def solve(state: dict, rhs, args: dict) -> tuple:
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    b_ff, norm_b = rhs
    zero = torch.zeros_like(b_ff.hi)
    ffops = state["ffops"]
    x_ff, _, cycles, _ = solvers._mixed_loop_ff(
        state["h_low"], ffops.a_ffs[0], FF(zero, zero), b_ff, np.float32(1.0 / norm_b), ffops=ffops, **args
    )
    return (x_ff.hi, x_ff.lo), int(cycles)


def warmup(state: dict, rhs, args: dict, warm: dict) -> None:
    """The guarded phase cut to ``warm["maxiter"]`` steps, then the true
    cycle's shapes through ``multigrid_true`` cut to ``warm["true_cycles"]``."""
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    solve(state, rhs, {**args, "maxiter": warm["maxiter"]})
    b_ff, norm_b = rhs
    solvers.multigrid_true(state["h_low"], state["ffops"], b_ff, norm_b, maxiter=warm["true_cycles"],
                           tol=args["tol"])
