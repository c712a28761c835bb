"""Entry ``handover_cg``: the hand-over of ``entries/handover.py``
(``models.solvers._mixed_loop_ff(h_low, a_ffs[0], 0, b_ff, 1 / ||b||,
ffops=ffops, **args)``, the guarded float-float refinement handing over to
the TRUE-precision cycles) on a CG-topped ``build_xl_problem(...,
ff_levels=True)`` bundle, which solves on the flat ``(N,)`` node vector: the
generator's ``(1, N)`` right-hand side is flattened first.  The answer is
the float-float pair; cycles: every V-cycle, float32 and true."""

from __future__ import annotations

import torch

from aggmg_bench.entries import handover

FORM = "xl_cg"

prepare = handover.prepare
solve = handover.solve
warmup = handover.warmup


def inputs(state: dict, b64: torch.Tensor):
    return handover.inputs(state, b64.reshape(-1))
