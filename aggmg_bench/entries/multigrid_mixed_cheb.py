"""Entry ``multigrid_mixed_cheb``: ``models.multigrid_mixed`` as the entry
``multigrid_mixed`` runs it, on the hierarchy after
``chebyshev_hierarchy(h)`` (its defaults: ratio 4, 20 power iterations,
safety 1.05; the power iteration runs in set-up): float32 Chebyshev
V-cycles, K5 / K5r on the card, inside a float64 refinement.  Cycles:
every float32 V-cycle (``inner_cycles``)."""

from __future__ import annotations

from aggmg_bench.entries.multigrid_mixed import FORM, inputs, solve, warmup  # noqa: F401


def prepare(prob, args: dict) -> dict:
    from agglomerationmultigrid1d_tpu_torch.models import chebyshev_hierarchy, make_low_precision_hierarchy

    h = chebyshev_hierarchy(prob.hierarchy)
    return dict(h=h, h_low=make_low_precision_hierarchy(h))
