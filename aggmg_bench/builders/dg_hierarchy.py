"""Builder ``dg_hierarchy``: ``models.poisson_dg_hierarchy(**args)``, the
DG-topped hierarchy assembled on the host in float64 and moved to the card
in one pass, as its users call it.  The problem is a ``models.Problem``."""

from __future__ import annotations

import torch

from aggmg_bench.reference import Columns

FORM = "hierarchy"


def build(cfg: dict, device):
    from agglomerationmultigrid1d_tpu_torch.models import poisson_dg_hierarchy

    return poisson_dg_hierarchy(**cfg["builder_args"], device=device)


def snapshot(prob) -> dict:
    """The fine operator and the right-hand side the set-up built, on the
    host, so the reference can judge them once the program is freed."""
    a = prob.hierarchy.levels[0].a
    parts = (t.detach().to("cpu", torch.float64) for t in (a.lower, a.diag, a.upper))
    return dict(operator=Columns(parts), rhs=prob.b.detach().to("cpu", torch.float64))
