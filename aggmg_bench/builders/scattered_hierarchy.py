"""Builder ``scattered_hierarchy``: ``models.poisson_scattered_hierarchy``
with the configuration's partition (``"interleaved_pairs"``:
``interleaved_pair_groups(n, coarsest)``), the DG-topped chain of scattered
agglomerates assembled on the host in float64 and moved to the card in one
pass, as its users call it.  The problem is a ``models.Problem``; its
snapshot is the fine operator and right-hand side, as ``dg_hierarchy``'s."""

from __future__ import annotations

from aggmg_bench.builders.dg_hierarchy import snapshot  # noqa: F401  (the harness reads it here)

FORM = "hierarchy"


def build(cfg: dict, device):
    from agglomerationmultigrid1d_tpu_torch.models import interleaved_pair_groups, poisson_scattered_hierarchy

    part = cfg["partition"]
    if part["kind"] != "interleaved_pairs":
        raise ValueError(f"unknown partition {part['kind']!r}")
    args = cfg["builder_args"]
    groups = interleaved_pair_groups(args["n"], part["coarsest"])
    return poisson_scattered_hierarchy(**args, groups_per_level=groups, device=device)
