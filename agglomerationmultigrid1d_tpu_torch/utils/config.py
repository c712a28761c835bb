"""Configuration dataclasses (the reference keeps these as script-top globals,
e.g. ``tests/full_heirarchy_test.jl:8-34``; defaults mirror the reference's
keyword defaults: nPre = nPost = 3, alpha = 2/3 (``solvers.jl:19-20``),
CDir = 1.0 (``mesh_heirarchy.jl:31``))."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CycleParams:
    n_pre: int = 3
    n_post: int = 3
    alpha: float = 2.0 / 3.0


@dataclasses.dataclass(frozen=True)
class SolveParams:
    maxiter: int = 100
    tol: float = 1e-10
    compute_error: bool = True


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Level plan: CG orders fine->coarse, DG orders, agglomeration factors."""

    cg_orders: tuple[int, ...] = (8, 4, 2, 1)
    dg_orders: tuple[int, ...] = ()
    n_agg_levels: int = 0
    p_agg: int = 1
    first_agg_factor: int = 4  # base elements per first-level agglomerate
    agg_factor: int = 2  # grouping factor of subsequent agg levels
    c_dir: float = 1.0
    cg_smoother: str = "jac"
