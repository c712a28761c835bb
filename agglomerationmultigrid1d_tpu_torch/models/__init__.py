from .hierarchy import BlockLevel, Hierarchy, build_dg_hierarchy, prepare_fast_smoothers, schur_stiffness
from .problems import Problem, build_problem, default_model_problem, poisson_dg_hierarchy
from .solvers import (
    MultigridResult,
    make_low_precision_hierarchy,
    mg_preconditioner,
    multigrid,
    multigrid_mixed,
    v_cycle,
)

__all__ = [
    "BlockLevel",
    "Hierarchy",
    "build_dg_hierarchy",
    "prepare_fast_smoothers",
    "schur_stiffness",
    "Problem",
    "build_problem",
    "default_model_problem",
    "poisson_dg_hierarchy",
    "MultigridResult",
    "make_low_precision_hierarchy",
    "mg_preconditioner",
    "multigrid",
    "multigrid_mixed",
    "v_cycle",
]
