from .config import CycleParams, HierarchySpec, SolveParams
from .precision import hierarchy_astype, tree_astype, tree_map, tree_to
from .checkpoint import load_solver_state, save_solver_state
from .profiling import device_trace, span, sync

__all__ = [
    "CycleParams",
    "HierarchySpec",
    "SolveParams",
    "hierarchy_astype",
    "tree_astype",
    "tree_map",
    "tree_to",
    "load_solver_state",
    "save_solver_state",
    "device_trace",
    "span",
    "sync",
]
