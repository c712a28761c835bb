from .config import CycleParams, HierarchySpec, SolveParams
from .precision import hierarchy_astype, tree_map, tree_to

__all__ = [
    "CycleParams",
    "HierarchySpec",
    "SolveParams",
    "hierarchy_astype",
    "tree_map",
    "tree_to",
]
