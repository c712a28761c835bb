from .agg_mesh import AggMesh, coarsen_agg_mesh, make_agg_mesh
from .cg_mesh import CgMesh, make_cg_mesh
from .dg_mesh import DgMesh, make_dg_mesh, normalize_switch
from .scattered_agg import ScatteredAggMesh, coarsen_scattered_agg_mesh, make_scattered_agg_mesh
from .topology import (
    DIRICHLET,
    NEUMANN,
    BoundaryCondition,
    Mesh1D,
    create_graded_mesh,
    create_uniform_mesh,
)

__all__ = [
    "AggMesh",
    "coarsen_agg_mesh",
    "make_agg_mesh",
    "CgMesh",
    "make_cg_mesh",
    "DgMesh",
    "make_dg_mesh",
    "normalize_switch",
    "ScatteredAggMesh",
    "coarsen_scattered_agg_mesh",
    "make_scattered_agg_mesh",
    "DIRICHLET",
    "NEUMANN",
    "BoundaryCondition",
    "Mesh1D",
    "create_graded_mesh",
    "create_uniform_mesh",
]
