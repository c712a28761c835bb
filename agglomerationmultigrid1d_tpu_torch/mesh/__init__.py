from .agg_mesh import AggMesh, coarsen_agg_mesh, make_agg_mesh
from .cg_mesh import CgMesh, make_cg_mesh
from .dg_mesh import DgMesh, make_dg_mesh, normalize_switch
from .topology import BoundaryCondition, Mesh1D, create_uniform_mesh

__all__ = [
    "AggMesh",
    "coarsen_agg_mesh",
    "make_agg_mesh",
    "CgMesh",
    "make_cg_mesh",
    "DgMesh",
    "make_dg_mesh",
    "normalize_switch",
    "BoundaryCondition",
    "Mesh1D",
    "create_uniform_mesh",
]
