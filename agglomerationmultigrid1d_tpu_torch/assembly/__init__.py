from .agg_assembly import agg_flux_operators
from .cg_assembly import cg_stiffness_and_rhs
from .dg_assembly import dg_flux_operators, dg_flux_rhs, dg_load_vector

__all__ = [
    "agg_flux_operators",
    "cg_stiffness_and_rhs",
    "dg_flux_operators",
    "dg_flux_rhs",
    "dg_load_vector",
]
