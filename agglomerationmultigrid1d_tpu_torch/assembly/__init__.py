from .agg_assembly import agg_flux_operators
from .cg_assembly import cg_stiffness_and_rhs
from .dg_assembly import dg_flux_operators, dg_flux_rhs, dg_load_vector
from .scattered_assembly import (
    scattered_flux_operators,
    scattered_flux_rhs,
    scattered_load_vector,
    scattered_schur,
)

__all__ = [
    "agg_flux_operators",
    "cg_stiffness_and_rhs",
    "dg_flux_operators",
    "dg_flux_rhs",
    "dg_load_vector",
    "scattered_flux_operators",
    "scattered_flux_rhs",
    "scattered_load_vector",
    "scattered_schur",
]
