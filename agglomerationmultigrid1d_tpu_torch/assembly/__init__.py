from .agg_assembly import (
    agg_c_matrix,
    agg_divergence,
    agg_f_vector,
    agg_flux_operators,
    agg_flux_rhs,
    agg_gradient,
    agg_load_vector,
    agg_r_vector,
)
from .cg_assembly import cg_rhs, cg_stiffness, cg_stiffness_and_rhs
from .dg_assembly import (
    c_matrix,
    dg_flux_operators,
    dg_flux_rhs,
    dg_load_vector,
    divergence,
    f_vector,
    gradient,
    r_vector,
)
from .scattered_assembly import (
    scattered_flux_operators,
    scattered_flux_rhs,
    scattered_load_vector,
    scattered_schur,
)

__all__ = [
    "agg_c_matrix",
    "agg_divergence",
    "agg_f_vector",
    "agg_flux_operators",
    "agg_flux_rhs",
    "agg_gradient",
    "agg_load_vector",
    "agg_r_vector",
    "cg_rhs",
    "cg_stiffness",
    "cg_stiffness_and_rhs",
    "c_matrix",
    "dg_flux_operators",
    "dg_flux_rhs",
    "dg_load_vector",
    "divergence",
    "f_vector",
    "gradient",
    "r_vector",
    "scattered_flux_operators",
    "scattered_flux_rhs",
    "scattered_load_vector",
    "scattered_schur",
]
