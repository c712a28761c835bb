from .dg_assembly import dg_flux_operators, dg_flux_rhs, dg_load_vector

__all__ = ["dg_flux_operators", "dg_flux_rhs", "dg_load_vector"]
