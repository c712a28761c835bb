from .interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
    cg_cg_interpolation,
    dg_cg_interpolation,
    dg_dg_interpolation,
)
from .scattered_transfer import (
    ScatteredProlong,
    scattered_dg_interpolation,
    scattered_galerkin,
    scattered_scattered_interpolation,
    sp_prolong,
    sp_restrict,
)

__all__ = [
    "aggdg_aggdg_interpolation",
    "aggdg_cg_interpolation",
    "aggdg_dg_interpolation",
    "cg_cg_interpolation",
    "dg_cg_interpolation",
    "dg_dg_interpolation",
    "ScatteredProlong",
    "scattered_dg_interpolation",
    "scattered_galerkin",
    "scattered_scattered_interpolation",
    "sp_prolong",
    "sp_restrict",
]
