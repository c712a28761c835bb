from .interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
    cg_cg_interpolation,
    dg_cg_interpolation,
    dg_dg_interpolation,
)

__all__ = [
    "aggdg_aggdg_interpolation",
    "aggdg_cg_interpolation",
    "aggdg_dg_interpolation",
    "cg_cg_interpolation",
    "dg_cg_interpolation",
    "dg_dg_interpolation",
]
