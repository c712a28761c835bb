from .legendre import legendre_vals, legendre_vals_and_derivs
from .quadrature import gauss_quad
from .reference_element import (
    ReferenceElement,
    evaluate_nodal_basis,
    evaluate_nodal_basis_and_deriv,
    make_reference_element,
)
from .modal_basis import modal_basis_derivs, modal_basis_vals, modal_basis_vals_batched

__all__ = [
    "legendre_vals",
    "legendre_vals_and_derivs",
    "gauss_quad",
    "ReferenceElement",
    "make_reference_element",
    "evaluate_nodal_basis",
    "evaluate_nodal_basis_and_deriv",
    "modal_basis_vals",
    "modal_basis_vals_batched",
    "modal_basis_derivs",
]
