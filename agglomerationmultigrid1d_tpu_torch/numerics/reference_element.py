"""Order-p nodal reference element on [-1, 1] (host-side NumPy tables).

Mirrors ``src/reference_element.jl:15-54`` exactly in its *slot* convention:

* slot 0 is the left endpoint (-1), slot 1 the right endpoint (+1), and slots
  2..p are the interior Chebyshev points ``cos(pi * i / p)``, i = 1..p-1, which run
  in *descending* x.  (The reference is 1-based; we use 0-based slots.)
* the nodal basis is defined through the inverse Legendre Vandermonde
  (``mBasisFunCoeff = inv(V)``, ``reference_element.jl:29``), and basis/derivative
  tables are evaluated at the Gauss rule of precision ``2p``.

We additionally precompute ``slot_to_pos`` — the permutation from slot order to
left-to-right ("grid") order — which the CG discretization uses for its
spatially-sorted global node numbering (the reference instead appends interior
nodes after all vertices, ``src/cg_mesh.jl:35-45``; the two orderings differ by a
permutation only).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .legendre import legendre_vals, legendre_vals_and_derivs
from .quadrature import gauss_quad


@dataclasses.dataclass(frozen=True)
class ReferenceElement:
    p: int
    nodes_x: np.ndarray  # (p+1,) slot order
    quad_nodes: np.ndarray  # (n_q,)
    quad_weights: np.ndarray  # (n_q,)
    basis_coeff: np.ndarray  # (p+1, p+1); column i = Legendre coeffs of basis fn i
    basis_at_quad: np.ndarray  # (n_q, p+1)
    deriv_at_quad: np.ndarray  # (n_q, p+1)
    mass: np.ndarray  # (p+1, p+1)  reference mass matrix
    slot_to_pos: np.ndarray  # (p+1,) int; grid position of each slot
    pos_to_slot: np.ndarray  # (p+1,) int; slot of each grid position

    @property
    def n_quad(self) -> int:
        return self.quad_nodes.shape[0]


def make_reference_element(p: int) -> ReferenceElement:
    if p >= 1:
        nodes = np.concatenate(
            [[-1.0, 1.0], np.cos(np.pi * np.arange(1, p) / p)]
        )
    else:
        nodes = np.array([0.0])

    vand = legendre_vals(nodes, p)  # (p+1, p+1)
    coeff = np.linalg.inv(vand)

    qx, qw = gauss_quad(2 * p)
    basis_q, deriv_q = evaluate_nodal_basis_and_deriv(coeff, qx)

    # reference mass by quadrature (symmetric by construction here; the reference
    # fills the upper triangle then mirrors, producing identical values)
    mass = np.einsum("l,li,lj->ij", qw, basis_q, basis_q)
    mass = 0.5 * (mass + mass.T)

    # slot -> left-to-right grid position.  slots: [-1, +1, desc interior...]
    order = np.argsort(nodes, kind="stable")  # positions -> slot
    pos_to_slot = order.astype(np.int64)
    slot_to_pos = np.empty_like(pos_to_slot)
    slot_to_pos[pos_to_slot] = np.arange(p + 1)

    return ReferenceElement(
        p=p,
        nodes_x=nodes,
        quad_nodes=qx,
        quad_weights=qw,
        basis_coeff=coeff,
        basis_at_quad=basis_q,
        deriv_at_quad=deriv_q,
        mass=mass,
        slot_to_pos=slot_to_pos,
        pos_to_slot=pos_to_slot,
    )


def evaluate_nodal_basis(coeff: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of every nodal basis function at points ``x``; shape ``(len(x), p+1)``.

    Mirrors ``src/reference_element.jl:60-73``.
    """
    p = coeff.shape[0] - 1
    leg = legendre_vals(x, p)  # (nx, p+1) P_m values
    return leg @ coeff


def evaluate_nodal_basis_and_deriv(
    coeff: np.ndarray, x: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of every nodal basis function at points ``x``.

    Mirrors ``src/reference_element.jl:75-90``.
    """
    p = coeff.shape[0] - 1
    leg, dleg = legendre_vals_and_derivs(x, p)
    return leg @ coeff, dleg @ coeff
