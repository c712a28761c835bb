"""Continuous-Galerkin discretization mesh (order-p nodal Lagrange).

Node numbering is spatial ("grid order"): element k owns global nodes
``k*p .. k*p + p`` left to right, sharing endpoints with its neighbours.  The
reference numbers the vertices first and appends interior nodes per element;
the two differ by a permutation only, and every residual norm, iteration
count and L2 error is permutation-invariant.  The mass is kept as a banded
:class:`~..ops.cg_operator.CgOperator` plus its lumped (row-sum) vector, which
is all the hierarchy's seam transfers read.  Built on the host in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..numerics import make_reference_element
from ..ops.cg_operator import CgOperator, cg_from_windows
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class CgMesh:
    p: int
    mesh: Mesh1D
    ref: "object"  # ReferenceElement
    mass: CgOperator  # assembled mass, grid order
    lumped_mass: torch.Tensor  # (n_nodes,) row sums of the assembled mass

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    @property
    def n_nodes(self) -> int:
        return self.n_elements * self.p + 1

    def node_x(self) -> np.ndarray:
        """Grid-order coordinates of all global nodes."""
        p = self.p
        ref_pos = self.ref.nodes_x[self.ref.pos_to_slot]  # ascending in [-1, 1]
        xs = self.mesh.ref_map(np.arange(self.n_elements)[:, None], ref_pos[None, :])
        return np.concatenate([xs[:, :p].reshape(-1), xs[-1:, p]])


def make_cg_mesh(mesh: Mesh1D, p: int) -> CgMesh:
    ref = make_reference_element(p)
    pos = ref.pos_to_slot
    mass_pos = ref.mass[np.ix_(pos, pos)]  # reference mass in grid order
    jac = torch.from_numpy(mesh.jacobians)
    mass = cg_from_windows(torch.from_numpy(mass_pos)[:, :, None] * jac[None, None, :])
    lumped = mass.band.sum(dim=0)  # row sums: sum over offsets == sum over columns
    return CgMesh(p=p, mesh=mesh, ref=ref, mass=mass, lumped_mass=lumped)
