"""Discontinuous-Galerkin discretization mesh (order-p nodal, element-contiguous).

DoFs keep the reference's *slot* ordering inside each element (slot 0 = left
endpoint, slot 1 = right endpoint, slots 2..p = interior Chebyshev nodes in
descending x); element k owns block k and vectors are stored as ``(p+1, n)``.
Built on the host in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..numerics import make_reference_element
from ..ops.block_diag import BlockDiag
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class DgMesh:
    p: int
    mesh: Mesh1D
    ref: "object"  # ReferenceElement
    mass: BlockDiag  # (p+1, p+1, n): J_k * reference mass per element
    mass_inv: BlockDiag
    # per-interior-vertex switch (n_el - 1,): True = u-hat from the LEFT
    # element, q-hat from the right (the default rule); False flips the
    # sides at that vertex.  None = all-default.
    u_hat_left: np.ndarray | None = None

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements


def normalize_switch(
    switch: np.ndarray | None, n_elements: int, allow_trapped: bool
) -> np.ndarray | None:
    """Validate a per-interior-vertex switch: reject u-trapping (True, False)
    adjacent pairs unless ``allow_trapped``, and normalize all-True (= the
    default rule) to ``None``."""
    if switch is None:
        return None
    switch = np.asarray(switch, dtype=bool)
    if switch.shape != (n_elements - 1,):
        raise ValueError("switch must have one entry per interior vertex")
    trapped = switch[:-1] & ~switch[1:]
    if trapped.any() and not allow_trapped:
        els = (np.nonzero(trapped)[0] + 1).tolist()
        raise ValueError(
            f"switch u-traps element(s) {els}: a True vertex followed by a "
            "False vertex means neither neighbor flux reads that element's "
            "trace, making the operator singular. Pass allow_trapped=True to "
            "build the (singular, block-pentadiagonal) operator anyway for "
            "analysis."
        )
    return None if switch.all() else switch


def make_dg_mesh(
    mesh: Mesh1D, p: int, switch: np.ndarray | None = None, allow_trapped: bool = False
) -> DgMesh:
    """Every mass block is ``J_k * M_ref``, so its inverse is ``M_ref^-1 / J_k``:
    one tiny host inverse and an elementwise scale.  ``switch`` (optional,
    ``(n - 1,)`` bool): per interior vertex, False flips the u-hat / q-hat
    sides (the reference's explicit-switch constructor); a mixed switch makes
    the Schur stiffness block-pentadiagonal
    (``schur_stiffness(..., mixed_switch=True)``).  A (True, False) pair
    u-traps the element between them (a singular operator) and is rejected
    unless ``allow_trapped``."""
    ref = make_reference_element(p)
    jac = torch.from_numpy(mesh.jacobians)
    mass = BlockDiag(torch.from_numpy(ref.mass)[:, :, None] * jac[None, None, :])
    inv_ref = torch.from_numpy(np.linalg.inv(ref.mass))
    mass_inv = BlockDiag(inv_ref[:, :, None] / jac[None, None, :])
    switch = normalize_switch(switch, mesh.n_elements, allow_trapped)
    return DgMesh(p=p, mesh=mesh, ref=ref, mass=mass, mass_inv=mass_inv, u_hat_left=switch)
