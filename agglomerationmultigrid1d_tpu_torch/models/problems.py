"""Canonical DG-topped problem setups (``tests/dg_heirarchy_test.jl`` of the
reference), as one-call constructors.

Model problem: -u'' = cos(x) on [0, 1], u = cos (Neumann left, Dirichlet right).
Setup runs on the host in float64 (vectorised NumPy / torch); the finished
hierarchy and right-hand side then move to ``device`` in one pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..assembly.dg_assembly import dg_flux_operators, dg_flux_rhs
from ..mesh.agg_mesh import coarsen_agg_mesh, make_agg_mesh
from ..mesh.dg_mesh import make_dg_mesh
from ..mesh.topology import BoundaryCondition, create_uniform_mesh
from ..ops.block_diag import bd_matvec
from ..ops.block_tridiag import bt_matvec
from ..utils.config import HierarchySpec
from ..utils.precision import tree_to
from .hierarchy import Hierarchy, build_dg_hierarchy, schur_stiffness


@dataclasses.dataclass(frozen=True)
class Problem:
    hierarchy: Hierarchy
    b: torch.Tensor
    meshes: list
    bc: BoundaryCondition


def build_problem(
    spec: HierarchySpec,
    n: int,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    mesh=None,
    device="cpu",
) -> Problem:
    """DG-topped hierarchy from a :class:`~..utils.config.HierarchySpec`
    (``mesh_heirarchy.jl:140-181``): DG levels of ``spec.dg_orders``, then
    ``spec.n_agg_levels`` agglomerated levels (``first_agg_factor`` base
    elements per agglomerate, then ``agg_factor`` per level)."""
    if spec.cg_orders:
        raise NotImplementedError(
            "CG-topped hierarchies are not ported yet (ROADMAP queue 1, item 10)"
        )
    func_, u_ex, ux_ex = default_model_problem()
    func = func or func_
    bc = bc or _default_bc(u_ex, ux_ex)
    if mesh is None:
        mesh = create_uniform_mesh(n, 0.0, 1.0)

    meshes: list = [make_dg_mesh(mesh, p) for p in spec.dg_orders]
    for i in range(spec.n_agg_levels):
        if i == 0:
            n_base, r = mesh.n_elements, spec.first_agg_factor
            if n_base % r:
                meshes.append(
                    make_agg_mesh(spec.p_agg, mesh, partition=_near_uniform_partition(n_base, r))
                )
            else:
                meshes.append(make_agg_mesh(spec.p_agg, mesh, r))
        else:
            fine = meshes[-1]
            if fine.n_agg % spec.agg_factor:
                meshes.append(
                    coarsen_agg_mesh(
                        fine, partition=_near_uniform_partition(fine.n_agg, spec.agg_factor)
                    )
                )
            else:
                meshes.append(coarsen_agg_mesh(fine, spec.agg_factor))

    dg = meshes[0]
    g, d, c = dg_flux_operators(dg, bc, spec.c_dir)
    a = schur_stiffness(g, d, c, dg.mass_inv)
    f, r = dg_flux_rhs(dg, func, bc, spec.c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    h = build_dg_hierarchy(meshes, a, g, d, c)
    return Problem(hierarchy=tree_to(h, device), b=b.to(device), meshes=meshes, bc=bc)


def _near_uniform_partition(n: int, r: int) -> np.ndarray:
    """Contiguous partition of ``n`` items into groups of ~``r``: when ``r``
    doesn't divide ``n``, the first groups take one extra item."""
    m = max(n // r, 1)
    base, rem = divmod(n, m)
    return np.asarray([base + 1] * rem + [base] * (m - rem), dtype=np.int64)


def default_model_problem():
    """-u'' = cos, exact u = cos (cf. full_heirarchy_test.jl:23-25)."""
    func = torch.cos
    u_exact = np.cos
    ux_exact = lambda x: -np.sin(x)  # noqa: E731
    return func, u_exact, ux_exact


def _default_bc(u_exact, ux_exact, xin=0.0, xout=1.0) -> BoundaryCondition:
    """Neumann left / Dirichlet right (full_heirarchy_test.jl:39)."""
    return BoundaryCondition(("neu", ux_exact(xin)), ("dir", u_exact(xout)))


def _dg_orders(max_p: int, n_dg: int) -> list[int]:
    """p, p//2, p//4, ..."""
    orders = []
    p = max_p
    for _ in range(n_dg):
        orders.append(p)
        p //= 2
    return orders


def poisson_dg_hierarchy(
    n: int = 128,
    max_p: int = 8,
    n_dg: int = 4,
    n_agg: int = 0,
    p_agg: int = 1,
    c_dir: float | None = None,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    device="cpu",
) -> Problem:
    """DG-topped hierarchy; finest operators assembled directly and
    ``b = f - D M^-1 r`` (dg_heirarchy_test.jl:38-46).  ``n_agg`` appends
    agglomerated h-coarsening levels below the DG p-chain (4:1 first, 2:1
    after), which keeps the coarsest level small for large element counts."""
    spec = HierarchySpec(
        cg_orders=(),
        dg_orders=tuple(_dg_orders(max_p, n_dg)),
        n_agg_levels=n_agg,
        p_agg=p_agg,
        c_dir=1000.0 * n if c_dir is None else c_dir,
    )
    return build_problem(spec, n, func, bc, device=device)
