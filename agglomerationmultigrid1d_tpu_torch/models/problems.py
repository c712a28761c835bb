"""Canonical problem setups mirroring the reference's test scripts, as
one-call constructors:

* :func:`poisson_cg_hierarchy`      — ``tests/cg_heirarchy_test.jl``
* :func:`poisson_dg_cg_hierarchy`   — ``tests/dg_cg_heirarchy_test.jl``
* :func:`poisson_dg_hierarchy`      — ``tests/dg_heirarchy_test.jl``
* :func:`poisson_full_hierarchy`    — ``tests/full_heirarchy_test.jl`` (the flagship)
* :func:`poisson_scattered_hierarchy` — DG-topped, with scattered
  (non-contiguous) agglomerates from explicit element-id lists
  (:func:`interleaved_pair_groups`: a partition of them that converges as a
  deep chain)
* :func:`poisson_switch_hierarchy`  — DG-topped with a mixed upwind switch:
  every level block-pentadiagonal

Model problem: -u'' = cos(x) on [0, 1], u = cos (Neumann left, Dirichlet right).
Setup runs on the host in float64 (vectorised NumPy / torch); the finished
hierarchy and right-hand side then move to ``device`` in one pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..assembly.cg_assembly import cg_stiffness_and_rhs
from ..assembly.dg_assembly import dg_flux_operators, dg_flux_rhs
from ..mesh.agg_mesh import coarsen_agg_mesh, make_agg_mesh
from ..mesh.cg_mesh import make_cg_mesh
from ..mesh.dg_mesh import make_dg_mesh
from ..mesh.topology import BoundaryCondition, create_uniform_mesh
from ..ops.block_diag import bd_matvec
from ..ops.block_tridiag import bt_matvec
from ..utils.config import CycleParams, HierarchySpec, SolveParams
from ..utils.precision import tree_to
from ..utils.profiling import span
from .hierarchy import Hierarchy, build_dg_hierarchy, build_hierarchy, schur_stiffness


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
    device="cuda",
    agg_tables: bool = False,
    timings: dict | None = None,
) -> Problem:
    """Any of the reference's hierarchy configurations from a
    :class:`~..utils.config.HierarchySpec`: CG levels of ``spec.cg_orders``,
    DG levels of ``spec.dg_orders``, then ``spec.n_agg_levels`` agglomerated
    levels (``first_agg_factor`` base elements per agglomerate, then
    ``agg_factor`` per level).  ``spec.cg_orders`` empty selects the DG-topped
    constructor (``mesh_heirarchy.jl:140-181``), otherwise the CG-topped one
    (``:30-138``).

    The agglomerated meshes in ``Problem.meshes`` are lite (no quadrature
    tables: the hierarchy never reads them); ``agg_tables=True`` builds them
    tabled, for ``agg_load_vector``, ``agg_flux_rhs`` or ``base_jacobians``.

    The set-up phases are spans ``aggmg.setup.<phase>``
    (``utils.profiling.span``); ``timings``, a dict, receives their seconds,
    the device drained at each end: ``"meshes"`` (every level's mesh),
    ``"assemble"`` (the fine operator and the right-hand side),
    ``"hierarchy"`` (the coarse operators, transfers, smoothers and the
    coarse factorization, on the host) and ``"to_device"``."""
    func_, u_ex, ux_ex = default_model_problem()
    func = func or func_
    bc = bc or _default_bc(u_ex, ux_ex)
    if mesh is None:
        mesh = create_uniform_mesh(n, 0.0, 1.0)

    with span("aggmg.setup.meshes", timings):
        meshes: list = [make_cg_mesh(mesh, p) for p in spec.cg_orders]
        meshes += [make_dg_mesh(mesh, p) for p in spec.dg_orders]
        for i in range(spec.n_agg_levels):
            if i == 0:
                n_base, r = mesh.n_elements, spec.first_agg_factor
                if n_base % r:
                    meshes.append(
                        make_agg_mesh(
                            spec.p_agg, mesh, partition=_near_uniform_partition(n_base, r), tables=agg_tables
                        )
                    )
                else:
                    meshes.append(make_agg_mesh(spec.p_agg, mesh, r, tables=agg_tables))
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

    if spec.cg_orders:
        with span("aggmg.setup.assemble", timings):
            a, b = cg_stiffness_and_rhs(meshes[0], func, bc)
        with span("aggmg.setup.hierarchy", timings):
            h = build_hierarchy(meshes, bc, a, c_dir=spec.c_dir, cg_smoother_kind=spec.cg_smoother)
    else:
        dg = meshes[0]
        with span("aggmg.setup.assemble", timings):
            g, d, c = dg_flux_operators(dg, bc, spec.c_dir)
            a = schur_stiffness(g, d, c, dg.mass_inv)
            f, r = dg_flux_rhs(dg, func, bc, spec.c_dir)
            b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
        with span("aggmg.setup.hierarchy", timings):
            h = build_dg_hierarchy(meshes, a, g, d, c)
    with span("aggmg.setup.to_device", timings):
        return Problem(hierarchy=tree_to(h, device), b=b.to(device), meshes=meshes, bc=bc)


def solve(
    problem: Problem,
    x0: torch.Tensor | None = None,
    solve_params: SolveParams = SolveParams(),
    cycle_params: CycleParams = CycleParams(),
):
    """The outer multigrid iteration (:func:`.solvers.multigrid`) with the
    config-dataclass parameters (defaults: the reference's keyword defaults,
    ``solvers.jl:19-20``), from zero unless ``x0`` is given."""
    from .solvers import multigrid

    return multigrid(
        problem.hierarchy,
        torch.zeros_like(problem.b) if x0 is None else x0,
        problem.b,
        maxiter=solve_params.maxiter,
        tol=solve_params.tol,
        n_pre=cycle_params.n_pre,
        n_post=cycle_params.n_post,
        alpha=cycle_params.alpha,
        compute_error=solve_params.compute_error,
    )


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


def _orders(max_p: int, n: int) -> list[int]:
    """p, p//2, p//4, ... (cf. cg_heirarchy_test.jl:29-34)."""
    orders = []
    p = max_p
    for _ in range(n):
        orders.append(p)
        p //= 2
    return orders


def poisson_cg_hierarchy(
    n: int = 128,
    max_p: int = 8,
    n_cg: int = 4,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    cg_smoother: str = "jac",
    device="cuda",
) -> Problem:
    """CG levels p, p/2, ... only, dense coarse solve on the last
    (cg_heirarchy_test.jl)."""
    spec = HierarchySpec(
        cg_orders=tuple(_orders(max_p, n_cg)), n_agg_levels=0, cg_smoother=cg_smoother
    )
    return build_problem(spec, n, func, bc, device=device)


def poisson_dg_cg_hierarchy(
    n: int = 128,
    max_p: int = 8,
    n_cg: int = 4,
    n_dg: int = 1,
    c_dir: float | None = None,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    device="cuda",
) -> Problem:
    """CG chain then DG levels continuing the p-halving (reaching p = 0 for the
    default 4 + 1 configuration, as in dg_cg_heirarchy_test.jl:31-45)."""
    orders = _orders(max_p, n_cg + n_dg)
    spec = HierarchySpec(
        cg_orders=tuple(orders[:n_cg]),
        dg_orders=tuple(orders[n_cg:]),
        c_dir=1000.0 * n if c_dir is None else c_dir,
    )
    return build_problem(spec, n, func, bc, device=device)


def poisson_dg_hierarchy(
    n: int = 128,
    max_p: int = 8,
    n_dg: int = 4,
    n_agg: int = 0,
    p_agg: int = 1,
    c_dir: float | None = None,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    device="cuda",
    timings: dict | None = None,
) -> Problem:
    """DG-topped hierarchy; finest operators assembled directly and
    ``b = f - D M^-1 r`` (dg_heirarchy_test.jl:38-46).  ``n_agg`` appends
    agglomerated h-coarsening levels below the DG p-chain (4:1 first, 2:1
    after), which keeps the coarsest level small for large element counts.
    ``timings``: the set-up phases' seconds, as :func:`build_problem`'s."""
    spec = HierarchySpec(
        cg_orders=(),
        dg_orders=tuple(_orders(max_p, n_dg)),
        n_agg_levels=n_agg,
        p_agg=p_agg,
        c_dir=1000.0 * n if c_dir is None else c_dir,
    )
    return build_problem(spec, n, func, bc, device=device, timings=timings)


def poisson_full_hierarchy(
    n: int = 128,
    max_p: int = 8,
    n_cg: int = 4,
    n_agg: int | None = None,
    p_agg: int = 1,
    c_dir: float | None = None,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    device="cuda",
) -> Problem:
    """The flagship configuration (full_heirarchy_test.jl:30-92): 4 CG levels
    p = 8, 4, 2, 1, then log2(n) - 1 agglomerated levels (first 4:1, rest 2:1),
    CDir = 1000 n."""
    if n_agg is None:
        n_agg = int(np.log2(n)) - 1
    spec = HierarchySpec(
        cg_orders=tuple(_orders(max_p, n_cg)),
        n_agg_levels=n_agg,
        p_agg=p_agg,
        c_dir=1000.0 * n if c_dir is None else c_dir,
    )
    return build_problem(spec, n, func, bc, device=device)


def poisson_scattered_hierarchy(
    n: int = 64,
    p_dg: int = 1,
    groups_per_level: list | None = None,
    p_agg: int = 1,
    c_dir: float | None = None,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    device="cuda",
) -> Problem:
    """DG-topped hierarchy whose coarsening levels are SCATTERED
    (non-contiguous) agglomerations from explicit element-id lists, the
    reference's ``AgglomeratedDgMesh1(mP, agg::Vector{Vector{Int64}}, ...)``
    workflow as one call.

    ``groups_per_level[0]`` partitions the base elements; each later entry
    partitions the previous level's AGGLOMERATES (the recursive
    ``AgglomeratedDgMeshN``).  An entry is a list of id lists or a 2-d
    integer array, one row per agglomerate.  Default: one level of locally
    interleaved agglomerates (two 4-element runs per 16-element block)."""
    from ..mesh.scattered_agg import coarsen_scattered_agg_mesh, make_scattered_agg_mesh

    func_, u_ex, ux_ex = default_model_problem()
    func = func or func_
    bc = bc or _default_bc(u_ex, ux_ex)
    c_dir = 1000.0 * n if c_dir is None else c_dir

    if groups_per_level is None:
        if n % 16:
            raise ValueError("the default scattered partition needs 16 | n")
        o = 16 * np.arange(n // 16)[:, None]
        first = o + np.array([0, 1, 2, 3, 8, 9, 10, 11])
        second = o + np.array([4, 5, 6, 7, 12, 13, 14, 15])
        groups_per_level = [np.stack([first, second], axis=1).reshape(-1, 8)]

    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, p_dg)
    sa = make_scattered_agg_mesh(p_agg, mesh, groups_per_level[0])
    meshes: list = [dg, sa]
    for groups in groups_per_level[1:]:
        sa = coarsen_scattered_agg_mesh(sa, groups)
        meshes.append(sa)

    g, d, c = dg_flux_operators(dg, bc, c_dir)
    a = schur_stiffness(g, d, c, dg.mass_inv)
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    h = build_dg_hierarchy(meshes, a, g, d, c)
    return Problem(hierarchy=tree_to(h, device), b=b.to(device), meshes=meshes, bc=bc)


def interleaved_pair_groups(n: int, coarsest: int) -> list:
    """Scattered partitions for :func:`poisson_scattered_hierarchy`:
    interleaved pairs ({4b, 4b+2} and {4b+1, 4b+3}) of the ``n`` base
    elements, then agglomerates {2c, 2c+1} of the level above, down to
    ``coarsest`` agglomerates; 2-d arrays, one row per agglomerate."""
    o = 4 * np.arange(n // 4)[:, None]
    groups, m = [np.stack([o + np.array([0, 2]), o + np.array([1, 3])], axis=1).reshape(-1, 2)], n // 2
    while m > coarsest:
        groups.append(np.arange(m).reshape(-1, 2))
        m //= 2
    return groups


def poisson_switch_hierarchy(
    n: int = 64,
    n_coarsen: int = 1,
    c_dir: float | None = None,
    device="cuda",
) -> Problem:
    """DG-topped hierarchy with a mixed upwind switch, False on the first
    n/2 interior vertices and True on the rest (the reference's
    ``tests/test_penta.py`` pattern): DG p = 3, DG p = 1 with the same
    switch, agglomerates of 2, then ``n_coarsen`` 2:1 levels; every level
    block-pentadiagonal, Neumann left / Dirichlet right."""
    func, u_ex, ux_ex = default_model_problem()
    bc = _default_bc(u_ex, ux_ex)
    c_dir = 1000.0 * n if c_dir is None else c_dir
    s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    meshes: list = [make_dg_mesh(mesh, 3, switch=s), make_dg_mesh(mesh, 1, switch=s),
                    make_agg_mesh(1, mesh, 2, tables=False)]
    for _ in range(n_coarsen):
        meshes.append(coarsen_agg_mesh(meshes[-1], 2))
    dg = meshes[0]
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    h = build_dg_hierarchy(meshes, schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True), g, d, c)
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    return Problem(hierarchy=tree_to(h, device), b=b.to(device), meshes=meshes, bc=bc)
