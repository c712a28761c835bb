"""Multigrid hierarchy construction.

Two constructors mirroring the reference:

* :func:`build_hierarchy` — CG-topped (``mesh_heirarchy.jl:30-138``): a chain
  of CG p-coarsening levels (Galerkin stiffness, pointwise Jacobi or Schwarz
  smoothing), an optional CG -> DG seam and DG p-coarsening chain, then
  agglomerated h-coarsening levels;
* :func:`build_dg_hierarchy` — DG-topped (``mesh_heirarchy.jl:140-181``).

Every DG / agglomerated level below the top Galerkin-projects G, D and C
*separately* and recombines them with the level's own mass,
``A = C - D M^-1 G`` (not a triple product of A).  :func:`chebyshev_hierarchy`
wraps every smoothed level's smoother in Chebyshev acceleration.
Agglomerates may be ragged (element counts the coarsening factors do not
divide): their transfers are ``RaggedBlockProlong`` or a ``SeamProlong`` with
offsets.  Below a DG or agglomerated level with a *mixed* switch every block
level's ``a`` is block-pentadiagonal (``BlockPenta``); a scattered
(non-contiguous) agglomerated level holds block-COO operators
(``BlockCOO``) and a ``ScatteredProlong``.  Only block-tridiagonal levels
reach the fused kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from ..assembly.agg_assembly import agg_flux_operators
from ..assembly.dg_assembly import dg_flux_operators
from ..assembly.scattered_assembly import scattered_schur
from ..mesh.agg_mesh import AggMesh
from ..mesh.cg_mesh import CgMesh
from ..mesh.dg_mesh import DgMesh
from ..mesh.scattered_agg import ScatteredAggMesh
from ..mesh.topology import BoundaryCondition
from ..ops.block_coo import BlockCOO, bcoo_to_dense
from ..ops.block_diag import BlockDiag
from ..ops.block_penta import BlockPenta, bp5_sub, bp5_to_dense, bt_as_penta, bt_mul_bt_full
from ..ops.block_tridiag import BlockTridiag, bd_mul_bt, block_mul, bt_mul_bt, bt_sub, bt_to_dense
from ..ops.cg_operator import CgOperator, cg_to_dense
from ..ops.coarse_solve import CoarseSolver, make_bt_coarse_solver, make_coarse_solver, make_penta_coarse_solver
from ..ops.kernels.block_kernels import MAX_SWEEPS, chebyshev_coefficients, chebyshev_theta
from ..ops.transfer_ops import cgp_galerkin, galerkin
from ..smoothers.smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    Smoother,
    apply_smoother,
    cg_smoother,
    dg_smoother,
)
from ..transfer.interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
    cg_cg_interpolation,
    dg_cg_interpolation,
    dg_dg_interpolation,
)
from ..transfer.scattered_transfer import (
    scattered_dg_interpolation,
    scattered_galerkin,
    scattered_scattered_interpolation,
)


class CgLevel(NamedTuple):
    a: CgOperator
    smoother: Smoother


class BlockLevel(NamedTuple):
    a: BlockTridiag | BlockPenta | BlockCOO
    g: BlockTridiag | BlockCOO
    d: BlockTridiag | BlockCOO
    c: BlockTridiag | BlockCOO
    mass_inv: torch.Tensor  # (bs, bs, n) of the level's own mass
    smoother: Smoother


Level = Union[CgLevel, BlockLevel]


class ShardLayout(NamedTuple):
    """How a hierarchy is spread over the ranks of a solve (set by
    ``parallel.distributed.shard_hierarchy``): level ``k`` holds the rank's
    columns of its element axis when ``sharded[k]``, else all of them."""

    group: object  # parallel.multihost.SolverGroup
    sharded: tuple  # of bool, one per level


class Hierarchy(NamedTuple):
    levels: tuple  # of Level, fine -> coarse
    transfers: tuple  # of BlockProlong / RaggedBlockProlong / CgProlong / SeamProlong / ScatteredProlong
    coarse: CoarseSolver  # host-factorized coarsest-level solver (dense, BTCoarseSolver, PaddedBTCoarseSolver)
    layout: ShardLayout | None = None  # None: every level whole on one device

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def operator_data(a) -> torch.Tensor:
    """A floating tensor of a level operator (its dtype and device are the
    operator's): the band of a CG operator, the blocks of a block-COO one,
    else the diagonal blocks."""
    if isinstance(a, CgOperator):
        return a.band
    return a.blocks if isinstance(a, BlockCOO) else a.diag


def schur_stiffness(
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    mass_inv: BlockDiag,
    *,
    mixed_switch: bool = False,
) -> BlockTridiag | BlockPenta:
    """``A = C - D (M^-1 G)``: block-tridiagonal, or with ``mixed_switch``
    (operators of a level with a mixed switch) the exact block-pentadiagonal
    product, whose distance-2 blocks ``bt_mul_bt`` would drop."""
    m_g = bd_mul_bt(mass_inv, g)
    if mixed_switch:
        return bp5_sub(bt_as_penta(c), bt_mul_bt_full(d, m_g))
    return bt_sub(c, bt_mul_bt(d, m_g))


def _block_level(g, d, c, mass_inv: BlockDiag, penta: bool = False) -> BlockLevel:
    a = schur_stiffness(g, d, c, mass_inv, mixed_switch=penta)
    return BlockLevel(
        a=a, g=g, d=d, c=c, mass_inv=mass_inv.blocks, smoother=dg_smoother(a, "blockJac")
    )


MAX_COARSE_DOF = 16384  # dense-solve cap for CG coarsest levels
DENSE_COARSE_MAX = 2048  # block levels beyond this need cyclic reduction


def _coarse_lu(level: Level) -> CoarseSolver:
    if isinstance(level, CgLevel):
        if level.a.n_nodes > MAX_COARSE_DOF:
            raise ValueError(
                f"coarsest CG level has {level.a.n_nodes} DoF (> {MAX_COARSE_DOF}); "
                "the dense coarse solve would not fit — add more coarsening levels "
                "(e.g. agglomeration levels for large element counts)"
            )
        return make_coarse_solver(cg_to_dense(level.a))
    if isinstance(level.a, BlockPenta):
        if level.a.n_dof > DENSE_COARSE_MAX:
            return make_penta_coarse_solver(level.a)  # pair-merged cyclic reduction
        return make_coarse_solver(bp5_to_dense(level.a))
    if isinstance(level.a, BlockCOO):
        if level.a.n_dof > MAX_COARSE_DOF:
            raise ValueError(
                f"coarsest scattered level has {level.a.n_dof} DoF "
                f"(> {MAX_COARSE_DOF}); its general sparsity has no banded "
                "elimination — add more (scattered) coarsening levels"
            )
        return make_coarse_solver(bcoo_to_dense(level.a))
    if level.a.n_dof > DENSE_COARSE_MAX:
        # block cyclic reduction: O(n bs^2) memory, no size cliff
        return make_bt_coarse_solver(level.a)
    return make_coarse_solver(bt_to_dense(level.a))


def _agg_interpolation(mesh: AggMesh, fine_mesh):
    if isinstance(fine_mesh, DgMesh):
        return aggdg_dg_interpolation(mesh, fine_mesh)
    return aggdg_aggdg_interpolation(mesh, fine_mesh)


def _galerkin_level(l, prev: BlockLevel, mesh, penta: bool) -> BlockLevel:
    return _block_level(galerkin(l, prev.g), galerkin(l, prev.d), galerkin(l, prev.c), mesh.mass_inv,
                        penta=penta)


def _scattered_level(mesh: ScatteredAggMesh, fine_mesh, prev: BlockLevel) -> tuple:
    """``(level, transfer)`` of a scattered agglomerated level below a DG,
    agglomerated or scattered one: block-COO Galerkin products of G, D and C,
    recombined with the level's own mass."""
    if isinstance(fine_mesh, DgMesh):
        l = scattered_dg_interpolation(mesh, fine_mesh)
    elif isinstance(fine_mesh, (ScatteredAggMesh, AggMesh)):
        l = scattered_scattered_interpolation(mesh, fine_mesh)
    else:
        raise TypeError("a scattered agglomeration level must follow a DG or agglomerated level")
    g, d, c = (scattered_galerkin(l, x) for x in (prev.g, prev.d, prev.c))
    a = scattered_schur(g, d, c, mesh.mass_inv)
    level = BlockLevel(a=a, g=g, d=d, c=c, mass_inv=mesh.mass_inv.blocks, smoother=dg_smoother(a, "blockJac"))
    return level, l


def build_hierarchy(
    meshes: list,
    bc: BoundaryCondition,
    a_fine: CgOperator,
    *,
    c_dir: float = 1.0,
    cg_smoother_kind: str = "jac",
) -> Hierarchy:
    """CG-topped hierarchy from a fine -> coarse list of CgMesh / DgMesh /
    AggMesh, in that order (CG+ [DG*] [Agg*]).  The first DG or agglomerated
    level below the CG chain assembles its own flux operators (the seam);
    every level below it is a Galerkin product.  A seam mesh with a mixed
    switch makes every block level from there on block-pentadiagonal."""
    if not isinstance(meshes[0], CgMesh):
        raise ValueError("at least one CG mesh required at the top")

    levels: list = [CgLevel(a=a_fine, smoother=cg_smoother(a_fine, cg_smoother_kind))]
    transfers: list = []
    # once a mixed-switch level enters the chain, every block level below it
    # recombines into the exact pentadiagonal Schur stiffness (the Galerkin
    # projections of G, D, C keep the flipped-vertex couplings)
    mixed = False
    for i in range(1, len(meshes)):
        fine_mesh, mesh = meshes[i - 1], meshes[i]
        prev = levels[-1]
        if isinstance(mesh, CgMesh):
            if not isinstance(fine_mesh, CgMesh):
                raise ValueError("CG level below a non-CG level")
            l = cg_cg_interpolation(mesh, fine_mesh)
            a = cgp_galerkin(l, prev.a)
            levels.append(CgLevel(a=a, smoother=cg_smoother(a, cg_smoother_kind)))
        elif isinstance(mesh, (DgMesh, AggMesh)):
            if isinstance(fine_mesh, CgMesh):
                # CG -> DG / agg seam: lumped-mass transfer + direct flux assembly
                if isinstance(mesh, DgMesh):
                    l = dg_cg_interpolation(mesh, fine_mesh)
                    g, d, c = dg_flux_operators(mesh, bc, c_dir)
                else:
                    l = aggdg_cg_interpolation(mesh, fine_mesh)
                    g, d, c = agg_flux_operators(mesh, bc, c_dir)
                mixed = mesh.u_hat_left is not None
                levels.append(_block_level(g, d, c, mesh.mass_inv, penta=mixed))
            elif isinstance(mesh, DgMesh):
                if not isinstance(fine_mesh, DgMesh):
                    raise ValueError("DG level below an agglomerated level")
                l = dg_dg_interpolation(mesh, fine_mesh)
                levels.append(_galerkin_level(l, prev, mesh, mixed))
            else:
                l = _agg_interpolation(mesh, fine_mesh)
                levels.append(_galerkin_level(l, prev, mesh, mixed))
        else:
            raise TypeError(f"unknown mesh type {type(mesh)}")
        transfers.append(l)

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def build_dg_hierarchy(
    meshes: list,
    a: BlockTridiag | BlockPenta,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
) -> Hierarchy:
    """DG-topped hierarchy (``mesh_heirarchy.jl:140-181``): finest operators
    given, then one level per mesh of ``meshes[1:]``: DG, then contiguous
    agglomerated, then scattered agglomerated levels.

    A finest mesh with a *mixed* switch must come with a block-pentadiagonal
    ``a`` (``schur_stiffness(..., mixed_switch=True)``), and every level
    below is pentadiagonal too; a tridiagonal ``a`` would drop its
    distance-2 blocks and is rejected.
    """
    if not isinstance(meshes[0], DgMesh):
        raise ValueError("at least one DG mesh required at the top")
    penta = isinstance(a, BlockPenta)
    if meshes[0].u_hat_left is not None and not penta:
        raise ValueError(
            "the finest mesh has a mixed switch, which makes A = C - D M^-1 G "
            "block-PENTAdiagonal; the given block-tridiagonal `a` drops its "
            "distance-2 blocks — build it with "
            "schur_stiffness(g, d, c, mass_inv, mixed_switch=True)"
        )
    levels = [
        BlockLevel(
            a=a, g=g, d=d, c=c, mass_inv=meshes[0].mass_inv.blocks,
            smoother=dg_smoother(a, "blockJac"),
        )
    ]
    transfers = []
    for i in range(1, len(meshes)):
        fine_mesh, mesh = meshes[i - 1], meshes[i]
        prev = levels[-1]
        if isinstance(mesh, ScatteredAggMesh):
            level, l = _scattered_level(mesh, fine_mesh, prev)
            levels.append(level)
            transfers.append(l)
            continue
        if isinstance(prev.g, BlockCOO):
            raise TypeError(
                "a contiguous level cannot follow a scattered level (its "
                "operators are general block-COO); keep the remaining levels "
                "scattered (coarsen_scattered_agg_mesh)"
            )
        if isinstance(mesh, DgMesh):
            if not isinstance(fine_mesh, DgMesh):
                raise ValueError("DG level below an agglomerated level")
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(mesh, AggMesh):
            l = _agg_interpolation(mesh, fine_mesh)
        else:
            raise TypeError("DG-topped hierarchies take DG/Agg/Scattered meshes only")
        levels.append(_galerkin_level(l, prev, mesh, penta))
        transfers.append(l)

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def strip_hierarchy(h: Hierarchy) -> Hierarchy:
    """Drop construction-only operator storage (G, D, C, level masses) from
    every block level, keeping what the solve reads: ``a``, the smoother, the
    transfers and the coarse factorization (at 10^8 DoF the dropped tensors
    are ~3x the solve's footprint)."""

    def strip(lv):
        if not isinstance(lv, BlockLevel):
            return lv
        like = operator_data(lv.a)
        e = torch.zeros((0, 0, 0), dtype=like.dtype, device=like.device)
        empty = BlockTridiag(e, e, e)
        return lv._replace(g=empty, d=empty, c=empty, mass_inv=e)

    return h._replace(levels=tuple(strip(lv) for lv in h.levels))


def _with_chebyshev_table(s: ChebyshevSmoother) -> ChebyshevSmoother:
    """``s`` with the float32 recurrence table of a float32 level and the
    interval's centre ``theta`` (one host read of its interval, at setup)."""
    lam_lo, lam_hi = float(s.lam_lo), float(s.lam_hi)
    tab = chebyshev_coefficients(lam_lo, lam_hi, MAX_SWEEPS)
    return s._replace(coef=tuple(tuple(row) for row in tab.tolist()), theta=float(chebyshev_theta(lam_lo, lam_hi)))


def prepare_fast_smoothers(h: Hierarchy) -> Hierarchy:
    """Populate, on every float32 level, what the fused kernels read: the
    M-form streams (``ml = S^-1 A_lower``, ``mu = S^-1 A_upper``) of a
    block-Jacobi smoother, also under a Chebyshev wrap, and a Chebyshev
    smoother's recurrence table (``make_low_precision_hierarchy`` calls this
    after the cast); on a sharded hierarchy also K7's operator ghosts
    (``parallel.distributed.attach_operator_ghosts``, a collective).  Only
    block-tridiagonal levels get the streams: no kernel takes a
    pentadiagonal or block-COO level."""

    def fix_base(lv, s):
        if (not isinstance(lv, BlockLevel) or not isinstance(lv.a, BlockTridiag)
                or not isinstance(s, BlockJacobiSmoother) or s.ml is not None):
            return s
        return s._replace(ml=block_mul(s.inv, lv.a.lower), mu=block_mul(s.inv, lv.a.upper))

    def fix(lv):
        s = lv.smoother
        if isinstance(s, ChebyshevSmoother):
            if s.lam_hi.dtype != torch.float32:
                return lv
            s = s._replace(base=fix_base(lv, s.base))
            if s.coef is None or s.theta is None:
                s = _with_chebyshev_table(s)
            return lv._replace(smoother=s)
        if isinstance(lv, BlockLevel) and operator_data(lv.a).dtype == torch.float32:
            return lv._replace(smoother=fix_base(lv, s))
        return lv

    h = h._replace(levels=tuple(fix(lv) for lv in h.levels))
    if h.layout is None:
        return h
    from ..parallel.distributed import attach_operator_ghosts

    return attach_operator_ghosts(h)


def chebyshev_hierarchy(
    h: Hierarchy,
    *,
    ratio: float = 4.0,
    power_iters: int = 20,
    safety: float = 1.05,
) -> Hierarchy:
    """Wrap every smoothed level's smoother in Chebyshev acceleration.

    ``lambda_max(S A)`` per level comes from ``power_iters`` power iterations
    with a deterministic start vector; the smoothed interval is
    ``[lam_hi / ratio, lam_hi * safety]``.  Use with the same ``n_pre`` /
    ``n_post`` as before: each sweep becomes one degree of the Chebyshev
    recurrence at the same cost.  Run it on the float64 hierarchy and cast
    afterwards (``make_low_precision_hierarchy``), as the JAX package does;
    on a float32 hierarchy the recurrence tables are filled here.  Wrap
    before sharding: the power iteration runs on whole levels."""
    if h.layout is not None:
        raise ValueError("chebyshev_hierarchy takes an unsharded hierarchy: wrap it, then shard it")
    new_levels = []
    for k, level in enumerate(h.levels):
        if k == len(h.levels) - 1:
            new_levels.append(level)  # the coarsest level never smooths
            continue
        like = operator_data(level.a)
        if isinstance(level, CgLevel):
            shape = (level.a.n_nodes,)
        else:
            shape = (level.a.block_size, level.a.n_blocks)
        i = torch.arange(math.prod(shape), dtype=like.dtype, device=like.device)
        x0 = torch.cos(1.7 * i).reshape(shape) + 0.5
        lam = _power_lam(level, x0, power_iters)
        s = ChebyshevSmoother(base=level.smoother, lam_lo=lam * safety / ratio, lam_hi=lam * safety)
        if like.dtype == torch.float32:
            s = _with_chebyshev_table(s)
        new_levels.append(level._replace(smoother=s))
    return h._replace(levels=tuple(new_levels))


def _power_lam(level: Level, x0: torch.Tensor, iters: int) -> torch.Tensor:
    """lambda_max(S A) by power iteration, a host loop of ``iters`` steps that
    never reads the device: the estimate stays a 0-d tensor."""
    from .solvers import level_matvec

    x = x0 / torch.linalg.vector_norm(x0.reshape(-1))
    lam = torch.ones((), dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        y = apply_smoother(level.smoother, level_matvec(level, x))
        lam = torch.linalg.vector_norm(y.reshape(-1))
        x = y / lam
    return lam
