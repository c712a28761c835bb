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
offsets.  Penta-diagonal (mixed-switch) levels and scattered agglomerates are
not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from ..assembly.agg_assembly import agg_flux_operators
from ..assembly.dg_assembly import dg_flux_operators
from ..mesh.agg_mesh import AggMesh
from ..mesh.cg_mesh import CgMesh
from ..mesh.dg_mesh import DgMesh
from ..mesh.topology import BoundaryCondition
from ..ops.block_diag import BlockDiag
from ..ops.block_tridiag import BlockTridiag, bd_mul_bt, block_mul, bt_mul_bt, bt_sub, bt_to_dense
from ..ops.cg_operator import CgOperator, cg_to_dense
from ..ops.coarse_solve import CoarseSolver, make_bt_coarse_solver, make_coarse_solver
from ..ops.kernels.block_kernels import MAX_SWEEPS, chebyshev_coefficients
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


class CgLevel(NamedTuple):
    a: CgOperator
    smoother: Smoother


class BlockLevel(NamedTuple):
    a: BlockTridiag
    g: BlockTridiag
    d: BlockTridiag
    c: BlockTridiag
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
    transfers: tuple  # of BlockProlong / RaggedBlockProlong / CgProlong / SeamProlong, len = n_levels - 1
    coarse: CoarseSolver  # host-factorized coarsest-level solver (dense, or BTCoarseSolver)
    layout: ShardLayout | None = None  # None: every level whole on one device

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def schur_stiffness(
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    mass_inv: BlockDiag,
    *,
    mixed_switch: bool = False,
) -> BlockTridiag:
    """``A = C - D (M^-1 G)``, block-tridiagonal."""
    if mixed_switch:
        raise NotImplementedError(
            "a mixed switch makes A block-pentadiagonal, which the torch port does "
            "not have yet (ROADMAP queue 1, item 14)"
        )
    return bt_sub(c, bt_mul_bt(d, bd_mul_bt(mass_inv, g)))


def _block_level(g, d, c, mass_inv: BlockDiag) -> BlockLevel:
    a = schur_stiffness(g, d, c, mass_inv)
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
    if level.a.n_dof > DENSE_COARSE_MAX:
        # block cyclic reduction: O(n bs^2) memory, no size cliff
        return make_bt_coarse_solver(level.a)
    return make_coarse_solver(bt_to_dense(level.a))


def _agg_interpolation(mesh: AggMesh, fine_mesh):
    if isinstance(fine_mesh, DgMesh):
        return aggdg_dg_interpolation(mesh, fine_mesh)
    return aggdg_aggdg_interpolation(mesh, fine_mesh)


def _galerkin_level(l, prev: BlockLevel, mesh) -> BlockLevel:
    return _block_level(galerkin(l, prev.g), galerkin(l, prev.d), galerkin(l, prev.c), mesh.mass_inv)


def _unported_mesh(mesh) -> NotImplementedError:
    return NotImplementedError(
        f"{type(mesh).__name__} levels (scattered agglomerates, block-COO operators) "
        "are not ported yet (ROADMAP queue 1, item 14); the torch port takes CG, DG "
        "and contiguous agglomerated meshes"
    )


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
    every level below it is a Galerkin product."""
    if not isinstance(meshes[0], CgMesh):
        raise ValueError("at least one CG mesh required at the top")

    levels: list = [CgLevel(a=a_fine, smoother=cg_smoother(a_fine, cg_smoother_kind))]
    transfers: list = []
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
                levels.append(_block_level(g, d, c, mesh.mass_inv))
            elif isinstance(mesh, DgMesh):
                if not isinstance(fine_mesh, DgMesh):
                    raise ValueError("DG level below an agglomerated level")
                l = dg_dg_interpolation(mesh, fine_mesh)
                levels.append(_galerkin_level(l, prev, mesh))
            else:
                l = _agg_interpolation(mesh, fine_mesh)
                levels.append(_galerkin_level(l, prev, mesh))
        else:
            raise _unported_mesh(mesh)
        transfers.append(l)

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def build_dg_hierarchy(
    meshes: list,
    a: BlockTridiag,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
) -> Hierarchy:
    """DG-topped hierarchy (``mesh_heirarchy.jl:140-181``): finest operators
    given, then one level per mesh of ``meshes[1:]`` (DG, then agglomerated)."""
    if not isinstance(meshes[0], DgMesh):
        raise ValueError("at least one DG mesh required at the top")
    if not isinstance(a, BlockTridiag) or meshes[0].u_hat_left is not None:
        raise NotImplementedError(
            "block-pentadiagonal (mixed-switch) operators are not ported yet "
            "(ROADMAP queue 1, item 14)"
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
        if isinstance(mesh, DgMesh):
            if not isinstance(fine_mesh, DgMesh):
                raise ValueError("DG level below an agglomerated level")
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(mesh, AggMesh):
            l = _agg_interpolation(mesh, fine_mesh)
        else:
            raise _unported_mesh(mesh)
        levels.append(_galerkin_level(l, levels[-1], mesh))
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
        e = torch.zeros((0, 0, 0), dtype=lv.a.diag.dtype, device=lv.a.diag.device)
        empty = BlockTridiag(e, e, e)
        return lv._replace(g=empty, d=empty, c=empty, mass_inv=e)

    return h._replace(levels=tuple(strip(lv) for lv in h.levels))


def _chebyshev_table(s: ChebyshevSmoother) -> tuple:
    """The float32 recurrence table of a float32 level (one host read of its
    interval, at setup)."""
    tab = chebyshev_coefficients(float(s.lam_lo), float(s.lam_hi), MAX_SWEEPS)
    return tuple(tuple(row) for row in tab.tolist())


def prepare_fast_smoothers(h: Hierarchy) -> Hierarchy:
    """Populate, on every float32 level, what the fused kernels read: the
    M-form streams (``ml = S^-1 A_lower``, ``mu = S^-1 A_upper``) of a
    block-Jacobi smoother, also under a Chebyshev wrap, and a Chebyshev
    smoother's recurrence table (``make_low_precision_hierarchy`` calls this
    after the cast); on a sharded hierarchy also K7's operator ghosts
    (``parallel.distributed.attach_operator_ghosts``, a collective)."""

    def fix_base(lv, s):
        if not isinstance(lv, BlockLevel) or not isinstance(s, BlockJacobiSmoother) or s.ml is not None:
            return s
        return s._replace(ml=block_mul(s.inv, lv.a.lower), mu=block_mul(s.inv, lv.a.upper))

    def fix(lv):
        s = lv.smoother
        if isinstance(s, ChebyshevSmoother):
            if s.lam_hi.dtype != torch.float32:
                return lv
            s = s._replace(base=fix_base(lv, s.base))
            if s.coef is None:
                s = s._replace(coef=_chebyshev_table(s))
            return lv._replace(smoother=s)
        if isinstance(lv, BlockLevel) and lv.a.diag.dtype == torch.float32:
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
        if isinstance(level, CgLevel):
            shape, like = (level.a.n_nodes,), level.a.band
        else:
            shape, like = (level.a.block_size, level.a.n_blocks), level.a.diag
        i = torch.arange(math.prod(shape), dtype=like.dtype, device=like.device)
        x0 = torch.cos(1.7 * i).reshape(shape) + 0.5
        lam = _power_lam(level, x0, power_iters)
        s = ChebyshevSmoother(base=level.smoother, lam_lo=lam * safety / ratio, lam_hi=lam * safety)
        if like.dtype == torch.float32:
            s = s._replace(coef=_chebyshev_table(s))
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
