"""Multigrid hierarchy construction for DG-topped chains.

:func:`build_dg_hierarchy` takes the finest operators and a fine -> coarse
list of DG and agglomerated meshes; every coarser level Galerkin-projects G, D
and C *separately* and recombines them with the level's own mass,
``A = C - D M^-1 G`` (not a triple product of A).  The CG-topped constructor,
penta-diagonal (mixed-switch) levels, scattered agglomerates and block cyclic
reduction for large coarse levels are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.dg_mesh import DgMesh
from ..ops.block_diag import BlockDiag
from ..ops.block_tridiag import BlockTridiag, bd_mul_bt, block_mul, bt_mul_bt, bt_sub, bt_to_dense
from ..ops.coarse_solve import CoarseSolver, make_coarse_solver
from ..ops.transfer_ops import bp_galerkin
from ..smoothers.smoother import BlockJacobiSmoother, dg_smoother
from ..transfer.interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_dg_interpolation,
    dg_dg_interpolation,
)


class BlockLevel(NamedTuple):
    a: BlockTridiag
    g: BlockTridiag
    d: BlockTridiag
    c: BlockTridiag
    mass_inv: torch.Tensor  # (bs, bs, n) of the level's own mass
    smoother: BlockJacobiSmoother


class Hierarchy(NamedTuple):
    levels: tuple  # of BlockLevel, fine -> coarse
    transfers: tuple  # of BlockProlong, len = n_levels - 1
    coarse: CoarseSolver  # host-factorized dense solver for the coarsest level

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


DENSE_COARSE_MAX = 2048  # block levels beyond this need cyclic reduction


def _coarse_lu(level: BlockLevel) -> CoarseSolver:
    if level.a.n_dof > DENSE_COARSE_MAX:
        raise NotImplementedError(
            f"the coarsest level has {level.a.n_dof} DoF (> {DENSE_COARSE_MAX}); block "
            "cyclic reduction is not ported yet (ROADMAP queue 1, item 5) — add "
            "agglomeration levels"
        )
    return make_coarse_solver(bt_to_dense(level.a))


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
        prev = levels[-1]
        if isinstance(mesh, DgMesh):
            if not isinstance(fine_mesh, DgMesh):
                raise ValueError("DG level below an agglomerated level")
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(mesh, AggMesh):
            if isinstance(fine_mesh, DgMesh):
                l = aggdg_dg_interpolation(mesh, fine_mesh)
            else:
                l = aggdg_aggdg_interpolation(mesh, fine_mesh)
        else:
            raise NotImplementedError(
                f"{type(mesh).__name__} levels (scattered agglomerates, block-COO "
                "operators) are not ported yet (ROADMAP queue 1, item 14); the torch "
                "port takes DG and contiguous agglomerated meshes"
            )
        gc = bp_galerkin(l, prev.g)
        dc = bp_galerkin(l, prev.d)
        cc = bp_galerkin(l, prev.c)
        levels.append(_block_level(gc, dc, cc, mesh.mass_inv))
        transfers.append(l)

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def prepare_fast_smoothers(h: Hierarchy) -> Hierarchy:
    """Populate the M-form streams (``ml = S^-1 A_lower``, ``mu = S^-1 A_upper``)
    on every float32 level's block-Jacobi smoother, for the multisweep kernels
    (``make_low_precision_hierarchy`` calls this after the cast)."""

    def fix(lv: BlockLevel) -> BlockLevel:
        s = lv.smoother
        if lv.a.diag.dtype != torch.float32 or s.ml is not None:
            return lv
        ml = block_mul(s.inv, lv.a.lower)
        mu = block_mul(s.inv, lv.a.upper)
        return lv._replace(smoother=s._replace(ml=ml, mu=mu))

    return h._replace(levels=tuple(fix(lv) for lv in h.levels))
