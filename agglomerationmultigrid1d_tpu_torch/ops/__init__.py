from .shifts import shift
from .block_diag import BlockDiag, bd_matvec
from .block_tridiag import (
    BlockTridiag,
    bd_mul_bt,
    block_mul,
    bt_diag_blocks,
    bt_matvec,
    bt_mul_bd,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
)
from .transfer_ops import BlockProlong, block_prolong_constant, bp_galerkin, bp_prolong, bp_restrict
from .coarse_solve import CoarseSolver, coarse_solve, make_coarse_solver

__all__ = [
    "shift",
    "BlockDiag",
    "bd_matvec",
    "BlockTridiag",
    "bd_mul_bt",
    "block_mul",
    "bt_diag_blocks",
    "bt_matvec",
    "bt_mul_bd",
    "bt_mul_bt",
    "bt_sub",
    "bt_to_dense",
    "BlockProlong",
    "block_prolong_constant",
    "bp_galerkin",
    "bp_prolong",
    "bp_restrict",
    "CoarseSolver",
    "coarse_solve",
    "make_coarse_solver",
]
