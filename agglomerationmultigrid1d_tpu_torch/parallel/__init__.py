"""Element-axis domain decomposition over ``torch.distributed``: the group
handle, the collectives and the rank-local stencil build (``multihost``), the
neighbour exchange (``halo``), sharded hierarchies (``distributed``), CG levels
on a shard (``cg_levels``), the exchange plans of block-COO levels and of
straddling or scattered transfers (``columns``, ``transfers``) and the fused
smoothers on a shard (``sharded_kernels``, kernel K7 and the edge pair).
Importing it starts no process group."""

from .multihost import (
    SolverGroup,
    all_gather_cols,
    all_reduce_sum,
    build_sharded_xl_problem,
    initialize,
    local_range,
    node_range,
    node_widths,
    shutdown,
)
from .halo import halo_shift
from .distributed import (
    attach_operator_ghosts,
    distributed_multigrid,
    distributed_v_cycle,
    shard_hierarchy,
    shard_vector,
    unshard_vector,
)
from .sharded_kernels import edge_plan, operator_ghosts, sharded_chebyshev_multisweep, sharded_multisweep

__all__ = [
    "SolverGroup",
    "all_gather_cols",
    "all_reduce_sum",
    "build_sharded_xl_problem",
    "node_range",
    "node_widths",
    "initialize",
    "local_range",
    "shutdown",
    "halo_shift",
    "attach_operator_ghosts",
    "distributed_multigrid",
    "distributed_v_cycle",
    "shard_hierarchy",
    "shard_vector",
    "unshard_vector",
    "operator_ghosts",
    "edge_plan",
    "sharded_multisweep",
    "sharded_chebyshev_multisweep",
]
