"""Element-axis domain decomposition over ``torch.distributed``: the group
handle and collectives (``multihost``), the neighbour exchange (``halo``),
sharded hierarchies (``distributed``) and the fused smoothers on a shard
(``sharded_kernels``, kernel K7 and the edge pair).  Importing it starts no process group."""

from .multihost import SolverGroup, all_gather_cols, all_reduce_sum, initialize, local_range, shutdown
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
