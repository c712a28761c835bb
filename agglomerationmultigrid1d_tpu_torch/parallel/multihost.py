"""Process groups for the element-sharded solve, and the collectives it runs.

The counterpart of the JAX package's ``parallel/multihost.py:initialize`` /
``multihost_mesh`` and ``parallel/distributed.py:make_solver_mesh``.  A
:class:`SolverGroup` stands where the JAX package passes ``(mesh, axis)``:
one rank per process, each holding its own columns of the sharded levels.

Transport follows the backend, chosen by the group's ``backend`` and never by
catching an error: NCCL moves device tensors; gloo moves host tensors (its
point-to-point takes CPU tensors only), so on a card the few columns a gloo
collective carries go through host memory.

:func:`build_sharded_xl_problem` builds the stencil-inflated problem rank by
rank (the JAX module's per-process construction): each rank forms only its
own part of every sharded level, on its device.
"""

from __future__ import annotations

import contextlib
import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist


class SolverGroup(NamedTuple):
    """The ranks of one element-sharded solve.  Rank ``r`` of ``world`` owns
    columns ``[r n / world, (r + 1) n / world)`` of every sharded level."""

    group: object  # a torch.distributed ProcessGroup; None for the default (world) group
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" (device tensors) or "gloo" (host tensors)

    def peer(self, r: int) -> int:
        """The global rank of the group's rank ``r``."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    @property
    def transport(self) -> torch.device:
        """Where the tensors a collective moves live."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def on_device(self):
        """The context a collective runs in: NCCL works on the current CUDA device."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()


def initialize(
    rank: int,
    world: int,
    *,
    store_path: str | None = None,
    init_method: str | None = None,
    device="cuda",
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> SolverGroup:
    """Join the default process group and return its :class:`SolverGroup`.

    Rendezvous goes through a ``torch.distributed.FileStore`` at
    ``store_path`` (one file per solve, so several groups can run side by
    side) or the caller's ``init_method`` (e.g. ``"tcp://host:port"``);
    there is no default address.  The backend defaults to NCCL on a card and
    gloo with ``device="cpu"``.  A CUDA device without an index is the
    current one; asking for ``"cuda"`` where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors only: use backend='gloo' with device='cpu'")
    if (store_path is None) == (init_method is None):
        raise ValueError("give exactly one of store_path (a FileStore) and init_method")
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        store = dist.FileStore(str(store_path), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world, timeout=timeout
        )
    return SolverGroup(group=None, rank=rank, world=world, device=device, backend=backend)


def shutdown() -> None:
    """Leave the default process group (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_range(n: int, g: SolverGroup) -> tuple[int, int]:
    """The columns ``[lo, hi)`` of an ``n``-column sharded axis that rank ``g.rank`` owns."""
    if n % g.world:
        raise ValueError(f"{n} columns do not divide among {g.world} ranks")
    return g.rank * n // g.world, (g.rank + 1) * n // g.world


def node_range(n_el: int, p: int, g: SolverGroup, rank: int | None = None) -> tuple[int, int]:
    """The nodes ``[lo, hi)`` of a CG level (``n_el`` elements of order
    ``p``, ``n_el p + 1`` nodes) that rank ``rank`` (default ``g.rank``)
    owns: the rank owns its elements ``[r n_el / W, (r + 1) n_el / W)`` and
    the first ``p`` nodes of each, ``m = n_el p / W`` nodes; the last rank
    also owns the last node.  The vertex a rank's last element shares with
    the next rank is that rank's first node."""
    rank = g.rank if rank is None else rank
    lo, hi = local_range(n_el, g._replace(rank=rank))
    return lo * p, hi * p + (1 if rank == g.world - 1 else 0)


def node_widths(n_el: int, p: int, g: SolverGroup) -> list:
    """Every rank's node count on a sharded CG level (:func:`node_range`)."""
    return [hi - lo for lo, hi in (node_range(n_el, p, g, r) for r in range(g.world))]


def all_reduce_sum(t: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device (``t`` is not changed)."""
    buf = t.to(g.transport, copy=True)
    with g.on_device():
        dist.all_reduce(buf, group=g.group)
    return buf.to(t.device)


def all_gather_cols(t: torch.Tensor, g: SolverGroup, widths: list | None = None) -> torch.Tensor:
    """The ranks' ``t`` side by side along the last (element) axis, rank
    order.  ``widths``, every rank's width of that axis where they differ
    (a CG level's node shards, :func:`node_widths`): each part travels
    padded to the widest and is cut back."""
    buf = t.to(g.transport, copy=True).contiguous()
    if widths is not None:
        if buf.shape[-1] != widths[g.rank]:
            raise ValueError(f"rank {g.rank} holds {buf.shape[-1]} columns, its width is {widths[g.rank]}")
        buf = torch.nn.functional.pad(buf, (0, max(widths) - buf.shape[-1]))
    parts = [torch.empty_like(buf) for _ in range(g.world)]
    with g.on_device():
        dist.all_gather(parts, buf, group=g.group)
    if widths is not None:
        parts = [part[..., :w] for part, w in zip(parts, widths)]
    return torch.cat(parts, dim=-1).to(t.device)


# ---------------------------------------------------------------------------
# Rank-local construction of the stencil-inflated problem
# ---------------------------------------------------------------------------


def build_sharded_xl_problem(
    spec,
    n: int,
    func=None,
    bc=None,
    *,
    group: SolverGroup,
    z: int | None = None,
    bw: int = 4,
    chebyshev: bool = True,
    slim_fine: bool = False,
    ff_levels: bool = False,
    min_blocks_per_device: int = 128,
):
    """The stencil-inflated problem of ``models.stencil_setup.build_xl_problem``,
    built rank by rank: every rank of ``group`` runs this with the same
    arguments and materializes, on ``group.device``, only its own part of
    every sharded level (its columns, or on a CG level its nodes, as
    ``parallel.distributed.shard_hierarchy`` would cut the whole level), the
    small levels whole, and its part of the rhs.  No rank ever forms a tensor
    of a sharded level's global width: the small stencil problem (O(n / z))
    is rebuilt by every rank, cheaper than sending it (``z = 1``, the
    default factor where the coarsest count is odd, makes it the whole
    problem on the host, as in the JAX package's build; the whole
    ``build_xl_problem`` refuses that factor).  A transfer onto a sharded
    level whose agglomerates straddle the ranks (its coarse count, which the
    world does not divide, stays whole) is inflated at the coarse width and
    cut as ``shard_hierarchy`` cuts it (``parallel.transfers``), its plans
    from the level counts alone.  The JAX package's
    ``parallel/multihost.py:build_sharded_xl_problem``, with its branches:
    DG-topped and CG-topped chains, ``slim_fine`` (DG-topped only: the fine
    level keeps its diagonal blocks and the float-float fine operator is a
    replicated O(bw) ``BTFFStencil``, whose defect is kernel K6s on a shard)
    and ``ff_levels``.

    A level is sharded when it is not the coarsest, has at least
    ``world * min_blocks_per_device`` elements and its count divides the
    world size (JAX's rule).  Chebyshev bounds come from the small problem;
    the coarse factorization from the float64 stencils, replicated.  Ragged
    agglomerates are refused (the only layout they add, a level sharded
    below a whole one, included), as by the JAX package's build, as are
    ragged seams.

    Returns ``(h_low, a_ff, b_ff, norm_b)``: ``h_low`` carries its
    ``ShardLayout`` (the solvers route it) and, on its sharded float32 block
    levels, K7's operator ghosts and edge plans; ``a_ff`` the fine
    float-float operator (with ``ff_levels``, the tuple of every level's, as
    the JAX package's sharded build: no transfer lo tails, no float64 coarse
    factorization); ``b_ff`` the rank's part of the float-float rhs;
    ``norm_b`` the global ``||b||``.  Solve with
    ``models.solvers._mixed_loop_ff``.  Collective."""
    from ..models.hierarchy import BlockLevel, ShardLayout
    from ..models.stencil_setup import (
        _inflate_ff_fine,
        _inflate_ff_tail,
        _stencil_ff_fine,
        _stencil_problem,
        _uniform_cg_b,
        _uniform_dg_b,
        inflate_hierarchy,
    )
    from ..ops.block_tridiag import BlockTridiag
    from ..ops.df64 import ff_split
    from ..ops.transfer_ops import RaggedBlockProlong, SeamProlong
    from .distributed import attach_operator_ghosts, level_size

    device = group.device
    if slim_fine and spec.cg_orders:
        raise ValueError("slim_fine requires a DG-topped chain")
    st = _stencil_problem(spec, n, func, bc, z=z, bw=bw, dtype=torch.float32, chebyshev=chebyshev,
                          slim_fine=slim_fine, domain=(0.0, 1.0), min_z=1)
    prob0, h64, a_ff_small, h_low0, z = st.prob0, st.h64, st.a_ff_small, st.h_low0, st.z
    for t in h_low0.transfers:
        if isinstance(t, SeamProlong) and t.offsets is not None:
            raise ValueError("shard-local build requires uniform seam partitions")
    coarse_lv = h64.levels[-1]
    if not (isinstance(coarse_lv, BlockLevel) and isinstance(coarse_lv.a, BlockTridiag)):
        raise TypeError(
            "shard-local build needs a block-tridiagonal coarsest level (add "
            "agglomeration levels below the CG chain)"
        )
    w = group.world
    sizes = [level_size(lv) * z for lv in h_low0.levels]
    flags = tuple(k < len(sizes) - 1 and m >= w * min_blocks_per_device and m % w == 0
                  for k, m in enumerate(sizes))

    for k, t in enumerate(h_low0.transfers):
        # uniform agglomerates make every count below a sharded level's a divisor of it: only ragged ones
        # shard a level below a whole one, and the JAX package's rank-local build takes no ragged transfer
        # (its parallel/multihost.py:427 asserts a BlockProlong)
        if flags[k + 1] and not flags[k]:
            raise ValueError(f"shard-local build: level {k + 1} would be sharded below the whole level {k}, "
                             "a layout only ragged agglomerates make, whose transfers the JAX package's rank-local "
                             "build refuses")
        if isinstance(t, RaggedBlockProlong):
            raise ValueError(f"shard-local build requires uniform agglomerates: transfer {k} is ragged (the JAX "
                             "package's rank-local build refuses it too)")

    shard = (group, flags)
    h_low = inflate_hierarchy(h_low0, h64, z, bw=bw, device=device, shard=shard)
    h_low = attach_operator_ghosts(h_low._replace(layout=ShardLayout(group=group, sharded=flags)))
    fine = h_low.levels[0]
    if slim_fine:  # position-independent O(bw) stencils: the same on every rank
        a_ff = _stencil_ff_fine(a_ff_small, n, bw, device)
    else:
        a_ff = _inflate_ff_fine(a_ff_small, fine, z, bw, device, group, flags[0])
    if ff_levels:
        a_ff = (a_ff,) + _inflate_ff_tail(h64, h_low, z, bw, device, shard)

    if spec.cg_orders:
        p = fine.a.p
        lo, hi = node_range(n, p, group) if flags[0] else (0, n * p + 1)
        b = _uniform_cg_b(prob0, n, st.h, st.xin, st.func, st.bc, device, lo, hi)
    else:
        lo, hi = local_range(n, group) if flags[0] else (0, n)
        b = _uniform_dg_b(prob0, n, st.h, st.xin, st.func, bw, device, lo, hi)
    if flags[0]:
        norm_b = float(torch.sqrt(all_reduce_sum(torch.sum(b * b), group)))
    else:
        norm_b = float(torch.linalg.vector_norm(b))
    b_ff = ff_split(b)
    del b
    return h_low, a_ff, b_ff, norm_b
