"""Columns a rank reads beyond its own shard: the exchange plans of a sharded
block-COO matvec and of the transfers whose agglomerates straddle ranks or
scatter over them.

A :class:`ColumnPlan` says which global columns ``need`` of a level a rank
reads, in ascending order.  On a sharded level (equal shards,
``multihost.local_range``) the rank holds some of them itself and receives
the others from their owners, one message per peer that owns any; on a whole
level it reads them in place.  The plan is built once, by every rank, from
every rank's ``need`` (:func:`column_plan`): ``parallel.distributed.
shard_hierarchy`` has the whole hierarchy on every rank, and the rank-local
build derives every rank's ``need`` from the level counts, so building it
takes no communication, and a rank's messages are known to both ends.  Two
directions use it:

* :func:`gather_cols`: the ``need`` columns of a vector whose shard the rank
  holds (a prolongation's coarse columns, a matvec's columns);
* :func:`scatter_add_cols`: the reverse, for a scatter-add: the rank's
  partial sums at its ``need`` columns go to their owners, who add them to
  their own, in rank order; on a whole level, a sum over the ranks.

Only the columns named move, never a whole vector of a sharded level.  The
messages go through ``torch.distributed.batch_isend_irecv``, which NCCL and
gloo both run (gloo through host copies).  A plan's index tensors are int64,
so casting a hierarchy (``utils.precision.hierarchy_astype``) keeps them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import SolverGroup, all_reduce_sum


class ColumnPlan(NamedTuple):
    need: torch.Tensor  # (n_need,) int64 global columns the rank reads, ascending
    own_pos: torch.Tensor  # positions in ``need`` of the columns the rank holds
    own_idx: torch.Tensor  # their indices in the rank's vector
    send: tuple  # per rank q: the rank's local columns that q reads (int64, empty for none)
    recv: tuple  # per rank q: the positions in ``need`` of the columns read from q
    n_local: int  # the width of the rank's vector
    whole: bool  # the level is whole on every rank: nothing is received, scatter-adds sum over ranks

    @property
    def n_need(self) -> int:
        return self.need.shape[0]


def column_plan(needs: list, n: int, g: SolverGroup, *, whole: bool = False) -> ColumnPlan:
    """Rank ``g.rank``'s plan for reading, of a level of ``n`` columns, the
    global columns ``needs[g.rank]``; ``needs`` holds every rank's (host
    int64 arrays, each ascending and without repeats).  ``whole``: the level
    is whole on every rank (no exchange).  No communication."""
    r, w, dev = g.rank, g.world, g.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    mine = np.asarray(needs[r], dtype=np.int64)
    if whole:
        empty = (t(np.zeros(0)),) * w
        return ColumnPlan(t(mine), t(np.arange(mine.size)), t(mine), empty, empty, n, True)
    if n % w:
        raise ValueError(f"{n} columns do not divide among {w} ranks")
    m = n // w
    owner = mine // m
    send, recv = [], []
    for q in range(w):
        theirs = np.asarray(needs[q], dtype=np.int64)
        send.append(t(theirs[theirs // m == r] - r * m if q != r else np.zeros(0)))
        recv.append(t(np.flatnonzero(owner == q) if q != r else np.zeros(0)))
    own = np.flatnonzero(owner == r)
    return ColumnPlan(t(mine), t(own), t(mine[own] - r * m), tuple(send), tuple(recv), m, False)


def _exchange(outgoing: list, shapes: list, like: torch.Tensor, g: SolverGroup) -> list:
    """Send ``outgoing[q]`` to rank q and receive a tensor of ``shapes[q]``
    from it, for every q with something to move (None otherwise); returns
    the received tensors on ``like``'s device."""
    dev = g.transport
    ops, kept, bufs = [], [], [None] * g.world
    for q in range(g.world):
        if outgoing[q] is not None:
            msg = outgoing[q].to(dev).contiguous()
            kept.append(msg)  # alive until the exchange is done
            ops.append(dist.P2POp(dist.isend, msg, g.peer(q), g.group))
        if shapes[q] is not None:
            bufs[q] = torch.empty(shapes[q], dtype=like.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, bufs[q], g.peer(q), g.group))
    if ops:
        with g.on_device():
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return [None if b is None else b.to(like.device) for b in bufs]


def gather_cols(x: torch.Tensor, plan: ColumnPlan, g: SolverGroup) -> torch.Tensor:
    """``x``'s global columns ``plan.need`` (last axis), ``x`` the rank's
    vector of the level (its shard, or the whole level)."""
    out = x.new_empty(x.shape[:-1] + (plan.n_need,))
    out[..., plan.own_pos] = x[..., plan.own_idx]
    if plan.whole:
        return out
    lead = tuple(x.shape[:-1])
    got = _exchange([x[..., s] if s.numel() else None for s in plan.send],
                    [lead + (p.numel(),) if p.numel() else None for p in plan.recv], x, g)
    for pos, part in zip(plan.recv, got):
        if part is not None:
            out[..., pos] = part
    return out


def scatter_add_cols(y: torch.Tensor, plan: ColumnPlan, g: SolverGroup) -> torch.Tensor:
    """The rank's vector of the level from every rank's partial sums ``y`` at
    its ``plan.need`` columns: each column gets its owner's part, then the
    other ranks' in rank order (on a whole level, the sum over the ranks)."""
    axis = y.dim() - 1
    out = y.new_zeros(y.shape[:-1] + (plan.n_local,))
    out.index_add_(axis, plan.own_idx, y[..., plan.own_pos])
    if plan.whole:
        return all_reduce_sum(out, g) if g.world > 1 else out
    lead = tuple(y.shape[:-1])
    got = _exchange([y[..., p] if p.numel() else None for p in plan.recv],
                    [lead + (s.numel(),) if s.numel() else None for s in plan.send], y, g)
    for idx, part in zip(plan.send, got):
        if part is not None:
            out.index_add_(axis, idx, part)
    return out
