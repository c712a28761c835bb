"""Neighbour exchange along the sharded element axis.

:func:`halo_shift` is the distributed twin of ``ops.shifts.shift``: the local
zero-padded shift, with the edge column patched from the neighbour's shard
(the JAX package's ``parallel/halo.py``, where ``lax.ppermute`` moves it).
Ring ends keep the zero fill, which is the global zero-Dirichlet boundary.

Every exchange goes through :func:`start_exchange`, which posts the
point-to-point operations (``torch.distributed.batch_isend_irecv``) and
returns at once, so the caller can launch work that does not need the
ghosts before it waits.  :class:`RingExchange` is the same exchange for
messages that live across calls (the sharded smoother's edge columns, once
per smoothing): nothing is allocated per exchange.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.shifts import shift
from .multihost import SolverGroup


class Exchange(NamedTuple):
    """A posted ring exchange; :meth:`wait` returns ``(from_left, from_right)``."""

    works: list
    from_left: torch.Tensor | None
    from_right: torch.Tensor | None
    sent: tuple  # the staged send buffers, alive until the exchange is done
    device: torch.device

    def wait(self) -> tuple:
        for w in self.works:
            w.wait()
        return tuple(None if t is None else t.to(self.device) for t in (self.from_left, self.from_right))


def start_exchange(to_left, to_right, g: SolverGroup) -> Exchange:
    """Post one ring exchange: rank ``r`` sends ``to_left`` to ``r - 1`` and
    ``to_right`` to ``r + 1``, and receives ``r - 1``'s ``to_right`` (its
    ``from_left``) and ``r + 1``'s ``to_left`` (its ``from_right``).  Ring
    ends receive zeros.  Either may be None (that direction is not
    exchanged); every rank passes the same shapes.  A side without a
    neighbour only gives the shape (it is neither read nor copied).  On gloo
    the buffers are host copies."""
    dev = g.transport

    def recv_buf(like):
        return None if like is None else torch.zeros(like.shape, dtype=like.dtype, device=dev)

    from_left, from_right = recv_buf(to_right), recv_buf(to_left)
    r, last = g.rank, g.world - 1
    ops, sent = [], []

    def send(t, peer):
        t = t.to(dev).contiguous()
        sent.append(t)
        ops.append(dist.P2POp(dist.isend, t, g.peer(peer), g.group))

    if to_left is not None:
        if r > 0:
            send(to_left, r - 1)
        if r < last:
            ops.append(dist.P2POp(dist.irecv, from_right, g.peer(r + 1), g.group))
    if to_right is not None:
        if r < last:
            send(to_right, r + 1)
        if r > 0:
            ops.append(dist.P2POp(dist.irecv, from_left, g.peer(r - 1), g.group))
    with g.on_device():
        works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(works, from_left, from_right, tuple(sent), g.device)


class RingExchange:
    """The ring exchange of four messages that live across calls: this rank's
    ``to_left`` goes into the left neighbour's ``from_right`` and its
    ``to_right`` into the right neighbour's ``from_left``.  The messages are
    tensors on ``g.device`` that the caller owns (``EdgePlan``'s), None on a
    side without a neighbour; every rank gives the same shapes.  On gloo with
    a CUDA device they travel through host copies, allocated here, once.

    :meth:`post` starts the exchange and returns its handles at once;
    :meth:`wait` returns when ``from_left`` / ``from_right`` hold the
    neighbours' messages for work queued afterwards on the current stream.

    Reusing the messages is safe because every :meth:`post` is followed by
    its :meth:`wait` before the caller writes ``to_*`` again:
    * NCCL: the sends are queued on NCCL's stream, after the work already on
      the current stream (the packing launch that fills ``to_*``);
      ``wait`` makes the current stream wait for them, so the next packing
      launch, queued on that stream later, cannot overtake a send that still
      reads its message, and whatever reads ``from_*`` runs after the
      receives;
    * gloo: ``post`` copies ``to_*`` to the host with a blocking copy, so
      the copy is complete (and ordered after the packing launch) before the
      send is posted and long before the card can rewrite the message;
      ``wait`` blocks the host until the sends have left the host copies
      and the receives have filled theirs, then copies these to the card
      from pageable memory, which returns once the source has been staged:
      the next ``post`` may overwrite both host copies."""

    def __init__(self, to_left, to_right, from_left, from_right, g: SolverGroup):
        self.group = g
        self.messages = (to_left, to_right, from_left, from_right)
        r, last = g.rank, g.world - 1
        if (to_left is None) != (r == 0) or (from_left is None) != (r == 0):
            raise ValueError(f"rank {r} of {g.world}: the left messages must be None exactly at the ring's start")
        if (to_right is None) != (r == last) or (from_right is None) != (r == last):
            raise ValueError(f"rank {r} of {g.world}: the right messages must be None exactly at the ring's end")
        self.staged = any(t is not None and t.device != g.transport for t in self.messages)
        if self.staged:
            self.wire = tuple(None if t is None else torch.empty(t.shape, dtype=t.dtype, device=g.transport)
                              for t in self.messages)
        else:
            self.wire = self.messages
        to_l, to_r, from_l, from_r = self.wire
        self.ops = []  # the batch's order is the same on every rank, as in start_exchange
        if to_l is not None:
            self.ops.append((dist.isend, to_l, g.peer(r - 1)))
        if from_r is not None:
            self.ops.append((dist.irecv, from_r, g.peer(r + 1)))
        if to_r is not None:
            self.ops.append((dist.isend, to_r, g.peer(r + 1)))
        if from_l is not None:
            self.ops.append((dist.irecv, from_l, g.peer(r - 1)))

    def post(self) -> list:
        if not self.ops:
            return []
        if self.staged:
            for wire, dev in zip(self.wire[:2], self.messages[:2]):
                if wire is not None:
                    wire.copy_(dev)  # blocking: complete on return
        g = self.group
        with g.on_device():
            return dist.batch_isend_irecv([dist.P2POp(op, t, peer, g.group) for op, t, peer in self.ops])

    def wait(self, works: list) -> None:
        for w in works:
            w.wait()
        if self.staged:
            for wire, dev in zip(self.wire[2:], self.messages[2:]):
                if wire is not None:
                    dev.copy_(wire)


def edge_columns(x: torch.Tensor, g: SolverGroup, width: int = 1) -> tuple:
    """``(left, right)``: the left neighbour's last ``width`` columns and the
    right neighbour's first ``width``, zeros at the ring ends."""
    return start_exchange(x[..., :width], x[..., -width:], g).wait()


def halo_neighbours(x: torch.Tensor, g: SolverGroup) -> tuple:
    """``(x_{-1}, x_{+1})`` of the global vector, on the local shard, from
    one exchange of both edge columns."""
    left, right = edge_columns(x, g)
    return torch.cat([left, x[..., :-1]], dim=-1), torch.cat([x[..., 1:], right], dim=-1)


def halo_shift(x: torch.Tensor, d: int, g: SolverGroup) -> torch.Tensor:
    """``out[..., k] = x_global[..., k + d]`` on the local shard."""
    if d == 0:
        return x
    if abs(d) != 1:  # compose unit shifts, one exchange each, as the JAX package does
        step = 1 if d > 0 else -1
        for _ in range(abs(d)):
            x = halo_shift(x, step, g)
        return x
    local = shift(x, d)
    if d > 0:  # the right neighbour's first column into the last slot
        _, right = start_exchange(x[..., :1], None, g).wait()
        return torch.cat([local[..., :-1], right], dim=-1)
    left, _ = start_exchange(None, x[..., -1:], g).wait()
    return torch.cat([left, local[..., 1:]], dim=-1)


# ---------------------------------------------------------------------------
# The shared vertex of a sharded CG level (parallel.distributed's node layout:
# the vertex that rank r's last element shares with rank r + 1 is owned by
# r + 1, as its first node; the last rank owns the level's last node)
# ---------------------------------------------------------------------------


def with_right_vertex(x: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The rank's own nodes and, after them, the vertex its last element
    shares with the next rank (that rank's first node): the nodes of the
    rank's elements.  The last rank's own nodes are already all of them."""
    if g.world == 1:
        return x
    _, right = start_exchange(x[..., :1], None, g).wait()
    return x if g.rank == g.world - 1 else torch.cat([x, right], dim=-1)


def fold_right_vertex(y: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The inverse of :func:`with_right_vertex` for a scatter-add: ``y`` on
    the nodes of the rank's elements, whose value at the shared vertex is
    sent to its owner and added there, after the owner's own contribution
    (the order of the whole level's ``index_add_``, whose element windows
    add in element order at each node position: the right element's first
    node before the left element's last)."""
    if g.world == 1:
        return y
    left, _ = start_exchange(None, y[..., -1:], g).wait()
    if g.rank < g.world - 1:
        y = y[..., :-1]
    if g.rank > 0:
        y = torch.cat([y[..., :1] + left, y[..., 1:]], dim=-1)
    return y


def take_left_vertex(y: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """Like :func:`fold_right_vertex` for a gather: the shared vertex takes
    the value the left element gives it (as the whole level's
    prolongation does), not the owner's own."""
    if g.world == 1:
        return y
    left, _ = start_exchange(None, y[..., -1:], g).wait()
    if g.rank < g.world - 1:
        y = y[..., :-1]
    if g.rank > 0:
        y = torch.cat([left, y[..., 1:]], dim=-1)
    return y
