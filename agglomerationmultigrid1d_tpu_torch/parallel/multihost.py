"""Process groups for the element-sharded solve, and the collectives it runs.

The counterpart of the JAX package's ``parallel/multihost.py:initialize`` /
``multihost_mesh`` and ``parallel/distributed.py:make_solver_mesh``.  A
:class:`SolverGroup` stands where the JAX package passes ``(mesh, axis)``:
one rank per process, each holding its own columns of the sharded levels.

Transport follows the backend, chosen by the group's ``backend`` and never by
catching an error: NCCL moves device tensors; gloo moves host tensors (its
point-to-point takes CPU tensors only), so on a card the few columns a gloo
collective carries go through host memory.

``build_sharded_xl_problem`` and the rest of the JAX module (per-process
construction of the stencil-inflated problem) are not ported yet (ROADMAP
queue 1, item 15).
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


def all_reduce_sum(t: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device (``t`` is not changed)."""
    buf = t.to(g.transport, copy=True)
    with g.on_device():
        dist.all_reduce(buf, group=g.group)
    return buf.to(t.device)


def all_gather_cols(t: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The ranks' ``t`` side by side along the last (element) axis, rank order."""
    buf = t.to(g.transport, copy=True).contiguous()
    parts = [torch.empty_like(buf) for _ in range(g.world)]
    with g.on_device():
        dist.all_gather(parts, buf, group=g.group)
    return torch.cat(parts, dim=-1).to(t.device)
