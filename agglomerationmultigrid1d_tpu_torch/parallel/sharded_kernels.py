"""The fused smoother kernels on an element-sharded operator.

The counterpart of the JAX package's ``parallel/sharded_kernels.py``.
``jax.shard_map`` becomes "each rank calls the local function on its local
tensors": :func:`sharded_multisweep` and :func:`sharded_chebyshev_multisweep`
take the rank's shard of every operator stream and vector.  The sweeps need
the neighbours' columns as ghosts: of the streams (ML, MU, S^-1) and of x and
b.  The operators never change, so their ghosts are exchanged once
(:func:`operator_ghosts`), and with them the level's :func:`edge_plan` is
built once (``parallel.distributed.shard_hierarchy`` stores both on every
sharded float32 level): the operators checked and bound, the four messages
of the per-smoothing exchange allocated.  Per smoother application only the
edge columns of x and b go to the two ring neighbours, in one message each
way (a ring end has none: the global boundary).  Ghosts are
``min(GHOST_W, n)`` columns a side, enough for every step count the kernels
take.

``overlap=True`` (the default) orders a smoothing as the JAX package does,
in four steps (:func:`_kernel_schedule`): one packing launch copies the
edge columns of x and b into the plan's send messages; the exchange is
posted from them; the full-shard K1 / K2 / K5 launch runs with zero ghosts
while it is in flight; after the wait ONE edge-pair launch
(``EdgePlan.sweep_edges`` / ``chebyshev_edges``) recomputes the
``s = k + 1`` columns at both shard edges that the zero ghosts corrupted,
in place, reading the received messages where the exchange left them.  On
NCCL the exchange runs on the card beside the kernel; on gloo it runs in
the process's gloo threads while the card (or, on the CPU, the caller) runs
the full-shard pass.  An edge reads ``s`` columns a side: the exchanged
ghosts outside, the shard's own columns inside.  The TPU's two
``5 * 128``-column strips (``_STRIP_W``) are its tiling rule.  A shard
narrower than two edges, and ``overlap=False``, take one K7 launch over the
whole shard once the exchange is done.

Every float32 shard runs that schedule: the kernels on a CUDA tensor, their
plain versions on a CPU one.  A float32 shard narrower than the ``s``
columns its neighbour must lend cannot: on the card it raises, on the CPU it
takes the halo-aware plain sweep, as float64 shards do (the JAX package's
fallback): A-form sweeps on a matvec whose neighbour columns come from
:func:`..parallel.halo.halo_neighbours`.
"""

from __future__ import annotations

import torch

from ..ops.block_tridiag import BlockTridiag, block_mul, bt_matvec
from ..ops.kernels.block_kernels import (
    MAX_SWEEPS,
    EdgePlan,
    chebyshev_multisweep,
    chebyshev_multisweep_residual,
    multisweep,
    multisweep_residual,
)
from .halo import Exchange, RingExchange, halo_neighbours, start_exchange
from .multihost import SolverGroup

GHOST_W = MAX_SWEEPS + 1  # ghost columns a side: what MAX_SWEEPS steps and the residual reach


def _edge_exchange(ts, g: SolverGroup, width: int) -> Exchange:
    """Post the ring exchange of the edge ``width`` columns of the
    same-shaped tensors ``ts``, stacked: one message each way.  A ring end
    packs nothing on the side where it has no neighbour."""

    def pack(cols, has_peer):
        if not has_peer:
            return ts[0].new_empty((len(ts), *ts[0].shape[:-1], width))  # only its shape is read
        return torch.stack([t[..., cols] for t in ts])

    return start_exchange(
        pack(slice(None, width), g.rank > 0), pack(slice(-width, None), g.rank < g.world - 1), g
    )


def operator_ghosts(ml, mu, s_inv, g: SolverGroup, width: int = GHOST_W) -> torch.Tensor:
    """K7's operator ghosts ``gops (3, bs, bs, 2 w)`` for the rank's shard,
    ``w = min(width, n)``: the left neighbour's last ``w`` columns of ML, MU
    and S^-1, then the right neighbour's first ``w``; zeros at the ring
    ends.  Collective: every rank of ``g`` calls it."""
    left, right = _edge_exchange((ml, mu, s_inv), g, min(width, ml.shape[-1])).wait()
    return torch.cat([left, right], dim=-1)


def edge_plan(ml, mu, s_inv, a_diag, gops, g: SolverGroup) -> EdgePlan:
    """The rank's :class:`EdgePlan` of one sharded level, with the ring
    exchange of its messages (``plan.ring``).  Built once per level; no
    communication."""
    plan = EdgePlan(ml, mu, s_inv, a_diag, gops, left=g.rank > 0, right=g.rank < g.world - 1)
    plan.ring = RingExchange(plan.to_left, plan.to_right, plan.from_left, plan.from_right, g)
    return plan


def _halo_matvec(ad, al, au, x, g: SolverGroup):
    xm, xp = halo_neighbours(x, g)
    return bt_matvec(BlockTridiag(lower=al, diag=ad, upper=au), x, xm, xp)


def _kernel_schedule(plan: EdgePlan, launch, edges, x, b, n_steps: int, overlap: bool):
    """The fused path shared by :func:`_local_multisweep` and
    :func:`_local_cheb`: ``launch(ghosts)`` runs the full-shard kernel on x
    and b, ``edges(out)`` the plan's edge pair on its output."""
    s = n_steps + 1  # columns a zero-ghost pass corrupts (one more than k sweeps reach)
    plan.pack(x, b)
    works = plan.ring.post()
    if not overlap or x.shape[-1] < 2 * s:
        plan.ring.wait(works)
        return launch((plan.gops, plan.ghost_vectors()))
    out = launch(None)  # in flight with the exchange
    plan.ring.wait(works)  # every posted operation is done before the messages are written again
    return edges(out)


def _on_k7(x: torch.Tensor, n_steps: int) -> bool:
    """Whether the shard runs K7's schedule: float32, and the neighbour's
    ``min(GHOST_W, n)`` edge columns cover the ``k + 1`` the steps reach."""
    if x.dtype != torch.float32:
        return False
    if min(GHOST_W, x.shape[-1]) >= n_steps + 1:
        return True
    if x.device.type == "cuda":
        raise ValueError(
            f"a shard of {x.shape[-1]} columns is narrower than the {n_steps + 1} ghost columns "
            f"{n_steps} steps reach: shard with a larger min_blocks_per_device"
        )
    return False


def _bound_plan(plan, ml, mu, binv, ad, gops, group: SolverGroup) -> EdgePlan:
    """The level's plan when it was built from these very operators; else one
    made here (a direct call without a plan, or operators that were moved or
    cast since: the checks and allocations then run per call)."""
    if plan is not None and (gops is None or gops is plan.gops) and plan.bound_to(ml, mu, binv, ad, plan.gops):
        return plan
    ops = (ml.contiguous(), mu.contiguous(), binv.contiguous(), ad.contiguous())
    if gops is None:
        gops = operator_ghosts(*ops[:3], group)
    return edge_plan(*ops, gops, group)


def _local_multisweep(
    ad, al, au, binv, ml, mu, x, b, *, group, n_sweeps, alpha, emit_residual, gops=None, plan=None,
    overlap=True,
):
    if _on_k7(x, n_sweeps):
        plan = _bound_plan(plan, ml, mu, binv, ad, gops, group)
        ops, x, b = plan.ops, x.contiguous(), b.contiguous()

        def launch(ghosts):
            if emit_residual:
                return multisweep_residual(*ops, x, b, n_sweeps, alpha, ghosts=ghosts)
            return multisweep(*ops[:3], x, b, n_sweeps, alpha, ghosts=ghosts)

        return _kernel_schedule(
            plan, launch, lambda out: plan.sweep_edges(x, b, out, n_sweeps, alpha), x, b, n_sweeps, overlap
        )
    # halo-aware plain sweep (float64 / narrow shards on the CPU)
    for _ in range(n_sweeps):
        r = b - _halo_matvec(ad, al, au, x, group)
        x = x + alpha * torch.einsum("ijn,jn->in", binv, r)
    if emit_residual:
        return x, b - _halo_matvec(ad, al, au, x, group)
    return x


def _local_cheb(
    coef, ad, al, au, binv, ml, mu, x, b, *, group, degree, emit_residual, gops=None, plan=None,
    overlap=True,
):
    coef = tuple((float(c_d), float(c_z)) for c_d, c_z in coef)[:degree]
    if _on_k7(x, degree):
        plan = _bound_plan(plan, ml, mu, binv, ad, gops, group)
        ops, x, b = plan.ops, x.contiguous(), b.contiguous()

        def launch(ghosts):
            if emit_residual:
                return chebyshev_multisweep_residual(*ops, x, b, coef, ghosts=ghosts)
            return chebyshev_multisweep(*ops[:3], x, b, coef, ghosts=ghosts)

        return _kernel_schedule(
            plan, launch, lambda out: plan.chebyshev_edges(x, b, out, coef), x, b, degree, overlap
        )
    d = torch.zeros_like(x)
    for c_d, c_z in coef:
        z = torch.einsum("ijn,jn->in", binv, b - _halo_matvec(ad, al, au, x, group))
        d = c_d * d + c_z * z
        x = x + d
    if emit_residual:
        return x, b - _halo_matvec(ad, al, au, x, group)
    return x


def _wrapper_mform(a: BlockTridiag, s_inv, ml, mu, dtype):
    """The M-form streams where the kernels read them (float32); elsewhere
    whatever was given (the plain sweep does not read them)."""
    if dtype == torch.float32:
        if ml is None:
            ml = block_mul(s_inv, a.lower)
        if mu is None:
            mu = block_mul(s_inv, a.upper)
    return ml, mu


def sharded_multisweep(
    group: SolverGroup,
    a: BlockTridiag,
    s_inv: torch.Tensor,
    x: torch.Tensor,
    b: torch.Tensor,
    *,
    n_sweeps: int = 3,
    alpha: float = 2.0 / 3.0,
    emit_residual: bool = False,
    ml=None,
    mu=None,
    op_ghosts=None,
    plan=None,
    overlap: bool = True,
):
    """``n_sweeps`` fused damped block-Jacobi sweeps on the rank's shard of an
    element-sharded operator (optionally also ``r = b - A x_new``); every
    argument is the rank's local shard.  ``ml``/``mu`` are the setup-time
    M-form streams, ``op_ghosts`` their :func:`operator_ghosts` and ``plan``
    the level's :func:`edge_plan` over these very tensors; what is not given
    is formed (and the ghosts exchanged) here, per call.  ``overlap`` as in
    the module docstring; both schedules give the same result up to float32
    rounding of the recomputed edge columns."""
    ml, mu = _wrapper_mform(a, s_inv, ml, mu, x.dtype)
    return _local_multisweep(
        a.diag, a.lower, a.upper, s_inv, ml, mu, x, b, group=group, n_sweeps=n_sweeps,
        alpha=alpha, emit_residual=emit_residual, gops=op_ghosts, plan=plan, overlap=overlap,
    )


def sharded_chebyshev_multisweep(
    group: SolverGroup,
    a: BlockTridiag,
    s_inv: torch.Tensor,
    x: torch.Tensor,
    b: torch.Tensor,
    coef,
    *,
    degree: int = 3,
    emit_residual: bool = False,
    ml=None,
    mu=None,
    op_ghosts=None,
    plan=None,
    overlap: bool = True,
):
    """Degree-``degree`` Chebyshev smoothing on the rank's shard (see
    :func:`sharded_multisweep`); ``coef`` rows are ``(c_d, c_z)`` from
    ``ops.kernels.block_kernels.chebyshev_coefficients``."""
    ml, mu = _wrapper_mform(a, s_inv, ml, mu, x.dtype)
    return _local_cheb(
        coef, a.diag, a.lower, a.upper, s_inv, ml, mu, x, b, group=group, degree=degree,
        emit_residual=emit_residual, gops=op_ghosts, plan=plan, overlap=overlap,
    )
