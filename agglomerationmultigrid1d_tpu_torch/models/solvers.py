"""Multigrid V-cycle and outer drivers (counterpart of ``src/solvers.jl``).

The drivers are host loops over eager tensor operations, with the reference's
observability contract ``(x, iterations, res_history, err_history)``.  Level
vectors are ``(n_nodes,)`` on CG levels and ``(bs, n)`` on block levels.

Kernel dispatch is by the level and the tensors: on a float32
block-tridiagonal level whose smoother is block-Jacobi, smoothing, the
restrict-side residual and the inner residual check go through the wrappers
of :mod:`..ops.kernels.block_kernels` (the CUDA kernels for CUDA tensors,
their plain M-form versions for CPU tensors): K1 / K2 for damped sweeps, K5
when the block-Jacobi smoother sits under a Chebyshev wrap.  Every other
level (CG levels, float64 levels, and, as in the JAX package,
block-pentadiagonal mixed-switch and block-COO scattered levels) smooths in
plain torch: damped sweeps ``u += alpha S (rhs - A u)`` or the Chebyshev
three-term recurrence.

Beyond float64 (:func:`multigrid`) and mixed precision
(:func:`multigrid_mixed`, float64 iterate; :func:`_mixed_loop_ff`, the JAX
package's float-float iterate on the stencil-built problems): progressive precision (:func:`v_cycle_ff`,
:func:`multigrid_progressive`; float32 sweeps, float-float residuals and
transfers) and TRUE precision (:func:`v_cycle_true`, :func:`multigrid_true`;
value-accurate operators throughout, the north-star solver), whose
fine-level float-float defects on a stencil operator go through kernel K6.

Sharded hierarchies (``parallel.distributed.shard_hierarchy`` and
``parallel.multihost.build_sharded_xl_problem``) run through the same
functions: on a level that ``h.layout`` holds sharded, every matvec takes its
halo columns from the neighbour ranks (one a side on a block-tridiagonal
level, two on a block-pentadiagonal one, ``p`` nodes on a CG level; a
block-COO level the columns its rows name, ``parallel.columns``), norms
all-reduce, aligned transfers stay local (a CG level's exchange the vertex
two ranks share, ``parallel.cg_levels``; the last sharded level restricts
locally, then gathers), straddling and scattered ones read and send the
coarse or fine columns they share (``parallel.transfers``), and the
coarsest level is solved whole on every rank.  A sharded float32 block level smooths through
``parallel.sharded_kernels`` (K7's schedule), a sharded float64 or CG level
with plain sweeps on halo matvecs; a sharded stencil fine operator's
float-float defect is kernel K6s.  ``multigrid_true`` stays unsharded, as in
the JAX package.

Every solve is marked for ``torch.profiler`` by spans (``utils.profiling.span``,
``cpu_op`` events that cost about half a microsecond with no profiler):
``aggmg.solve.<driver>`` around a public driver, ``aggmg.vcycle.<kind>``
(``f32``, ``f64``, ``ff``, ``true``) around a whole V-cycle, and inside it
four phases that partition its work, level ``k`` as a suffix:
``aggmg.smooth@k`` (the sweeps, with a residual fused into them),
``aggmg.transfer@k`` (restriction, prolongation and the correction add),
``aggmg.coarse`` and ``aggmg.defect@k`` (every residual and norm computed
outside a smoother, the drivers' stopping tests at ``@0``).  The three
V-cycles are one level walk, :func:`_cycle`, with a step set of their
precision (:class:`_Steps`), and it alone opens the phases.  Inside a phase
span, the work on a CG level ``k`` is also an ``aggmg.cg@k`` span, and the
work on a block-COO level ``k`` an ``aggmg.bcoo@k`` span; neither is a
phase, and neither holds another.  Each host read that waits for the device
is an ``aggmg.sync.<site>`` span of its own and lies in no phase.
"""

from __future__ import annotations

import contextlib
import operator
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.block_coo import BlockCOO, bcoo_matvec
from ..ops.block_diag import BlockDiag, bd_matvec
from ..ops.block_penta import BlockPenta, bp5_matvec
from ..ops.block_tridiag import BlockTridiag, block_mul, bt_matvec
from ..ops.shifts import shift
from ..ops.cg_operator import cg_matvec
from ..ops.coarse_solve import coarse_solve
from ..ops.df64 import (
    FF,
    BTFFStencil,
    bp5_split,
    bt_split,
    cg_band_split,
    f64_bt_defect_stencil,
    ff_add,
    ff_defect,
    ff_join,
    ff_split,
)
from ..ops.df64 import BlockPentaFF, BlockTridiagFF, CgBandFF, ff_bp5_defect, ff_bt_defect, ff_bt_defect_stencil, ff_cg_defect
from ..ops.kernels.block_kernels import (
    chebyshev_multisweep,
    chebyshev_multisweep_residual,
    fused_bt_matvec,
    multisweep,
    multisweep_residual,
)
from ..ops.cg_operator import CgOperator
from ..ops.kernels import block_kernels
from ..parallel.cg_levels import (
    apply_smoother_sharded,
    cg_matvec_sharded,
    cgp_prolong_sharded,
    cgp_restrict_sharded,
    seam_prolong_sharded,
    seam_restrict_sharded,
)
from ..parallel.columns import gather_cols
from ..parallel.distributed import level_widths
from ..parallel.halo import edge_columns, halo_neighbours
from ..parallel.multihost import all_gather_cols, all_reduce_sum, local_range, node_range, node_widths
from ..parallel.sharded_kernels import sharded_chebyshev_multisweep, sharded_multisweep
from ..parallel.transfers import SHARD_TRANSFERS, shard_prolong, shard_restrict
from ..ops.transfer_ops import (
    BlockProlong,
    CgProlong,
    RaggedBlockProlong,
    SeamProlong,
    bp_prolong,
    bp_restrict,
    cgp_prolong,
    cgp_restrict,
    rbp_prolong,
    rbp_restrict,
    seam_prolong,
    seam_restrict,
)
from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother, SchwarzSmoother, apply_smoother
from ..transfer.scattered_transfer import ScatteredProlong, sp_prolong, sp_restrict
from ..utils.profiling import span
from .hierarchy import BlockLevel, CgLevel, Hierarchy, operator_data


def _group(h: Hierarchy, k: int):
    """The SolverGroup of level ``k`` when ``h`` holds it sharded, else None."""
    lay = h.layout
    return lay.group if lay is not None and lay.sharded[k] else None


_NO_SPAN = contextlib.nullcontext()


def _family_span(level, k: int):
    """The span of level ``k``'s family around work on it (its smoothing,
    its defects and norms, the transfers from it), opened inside the phase
    span that holds the work: ``aggmg.cg@k`` on a CG level, ``aggmg.bcoo@k``
    on a block-COO (scattered) level; nothing on a block-tridiagonal or
    pentadiagonal level."""
    if isinstance(level, CgLevel):
        return span(f"aggmg.cg@{k}")
    if isinstance(level, BlockLevel) and isinstance(level.a, BlockCOO):
        return span(f"aggmg.bcoo@{k}")
    return _NO_SPAN


def _is_slim_bt(level) -> bool:
    """A *slim* fine level (``build_xl_problem(..., slim_fine=True)``): its
    operator keeps only the diagonal blocks; the off-diagonal action lives in
    the smoother's M-form streams (``A = D (I + ML_shift + MU_shift)``, since
    ``ML = D^-1 L``)."""
    return (
        isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and level.a.lower.numel() == 0
        and level.a.diag.numel() > 0
    )


def _mform_matvec(level, x: torch.Tensor, xm=None, xp=None) -> torch.Tensor:
    """``A x = D (x + ML x_- + MU x_+)`` from the M-form smoother streams:
    exact up to one float32 rounding of the off-diagonal terms (ML and MU are
    rounded products), which is enough where the solver reads a residual's
    size (the inner solve's stall check); the trustworthy defect is the
    float-float one.  ``xm`` / ``xp`` are ``x_{k-1}`` / ``x_{k+1}`` where the
    caller has them (a shard's, with the neighbours' edge columns); by
    default the zero-padded shifts."""
    base = _base_smoother(level)
    xm = shift(x, -1) if xm is None else xm
    xp = shift(x, +1) if xp is None else xp
    t = x + bd_matvec(BlockDiag(base.ml), xm) + bd_matvec(BlockDiag(base.mu), xp)
    return bd_matvec(BlockDiag(level.a.diag), t)


def level_matvec(level, x: torch.Tensor, group=None) -> torch.Tensor:
    """``A x``; with ``group``, ``x`` is the rank's shard of a sharded level."""
    if isinstance(level, CgLevel):
        return cg_matvec(level.a, x) if group is None else cg_matvec_sharded(level.a, x, group)
    if isinstance(level.a, BlockPenta):
        return bp5_matvec(level.a, x) if group is None else bp5_matvec(level.a, x, *edge_columns(x, group, width=2))
    if isinstance(level.a, BlockCOO):
        return bcoo_matvec(level.a, x if group is None else gather_cols(x, level.a.halo, group))
    if group is None:
        return _mform_matvec(level, x) if _is_slim_bt(level) else bt_matvec(level.a, x)
    if _is_slim_bt(level):
        return _mform_matvec(level, x, *halo_neighbours(x, group))
    return bt_matvec(level.a, x, *halo_neighbours(x, group))


def transfer_prolong(l, xc: torch.Tensor) -> torch.Tensor:
    if isinstance(l, CgProlong):
        return cgp_prolong(l, xc)
    if isinstance(l, BlockProlong):
        return bp_prolong(l, xc)
    if isinstance(l, RaggedBlockProlong):
        return rbp_prolong(l, xc)
    if isinstance(l, SeamProlong):
        return seam_prolong(l, xc)
    if isinstance(l, ScatteredProlong):
        return sp_prolong(l, xc)
    raise TypeError(type(l))


def transfer_restrict(l, rf: torch.Tensor) -> torch.Tensor:
    if isinstance(l, CgProlong):
        return cgp_restrict(l, rf)
    if isinstance(l, BlockProlong):
        return bp_restrict(l, rf)
    if isinstance(l, RaggedBlockProlong):
        return rbp_restrict(l, rf)
    if isinstance(l, SeamProlong):
        return seam_restrict(l, rf)
    if isinstance(l, ScatteredProlong):
        return sp_restrict(l, rf)
    raise TypeError(type(l))


def _flatten_level_vec(x: torch.Tensor) -> torch.Tensor:
    """Level vector -> flat DoF vector (block levels: dof = k * bs + i)."""
    if x.ndim == 1:
        return x
    return x.T.reshape(-1)


def _unflatten_level_vec(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.ndim == 1:
        return flat
    bs, n = like.shape
    return flat.reshape(n, bs).T


def _norm(x: torch.Tensor, group=None) -> torch.Tensor:
    """2-norm of a level vector; with ``group``, of the vector whose shard ``x`` is."""
    if group is None:
        return torch.linalg.vector_norm(x.reshape(-1))
    return torch.sqrt(all_reduce_sum(torch.sum(x * x), group))


def _read_norm(level, site: str, norm) -> float:
    """An outer loop's host read of a norm on level 0 (``level``): ``norm()``, a
    0-d tensor, runs in ``aggmg.defect@0``, the read in ``aggmg.sync.<site>``."""
    with span("aggmg.defect@0"), _family_span(level, 0):
        value = norm()
    with span(f"aggmg.sync.{site}"):
        return float(value)


def _local_transfer(t: BlockProlong, group) -> BlockProlong:
    """The rank's coarse columns of a whole block transfer."""
    lo, hi = local_range(t.n_coarse, group)
    return BlockProlong(t.blocks[..., lo:hi])


def _cg_widths(level, g) -> list | None:
    """Every rank's node count on a whole CG level once sharded
    (``multihost.node_widths``); None on a block level (equal shards)."""
    return node_widths(level.a.n_el, level.a.p, g) if isinstance(level, CgLevel) else None


def _own_part(level, x: torch.Tensor, g) -> torch.Tensor:
    """The rank's part of a whole level's vector ``x``: its nodes of a CG
    level, its columns of a block level; ``level`` is the whole level."""
    if isinstance(level, CgLevel):
        lo, hi = node_range(level.a.n_el, level.a.p, g)
    else:
        lo, hi = local_range(x.shape[-1], g)
    return x[..., lo:hi]


def _restrict(h: Hierarchy, k: int, r: torch.Tensor) -> torch.Tensor:
    """Restrict level ``k``'s residual to level ``k + 1``.  On a sharded
    level: an aligned block transfer restricts locally (then gathers onto a
    whole coarse level); the CG and seam transfers of a sharded CG level
    exchange the vertex two ranks share (``parallel.cg_levels``); a transfer
    whose agglomerates straddle the ranks or scatter over them reads the
    fine columns its groups share, or sends its partial sums to their
    owners (``parallel.transfers``).  Below a whole level, a sharded coarse
    level takes its part of the whole restriction."""
    t, g, gc = h.transfers[k], _group(h, k), _group(h, k + 1)
    if g is None:
        rc = transfer_restrict(t, r)
        return rc if gc is None else rc[..., slice(*local_range(rc.shape[-1], gc))]
    if isinstance(t, SHARD_TRANSFERS):
        return shard_restrict(t, r, g)
    if isinstance(t, BlockProlong):
        if gc is None:
            return all_gather_cols(transfer_restrict(_local_transfer(t, g), r), g)
        return transfer_restrict(t, r)
    rc = cgp_restrict_sharded(t, r, g) if isinstance(t, CgProlong) else seam_restrict_sharded(t, r, g)
    return rc if gc is not None else all_gather_cols(rc, g, _cg_widths(h.levels[k + 1], g))


def _prolong(h: Hierarchy, k: int, uc: torch.Tensor) -> torch.Tensor:
    """Prolong level ``k + 1``'s correction to level ``k``; from a whole
    coarse level onto a sharded one, the rank's part only; from a sharded
    coarse level onto a whole one, after gathering it."""
    t, g, gc = h.transfers[k], _group(h, k), _group(h, k + 1)
    if g is None:
        return transfer_prolong(t, uc if gc is None else all_gather_cols(uc, gc))
    if isinstance(t, SHARD_TRANSFERS):
        return shard_prolong(t, uc, g)
    if gc is None:
        if isinstance(t, BlockProlong):
            lo, hi = local_range(t.n_coarse, g)
            return transfer_prolong(_local_transfer(t, g), uc[..., lo:hi])
        uc = _own_part(h.levels[k + 1], uc, g)
    if isinstance(t, CgProlong):
        return cgp_prolong_sharded(t, uc, g)
    if isinstance(t, SeamProlong):
        return seam_prolong_sharded(t, uc, g)
    return transfer_prolong(t, uc)


def _schwarz_span(s, k: int | None):
    """``aggmg.schwarz@k`` around one apply of a Schwarz smoother on CG
    level ``k`` (the window gather, contraction and scatter-add, the
    multiplicity scale), opened inside that level's ``aggmg.cg@k``; nothing
    for any other smoother, or where the caller gives no level."""
    return span(f"aggmg.schwarz@{k}") if k is not None and isinstance(s, SchwarzSmoother) else _NO_SPAN


def _smoother_apply(s, r: torch.Tensor, alpha: float = 1.0, group=None, k: int | None = None) -> torch.Tensor:
    """``alpha S r``; with ``group``, on the rank's shard (a Schwarz
    smoother's windows exchange the shared vertex).  ``k``: the level's
    index, for :func:`_schwarz_span`."""
    with _schwarz_span(s, k):
        return apply_smoother(s, r, alpha) if group is None else apply_smoother_sharded(s, r, alpha, group)


def _base_smoother(level):
    s = level.smoother
    return s.base if isinstance(s, ChebyshevSmoother) else s


def _on_kernels(level, u: torch.Tensor) -> bool:
    """Whether the level smooths through the fused block kernels: float32
    data on a block-tridiagonal level with a block-Jacobi (base) smoother.
    The kernels' M-form streams hold the tridiagonal couplings only, so a
    pentadiagonal or block-COO level smooths in plain torch."""
    return (
        u.dtype == torch.float32
        and isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and isinstance(_base_smoother(level), BlockJacobiSmoother)
    )


def _mform(level: BlockLevel):
    """``(ML, MU)`` — precomputed by ``prepare_fast_smoothers``, or formed here."""
    s = _base_smoother(level)
    ml = s.ml if s.ml is not None else block_mul(s.inv, level.a.lower)
    mu = s.mu if s.mu is not None else block_mul(s.inv, level.a.upper)
    return ml, mu


def _smooth_cheb(level, u, rhs, degree, emit_residual=False, group=None, k=None):
    """Degree-``degree`` Chebyshev smoothing (see ChebyshevSmoother): the
    classic three-term recurrence on the preconditioned residual, one matvec
    and one base-smoother application per degree, the cost of a damped sweep.

    On a kernel level all degrees (and optionally the restrict-side residual)
    run in one K5 launch, with the level's float32 recurrence table; elsewhere
    the recurrence runs in plain torch on the level's own-precision interval
    (no host read).  ``group`` marks ``u`` as the rank's shard of a sharded
    level: the kernel level then runs K7's schedule
    (``parallel.sharded_kernels``), the plain recurrence takes halo matvecs.
    ``k``: the level's index (:func:`_schwarz_span`)."""
    s = level.smoother
    if _on_kernels(level, u):
        if s.coef is None or degree > len(s.coef):
            raise ValueError(
                "a float32 Chebyshev level needs its recurrence table for "
                f"{degree} steps: build the hierarchy with make_low_precision_hierarchy "
                "(or prepare_fast_smoothers)"
            )
        ml, mu = _mform(level)
        coef = s.coef[:degree]
        if group is not None:
            return sharded_chebyshev_multisweep(
                group, level.a, s.base.inv, u, rhs, coef, degree=degree,
                emit_residual=emit_residual, ml=ml, mu=mu, op_ghosts=s.base.ghosts, plan=s.base.plan,
            )
        if emit_residual:
            return chebyshev_multisweep_residual(
                ml, mu, s.base.inv, level.a.diag, u.contiguous(), rhs.contiguous(), coef
            )
        return chebyshev_multisweep(ml, mu, s.base.inv, u.contiguous(), rhs.contiguous(), coef)

    u = _chebyshev(s, degree, u, lambda u: rhs - _level_matvec_opt(level, u, group), operator.add, group, k)
    if emit_residual:
        return u, rhs - _level_matvec_opt(level, u, group)
    return u


def _chebyshev(s, degree, u, residual, update, group=None, k=None):
    """The Chebyshev three-term recurrence of ``s`` (a ChebyshevSmoother),
    ``degree`` steps on the preconditioned residual ``S_base residual(u)``;
    ``update(u, d)`` is ``u + d`` in the iterate's own form.  The recurrence
    runs in the level's own precision, on 0-d tensors (no host read)."""
    theta = 0.5 * (s.lam_hi + s.lam_lo)
    delta = 0.5 * (s.lam_hi - s.lam_lo)
    sigma = theta / delta
    rho = 1.0 / sigma

    d = _smoother_apply(s.base, residual(u), group=group, k=k) / theta
    u = update(u, d)
    for _ in range(1, degree):
        z = _smoother_apply(s.base, residual(u), group=group, k=k)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        u = update(u, d)
        rho = rho_new
    return u


def _smooth_n(level, u, rhs, n_sweeps, alpha, group=None, residual=False, k=None):
    """``n_sweeps`` damped smoother applications ``u += alpha S (rhs - A u)``;
    a Chebyshev level runs the degree-``n_sweeps`` recurrence instead
    (``alpha`` is ignored: the damping is in the polynomial).  With
    ``residual``, ``(u, rhs - A u)`` of the smoothed ``u``.  ``group`` and
    ``k`` as in :func:`_smooth_cheb`."""
    s = level.smoother
    if isinstance(s, ChebyshevSmoother):
        return _smooth_cheb(level, u, rhs, n_sweeps, emit_residual=residual, group=group, k=k)
    if _on_kernels(level, u):
        ml, mu = _mform(level)
        if group is not None:
            return sharded_multisweep(
                group, level.a, s.inv, u, rhs, n_sweeps=n_sweeps, alpha=alpha,
                emit_residual=residual, ml=ml, mu=mu, op_ghosts=s.ghosts, plan=s.plan,
            )
        if residual:
            return multisweep_residual(
                ml, mu, s.inv, level.a.diag, u.contiguous(), rhs.contiguous(), n_sweeps=n_sweeps, alpha=alpha,
            )
        return multisweep(ml, mu, s.inv, u.contiguous(), rhs.contiguous(), n_sweeps=n_sweeps, alpha=alpha)
    for _ in range(n_sweeps):
        u = u + _smoother_apply(s, rhs - level_matvec(level, u, group), alpha, group, k)
    return (u, rhs - _level_matvec_opt(level, u, group)) if residual else u


def _level_matvec_opt(level, x, group=None):
    """``A x`` through K3 on float32 block-tridiagonal levels (not on a slim
    level, whose off-diagonals are empty).  On a shard, K3 sees zeros beyond
    its two edge columns; the neighbours' columns are then added to those two columns
    (``A_L x_{-1}`` on the first, ``A_U x_{+1}`` on the last)."""
    if (isinstance(level, BlockLevel) and isinstance(level.a, BlockTridiag) and x.dtype == torch.float32
            and not _is_slim_bt(level)):
        y = fused_bt_matvec(level.a, x.contiguous())
        if group is not None:
            left, right = edge_columns(x, group)
            y[:, :1] += torch.einsum("ijn,jn->in", level.a.lower[..., :1], left)
            y[:, -1:] += torch.einsum("ijn,jn->in", level.a.upper[..., -1:], right)
        return y
    return level_matvec(level, x, group)


class _Steps(NamedTuple):
    """The arithmetic of one kind of V-cycle, for :func:`_cycle`; the
    per-level steps take the level ``k`` first."""

    zeros: Callable  # rhs -> the zero iterate
    smooth: Callable  # (k, u, rhs, n_sweeps[, residual]) -> u, or (u, rhs - A u) with residual
    defect: Callable | None  # (k, u, rhs) -> rhs - A u; None: smooth returns it fused
    restrict: Callable  # (k, r) -> level k + 1's rhs
    prolong: Callable  # (k, e_c) -> level k's correction
    add: Callable  # (u, e) -> u + e
    coarse: Callable  # rhs -> the coarsest level's solution


def _cycle(h: Hierarchy, steps: _Steps, u, rhs, k: int, n_pre: int, n_post: int):
    """The V-cycle on levels ``k..end`` from ``u`` (None: from zero), the one
    place that opens the phase spans.  Level ``k``'s defect and its
    restriction are dropped before the coarser levels run."""
    if k == h.n_levels - 1:
        with span("aggmg.coarse"):
            return steps.coarse(rhs)
    level, fused = h.levels[k], steps.defect is None
    with span(f"aggmg.smooth@{k}"), _family_span(level, k):
        u = steps.zeros(rhs) if u is None else u
        if fused:
            u, r = steps.smooth(k, u, rhs, n_pre, residual=True)
        else:
            u = steps.smooth(k, u, rhs, n_pre)
    if not fused:
        with span(f"aggmg.defect@{k}"), _family_span(level, k):
            r = steps.defect(k, u, rhs)
    with span(f"aggmg.transfer@{k}"), _family_span(level, k):
        r_c = steps.restrict(k, r)
    del r
    e_c = _cycle(h, steps, None, r_c, k + 1, n_pre, n_post)
    del r_c
    with span(f"aggmg.transfer@{k}"), _family_span(level, k):
        u = steps.add(u, steps.prolong(k, e_c))
    with span(f"aggmg.smooth@{k}"), _family_span(level, k):
        return steps.smooth(k, u, rhs, n_post)


_KINDS = {torch.float32: "f32", torch.float64: "f64"}  # a V-cycle's span by its dtype


def v_cycle(
    h: Hierarchy,
    x0: torch.Tensor,
    b: torch.Tensor,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
) -> torch.Tensor:
    """One multigrid V-cycle (cf. ``solvers.jl:19-50``); on a sharded
    hierarchy ``x0``, ``b`` and the result are the rank's shards (see the
    module docstring).  The residual comes fused with the pre-smoothing; the
    coarsest level is a direct solve (cf. ``solvers.jl:39``), whole on every
    rank."""
    steps = _Steps(
        zeros=torch.zeros_like,
        smooth=lambda k, u, rhs, n, residual=False: _smooth_n(
            h.levels[k], u, rhs, n, alpha, _group(h, k), residual, k),
        defect=None,
        restrict=lambda k, r: _restrict(h, k, r),
        prolong=lambda k, e: _prolong(h, k, e),
        add=operator.add,
        coarse=lambda rhs: _unflatten_level_vec(coarse_solve(h.coarse, _flatten_level_vec(rhs)), rhs),
    )
    with span(f"aggmg.vcycle.{_KINDS.get(b.dtype, b.dtype)}"):
        return _cycle(h, steps, x0, b, 0, n_pre, n_post)


def mg_preconditioner(h: Hierarchy, b: torch.Tensor, **kw) -> torch.Tensor:
    """One V-cycle from a zero initial guess (the reference's ``ldiv!``)."""
    return v_cycle(h, torch.zeros_like(b), b, **kw)


class MultigridResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    res_history: torch.Tensor  # (maxiter,) float64 on the host, NaN beyond `iterations`
    err_history: torch.Tensor  # (maxiter,) float64 on the host, NaN beyond `iterations` (or all-NaN)
    inner_cycles: int | None = None  # mixed solver: total low-precision V-cycles run


def _dense_fine_solve(h: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """Host banded direct solve of the finest operator (the reference's
    ``u_exact = A \\ b``, ``solvers.jl:120``); observability only.  On a
    sharded fine level every rank gathers the operator and ``b``, solves, and
    keeps its own columns of the flat solution."""
    from ..ops.banded_solve import fine_direct_solve

    fine, g = h.levels[0], _group(h, 0)
    b_all = b
    if g is not None:
        if isinstance(fine, CgLevel):
            widths = level_widths(fine, g)
            fine = fine._replace(a=CgOperator(windows=all_gather_cols(fine.a.windows, g),
                                              band=all_gather_cols(fine.a.band, g, widths)))
            b_all = all_gather_cols(b, g, widths)
        else:
            fine = fine._replace(a=type(fine.a)(*(all_gather_cols(t, g) for t in fine.a)))
            b_all = all_gather_cols(b, g)
    sol = torch.from_numpy(fine_direct_solve(fine, _flatten_level_vec(b_all).detach().cpu().numpy()))
    if g is not None:
        sol = _flatten_level_vec(_own_part(fine, _unflatten_level_vec(sol, b_all), g))
    return sol.to(device=b.device, dtype=b.dtype)


def multigrid(
    h: Hierarchy,
    x0: torch.Tensor,
    b: torch.Tensor,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    compute_error: bool = True,
) -> MultigridResult:
    """Outer V-cycle iteration until ``||Ax - b|| < tol * ||b||`` (``solvers.jl:116-139``).

    ``err_history`` tracks ``||x - A^-1 b||`` against a banded direct solve of
    the finest operator; ``compute_error=False`` skips it for large problems.
    On a sharded hierarchy ``x0``, ``b`` and ``x`` are the rank's shards.
    """
    with span("aggmg.solve.multigrid"):
        u_exact = _dense_fine_solve(h, b) if compute_error else None
        fine, g0 = h.levels[0], _group(h, 0)
        norm_b = _read_norm(fine, "norm_b", lambda: _norm(b, g0))
        res_h = torch.full((maxiter,), float("nan"), dtype=torch.float64, device="cpu")
        err_h = torch.full((maxiter,), float("nan"), dtype=torch.float64, device="cpu")
        x = x0
        it = 0
        while it < maxiter:
            x = v_cycle(h, x, b, n_pre=n_pre, n_post=n_post, alpha=alpha)
            res = _read_norm(fine, "residual", lambda: _norm(level_matvec(fine, x, g0) - b, g0))
            res_h[it] = res
            if u_exact is not None:
                err_h[it] = _read_norm(fine, "error", lambda: _norm(_flatten_level_vec(x) - u_exact, g0))
            it += 1
            if res < tol * norm_b:
                break
    return MultigridResult(x=x, iterations=it, res_history=res_h, err_history=err_h)


def iterative_smoother_solve(
    level,
    x0: torch.Tensor,
    b: torch.Tensor,
    *,
    maxiter: int = 1000,
    tol: float = 1e-6,
    alpha: float = 1.0,
) -> MultigridResult:
    """Richardson iteration with the level's smoother, ``x += alpha S (b - A x)``,
    until ``||A x - b|| < tol * ||b||`` (``solvers.jl:189-213``), with the
    reference's contract: ``err_history`` against the banded direct solve of
    the level's operator.  A host loop, one host read per step."""
    from ..ops.banded_solve import fine_direct_solve

    u_exact = torch.from_numpy(fine_direct_solve(level, _flatten_level_vec(b).detach().cpu().numpy()))
    u_exact = u_exact.to(device=b.device, dtype=b.dtype)
    norm_b = float(torch.linalg.vector_norm(_flatten_level_vec(b)))
    res_h = torch.full((maxiter,), float("nan"), dtype=torch.float64)
    err_h = torch.full((maxiter,), float("nan"), dtype=torch.float64)
    x, it = x0, 0
    while it < maxiter:
        x = x + apply_smoother(level.smoother, b - level_matvec(level, x), alpha=alpha)
        res, err = torch.stack([
            torch.linalg.vector_norm(_flatten_level_vec(level_matvec(level, x) - b)),
            torch.linalg.vector_norm(_flatten_level_vec(x) - u_exact),
        ]).tolist()
        res_h[it], err_h[it] = res, err
        it += 1
        if res < tol * norm_b:
            break
    return MultigridResult(x=x, iterations=it, res_history=res_h, err_history=err_h)


# ---------------------------------------------------------------------------
# Mixed precision: low-precision inner solves inside a float64 refinement loop
# ---------------------------------------------------------------------------


def make_low_precision_hierarchy(h: Hierarchy, dtype: torch.dtype = torch.float32) -> Hierarchy:
    """Cast a hierarchy for use as the inner solver of :func:`multigrid_mixed`
    and, for float32, populate the M-form smoother streams the multisweep
    kernels read (:func:`..models.hierarchy.prepare_fast_smoothers`)."""
    from ..utils.precision import hierarchy_astype
    from .hierarchy import prepare_fast_smoothers

    hl = hierarchy_astype(h, dtype)
    if dtype == torch.float32:
        hl = prepare_fast_smoothers(hl)
    return hl


def _mixed_inner_solve(h_low, r, inner_tol, max_cycles, *, n_pre, n_post, alpha):
    """Solve the correction equation ``A e = r`` in low precision: V-cycles
    until the inner residual drops below ``inner_tol * ||r||``, stops
    contracting (a cycle that does not cut it below 0.7x: the low-precision
    noise floor, or an unstable iteration), or ``max_cycles`` ran.

    Returns ``(e_best, n_cycles, i_best)``: the iterate with the smallest
    inner residual, the cycles run, and after how many cycles the best came.
    One residual matvec (kernel K3) per cycle, and one host sync."""
    fine, g0 = h_low.levels[0], _group(h_low, 0)
    norm_r = _read_norm(fine, "inner_norm", lambda: _norm(r, g0))
    big = float(torch.finfo(r.dtype).max)
    e = torch.zeros_like(r)
    best_e, best_res, best_i = e, big, 0
    i, res, prev = 0, norm_r, big
    while i < max_cycles and not (res < inner_tol * norm_r or res > 0.7 * prev):
        e = v_cycle(h_low, e, r, n_pre=n_pre, n_post=n_post, alpha=alpha)
        new = _read_norm(fine, "inner_residual", lambda: _norm(r - _level_matvec_opt(fine, e, g0), g0))
        if new < best_res:
            best_e, best_res, best_i = e, new, i + 1
        i, res, prev = i + 1, new, res
    return best_e, i, best_i


def _guarded_refinement(rel_defect, propose, x, *, maxiter, tol, max_inner, trickle=False, info=None):
    """The guard of the mixed-precision refinement loops (:func:`_mixed_loop`
    in float64, :func:`_mixed_loop_ff` in float-float): each proposed
    correction is judged by the trustworthy defect, ``rel_defect(x) ->
    (r, rel)``.  A step that does not improve on the best iterate is
    rejected, and the next proposal starts again from the best iterate with a
    correction halved per rejection in a row and a single inner cycle; three
    rejections in a row end the iteration.  The inner cycle limit adapts:
    after an improving step it is the cycle count at which that inner solve
    found its best, plus one on every 4th step (a re-probe).  With
    ``trickle`` the iteration also ends once it only trickles: less than a
    decade over the last three outer steps, compared in float32 as the JAX
    package's host loop does.

    ``propose(x_best, r_best, cap, scale) -> (x_new, n_cycles, i_best)``
    solves the correction equation in low precision with at most ``cap``
    cycles and adds ``scale`` times the correction.  ``rel`` and ``tol`` may
    be float32 scalars; the comparisons then run in float32, as on the card
    in the JAX package.

    Returns ``(x, outer, cycles, rel_history)`` with the best relative defect
    after each outer step (NaN beyond ``outer``).  ``info``, a dict, gets
    ``ended`` (``"tol"``, ``"rejections"``, ``"budget"`` or ``"trickle"``)
    and ``defects``, the calls of ``rel_defect``."""
    rel_h = np.full((maxiter,), np.nan)
    x_cur = x_best = x
    r_best = None
    rel_best = float("inf")
    i = cycles = streak = defects = 0
    limit = max_inner
    ended = "budget"
    while i < maxiter:
        # evaluate the previous proposal against the trustworthy defect
        r, rel = rel_defect(x_cur)
        defects += 1
        improved = rel < rel_best
        if improved:
            x_best, r_best = x_cur, r
        rel_best = min(rel, rel_best)
        streak = 0 if improved else streak + 1
        if i > 0:
            rel_h[i - 1] = rel_best
        if rel_best < tol or streak >= 3 or cycles >= maxiter:
            ended = "tol" if rel_best < tol else "rejections" if streak >= 3 else "budget"
            break
        if trickle and i >= 4 and np.float32(rel_best) > np.float32(0.1) * np.float32(rel_h[i - 4]):
            ended = "trickle"
            break

        # next proposal, from the best iterate
        probe = 1 if (i % 4 == 0 and improved) else 0
        cap = min((limit if improved else 1) + probe, max_inner)
        scale = 0.5**streak if streak > 0 else 1.0
        del r
        x_cur, n_cyc, i_best = propose(x_best, r_best, cap, scale)
        cycles += n_cyc
        limit = max(limit, 1) if not improved else max(1, i_best)
        i += 1

    # the final proposal may beat the recorded best; keep whichever is better
    _, rel_last = rel_defect(x_cur)
    x_out = x_cur if rel_last < rel_best else x_best
    if i > 0:
        rel_h[i - 1] = min(rel_last, rel_best)
    if info is not None:
        info.update(ended=ended, defects=defects + 1)
    return x_out, i, cycles, rel_h


def _mixed_loop(h, h_low, x, b, norm_b, *, maxiter, tol, inner_tol, max_inner, kw):
    """Guarded iterative refinement (:func:`_guarded_refinement`) with x and
    the defect ``b - A x`` in float64: the fine level's own matvec in native
    float64, ``cg_matvec`` on a CG level.  The counterpart of the JAX
    package's ``_mixed_loop_ff``, whose float-float pairs stand in for the
    float64 a TPU lacks (the port has that loop too: :func:`_mixed_loop_ff`).

    Returns ``(x, outer, cycles, rel_history)``."""
    fine, g0 = h.levels[0], _group(h, 0)
    low_dtype = operator_data(h_low.levels[0].a).dtype

    def rel_defect(x):
        with span("aggmg.defect@0"), _family_span(fine, 0):
            r = b - level_matvec(fine, x, g0)
            norm_r = _norm(r, g0)
        with span("aggmg.sync.defect"):
            return r, float(norm_r) / norm_b

    def propose(x_best, r_best, cap, scale):
        e, n_cyc, i_best = _mixed_inner_solve(h_low, r_best.to(low_dtype), inner_tol, cap, **kw)
        return x_best + scale * e.to(x_best.dtype), n_cyc, i_best

    return _guarded_refinement(rel_defect, propose, x, maxiter=maxiter, tol=tol, max_inner=max_inner)


def _mixed_loop_ff(
    h_low, a_ff, x_ff: FF, b_ff: FF, inv_norm_b, *, maxiter, tol, inner_tol, max_inner,
    n_pre=3, n_post=3, alpha=2.0 / 3.0, ffops=None, info=None,
):
    """The JAX package's guarded float-float refinement: the iterate is a
    float-float pair and every defect is the float-float one of ``a_ff``
    (``ops.df64.ff_defect``: a ``BlockTridiagFF``, a ``BTFFStencil`` through
    K6 on the card, or a ``CgBandFF``), judged by :func:`_guarded_refinement`;
    the correction equation is solved in float32 on ``h_low`` from the hi
    part of the best defect.  The relative defect is the float32 norm of the
    hi part times ``inv_norm_b`` (a float32 ``1 / ||b||``), as in the JAX
    package, so the stopping decisions follow its counts.

    Inputs come from ``stencil_setup.build_xl_problem``::

        h_low, a_ff, b_ff, norm_b = build_xl_problem(spec, n, device="cuda")
        x_ff, outer, cycles, hist = _mixed_loop_ff(
            h_low, a_ff, FF(zeros, zeros), b_ff, np.float32(1 / norm_b),
            maxiter=60, tol=1e-10, inner_tol=3e-5, max_inner=20)

    With ``ffops`` (the ``FFOps`` of ``build_xl_problem(..., ff_levels=True)``,
    ``a_ff`` its ``a_ffs[0]``) the refinement hands over to the
    TRUE-precision cycles of :func:`multigrid_true` once it only trickles
    (less than a decade over three outer steps) or stops above ``tol``: the
    float32 inner V-cycle stops contracting where ``eps_f32 * kappa_elem(A)``
    nears 1, the true cycles do not.  Their steps are appended to the
    history and counted in both ``outer`` and ``cycles``, as in the JAX
    package's host loop.  Unsharded hierarchies only, as ``multigrid_true``.

    Returns ``(x_ff, outer, cycles, rel_history)``, the history float32.
    ``info``, a dict, gets the guarded phase's ``ended`` and ``defects`` (see
    :func:`_guarded_refinement`), ``guarded_outer``, ``guarded_cycles`` and
    ``true_cycles``."""
    if ffops is not None and h_low.layout is not None:
        raise ValueError(
            "_mixed_loop_ff(ffops=) takes an unsharded hierarchy (a sharded TRUE-precision solve is a "
            "feature the JAX package lacks: ROADMAP queue 1, item 15, open question)"
        )
    with span("aggmg.solve._mixed_loop_ff"):
        kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha)
        inv = float(np.float32(inv_norm_b))
        info = {} if info is None else info

        g0 = _group(h_low, 0)

        def rel_defect(x):
            # only the hi part feeds the float32 inner solve: keep no lo tail
            with span("aggmg.defect@0"), _family_span(h_low.levels[0], 0):
                r = _ff_defect(a_ff, x, b_ff, g0).hi
                rel = _norm(_flatten_level_vec(r) * inv, g0)
            with span("aggmg.sync.defect"):
                return r, np.float32(float(rel))

        def propose(x_best, r_best, cap, scale):
            e, n_cyc, i_best = _mixed_inner_solve(h_low, r_best, inner_tol, cap, **kw)
            e = e * scale  # a power of two: exact
            return ff_add(x_best, FF(e, torch.zeros_like(e))), n_cyc, i_best

        x, outer, cycles, rel_h = _guarded_refinement(
            rel_defect, propose, x_ff, maxiter=maxiter, tol=np.float32(tol), max_inner=max_inner,
            trickle=ffops is not None, info=info,
        )
        info.update(guarded_outer=outer, guarded_cycles=cycles, true_cycles=0)
        remaining = maxiter - max(cycles, outer)
        if ffops is not None and outer > 0 and rel_h[outer - 1] > tol and remaining > 0:
            # the guarded working set (best pair, its defect, the last correction)
            # went with _guarded_refinement's frame: the true cycle needs ~2x the
            # float32 cycle's memory
            x, it2, res2 = _progressive_true_eager(
                h_low, ffops, x, b_ff, inv_norm_b, maxiter=remaining, tol=tol, **kw
            )
            rel_h[outer : outer + it2] = res2[:it2]
            outer += it2
            cycles += it2
            info["true_cycles"] = it2
        return x, outer, cycles, rel_h.astype(np.float32)


def multigrid_mixed(
    h: Hierarchy,
    h_low: Hierarchy,
    x0: torch.Tensor,
    b: torch.Tensor,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    inner_tol: float = 3.0e-5,
    max_inner: int = 20,
) -> MultigridResult:
    """Mixed-precision iterative refinement: the correction equation
    ``A e = r`` is solved in low precision (``h_low``, float32 V-cycles
    through the kernels) down to ``inner_tol``-relative inner residual, while
    the iterate and the defect ``r = b - A x`` stay in float64 on ``h``'s fine
    operator.  See :func:`_mixed_loop` for the guarded outer loop.

    Returns the reference's observability contract: ``iterations`` counts
    outer refinement steps (``res_history[:iterations]`` is the float64 defect
    norm after each, ending with the returned iterate's); ``inner_cycles`` is
    the total number of low-precision V-cycles.

    Where the guarded loop stops above ``tol`` with iterations left (the
    low-precision inner V-cycle is not a contraction for this operator,
    ``cond(A) >~ 1/eps_f32``), the solve continues with progressive-precision
    cycles (:func:`_progressive_loop`) from the float-float split of ``x``,
    as the JAX package does; their steps are appended to ``res_history`` and
    counted in ``iterations`` and ``inner_cycles``.

    On sharded hierarchies (``h`` and ``h_low`` from ``shard_hierarchy``)
    ``x0``, ``b`` and ``x`` are the rank's shards.
    """
    with span("aggmg.solve.multigrid_mixed"):
        norm_b = _read_norm(h.levels[0], "norm_b", lambda: _norm(b, _group(h, 0)))
        kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha)
        x, outer, cycles, rel_h = _mixed_loop(
            h, h_low, x0.to(torch.float64), b, norm_b,
            maxiter=maxiter, tol=tol, inner_tol=inner_tol, max_inner=max_inner, kw=kw,
        )
        rel_out = rel_h[outer - 1] if outer > 0 else np.inf
        remaining = maxiter - max(cycles, outer)
        if rel_out > tol and remaining > 0:
            a_ffs = tuple(_ff_split_level(lv) for lv in h.levels)
            x_ff, it2, res2 = _progressive_loop(
                h_low, a_ffs, ff_split(x), ff_split(b), np.float32(1.0 / norm_b),
                maxiter=remaining, tol=tol, **kw,
            )
            rel_h[outer : outer + it2] = res2[:it2]
            outer += it2
            cycles += it2
            x = ff_join(x_ff)
    return MultigridResult(
        x=x,
        iterations=outer,
        res_history=torch.from_numpy(rel_h * norm_b),
        err_history=torch.full((maxiter,), float("nan"), dtype=torch.float64, device="cpu"),
        inner_cycles=cycles,
    )


# ---------------------------------------------------------------------------
# Progressive precision: float-float V-cycle with float32 smoothers
# ---------------------------------------------------------------------------


def _ff_split_level(lv):
    """Level operator -> float-float representation (CG band, tridiagonal or
    pentadiagonal).  A block-COO level has none, as in the JAX package."""
    if isinstance(lv, CgLevel):
        return cg_band_split(lv.a.band)
    if isinstance(lv.a, BlockPenta):
        return bp5_split(lv.a)
    if isinstance(lv.a, BlockCOO):
        raise TypeError(
            "a block-COO (scattered) level has no float-float operator: the "
            "progressive-precision cycles take tridiagonal and pentadiagonal levels"
        )
    return bt_split(lv.a)


def _ff_zeros_like(x: FF) -> FF:
    return FF(torch.zeros_like(x.hi), torch.zeros_like(x.lo))


def _smooth_ff(level, u_ff: FF, rhs_ff: FF, n_sweeps: int, alpha: float, group=None, k=None) -> FF:
    """Low-precision smoothing as a float-float-accumulated correction: the
    sweeps run in float32 on the hi parts (K2 / K5 on float32 block levels),
    and the change they make is folded into the float-float iterate, so the
    iterate's smooth-mode content is never truncated to float32."""
    u32 = _smooth_n(level, u_ff.hi, rhs_ff.hi, n_sweeps, alpha, group=group, k=k)
    delta = u32 - u_ff.hi
    return ff_add(u_ff, FF(delta, torch.zeros_like(delta)))


def _true_coarse_solve(coarse64, rhs_ff: FF) -> FF:
    """The coarsest solve from the float64 factorization, split to float-float."""
    flat = _flatten_level_vec(rhs_ff.hi).to(torch.float64) + _flatten_level_vec(rhs_ff.lo).to(torch.float64)
    sp = ff_split(coarse_solve(coarse64, flat))
    like = rhs_ff.hi
    return FF(_unflatten_level_vec(sp.hi, like), _unflatten_level_vec(sp.lo, like))


def _coarse_ff(h_low: Hierarchy, a_ff_c, r: FF) -> FF:
    """The coarsest solve of :func:`v_cycle_ff`: a float32 solve plus one
    float-float-defect refinement step (enough while the coarse operator is
    mildly conditioned)."""
    like = r.hi
    e1 = _unflatten_level_vec(coarse_solve(h_low.coarse, _flatten_level_vec(r.hi)), like)
    e_ff = FF(e1, torch.zeros_like(e1))
    d = ff_defect(a_ff_c, e_ff, r)
    e2 = _unflatten_level_vec(coarse_solve(h_low.coarse, _flatten_level_vec(d.hi)), like)
    return ff_add(e_ff, FF(e2, torch.zeros_like(e2)))


def _ff_defect(a_ff, x: FF, b: FF, group=None) -> FF:
    """``ff_defect``; on a shard, with the neighbours' hi and lo edge columns
    (one exchange for both parts): one column a side of a block operator
    (a stencil one through K6s, at the shard's global columns, a
    materialised one through K12), ``p`` nodes a side of a CG band."""
    if group is None:
        return ff_defect(a_ff, x, b)
    pair = torch.stack([x.hi, x.lo])
    if isinstance(a_ff, CgBandFF):
        left, right = edge_columns(pair, group, width=a_ff.hi.shape[0] // 2)
        return ff_cg_defect(a_ff, x, b, (FF(left[0], left[1]), FF(right[0], right[1])))
    if isinstance(a_ff, BTFFStencil):
        left, right = edge_columns(pair, group)
        lo, _ = local_range(a_ff.n, group)
        return ff_bt_defect_stencil(a_ff, x, b, lo, *(
            None if none else t[..., 0].contiguous()
            for t, none in ((left, group.rank == 0), (right, group.rank == group.world - 1))
        ))
    if isinstance(a_ff, BlockPentaFF):
        left, right = edge_columns(pair, group, width=2)
        return ff_bp5_defect(a_ff, x, b, FF(left[0], left[1]), FF(right[0], right[1]))
    if not isinstance(a_ff, BlockTridiagFF):
        raise TypeError(f"a sharded float-float defect of {type(a_ff).__name__}")
    left, right = edge_columns(pair, group)
    return ff_bt_defect(a_ff, x, b, left[..., 0].contiguous(), right[..., 0].contiguous())


def v_cycle_ff(
    h_low: Hierarchy,
    a_ffs,
    u_ff: FF,
    rhs_ff: FF,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
) -> FF:
    """One *progressive-precision* V-cycle: the control flow of
    :func:`v_cycle`, with every residual, transfer and iterate update in
    float-float while the smoother sweeps and the coarse solve run in
    float32 on ``h_low``.  ``a_ffs`` holds the per-level float-float
    operators split from the float64 hierarchy."""
    steps = _Steps(
        zeros=_ff_zeros_like,
        smooth=lambda k, u, rhs, n: _smooth_ff(h_low.levels[k], u, rhs, n, alpha, group=_group(h_low, k), k=k),
        defect=lambda k, u, rhs: _ff_defect(a_ffs[k], u, rhs, _group(h_low, k)),
        restrict=lambda k, r: FF(_restrict(h_low, k, r.hi), _restrict(h_low, k, r.lo)),
        prolong=lambda k, e: FF(_prolong(h_low, k, e.hi), _prolong(h_low, k, e.lo)),
        add=ff_add,
        coarse=lambda r: _coarse_ff(h_low, a_ffs[h_low.n_levels - 1], r),
    )
    with span("aggmg.vcycle.ff"):
        return _cycle(h_low, steps, u_ff, rhs_ff, 0, n_pre, n_post)


def _ff_rel_defect(a_ff, x_ff: FF, b_ff: FF, inv_norm_b, group=None) -> tuple:
    """``(r_ff, ||r_hi|| * inv_norm_b)``, the norm in float32 as in the JAX package."""
    r_ff = _ff_defect(a_ff, x_ff, b_ff, group)
    return r_ff, _norm(_flatten_level_vec(r_ff.hi) * float(inv_norm_b), group)


def _correction_loop(fine, defect, cycle, x_ff: FF, *, maxiter: int, tol: float, dtype):
    """The host loop of the progressive and TRUE-precision iterations: each
    cycle solves the CORRECTION equation ``A e = r`` from zero (with a
    well-scaled rhs every float32 cancellation inside the cycle is relative
    to the current residual, so the contraction holds down to the defect's
    floor), until the relative defect is below ``tol``.  ``defect(x_ff) ->
    (r_ff, rel)`` with ``rel`` a 0-d tensor, read once a cycle and compared
    as ``dtype``; ``cycle(r_ff) -> e_ff``.  Returns ``(x_ff, iterations,
    rel_history)``, the history (``dtype``) the relative defect after each
    cycle."""
    res_h = np.full((maxiter,), np.nan, dtype=dtype)
    it = 0
    while it < maxiter:
        with span("aggmg.defect@0"), _family_span(fine, 0):
            r_ff, rel = defect(x_ff)
        with span("aggmg.sync.defect"):
            rel = dtype(float(rel))
        if it > 0:
            res_h[it - 1] = rel
        if rel < dtype(tol):
            break
        e_ff = cycle(r_ff)
        del r_ff
        x_ff = ff_add(x_ff, e_ff)
        del e_ff
        it += 1
    if it > 0:  # the defect of the final iterate
        res_h[it - 1] = dtype(_read_norm(fine, "defect", lambda: defect(x_ff)[1]))
    return x_ff, it, res_h


def _progressive_loop(h_low, a_ffs, x_ff, b_ff, inv_norm_b, *, maxiter, tol, n_pre, n_post, alpha):
    """Progressive-precision iteration (the JAX package's
    ``_progressive_loop``): :func:`v_cycle_ff` cycles in
    :func:`_correction_loop` on the float-float defect, its norm, history
    and stopping test in float32."""
    g0 = _group(h_low, 0)
    return _correction_loop(
        h_low.levels[0],
        lambda x: _ff_rel_defect(a_ffs[0], x, b_ff, inv_norm_b, g0),
        lambda r: v_cycle_ff(h_low, a_ffs, _ff_zeros_like(r), r, n_pre=n_pre, n_post=n_post, alpha=alpha),
        x_ff, maxiter=maxiter, tol=tol, dtype=np.float32,
    )


def multigrid_progressive(
    h: Hierarchy,
    h_low: Hierarchy,
    x0: torch.Tensor,
    b: torch.Tensor,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
) -> MultigridResult:
    """Multigrid with progressive-precision V-cycles (:func:`v_cycle_ff`):
    float32 smoother sweeps and coarse solves, float-float everything else.
    It converges like the float64 iteration on operators where
    :func:`multigrid_mixed`'s float32 inner V-cycle is no contraction.
    ``iterations`` counts V-cycles (``solvers.jl:116-139``); ``x`` is float64.
    Sharded hierarchies as in :func:`multigrid_mixed`."""
    with span("aggmg.solve.multigrid_progressive"):
        a_ffs = tuple(_ff_split_level(lv) for lv in h.levels)
        norm_b = _read_norm(h.levels[0], "norm_b", lambda: _norm(b, _group(h, 0)))
        x_ff, it, rel_h = _progressive_loop(
            h_low, a_ffs, ff_split(x0.to(torch.float64)), ff_split(b), np.float32(1.0 / norm_b),
            maxiter=maxiter, tol=tol, n_pre=n_pre, n_post=n_post, alpha=alpha,
        )
    return MultigridResult(
        x=ff_join(x_ff),
        iterations=it,
        res_history=torch.from_numpy(rel_h.astype(np.float64) * norm_b),
        err_history=torch.full((maxiter,), float("nan"), dtype=torch.float64),
        inner_cycles=it,
    )


# ---------------------------------------------------------------------------
# TRUE precision: value-accurate cycles for eps_f32 * kappa_elem(A) > 1
# ---------------------------------------------------------------------------
#
# Once eps_f32 * kappa_elem(A) > 1 (the c_dir = 1000 n penalty crosses that
# around 3e7 DoF; the 1e8-DoF north star sits at ~6) every float32-VALUED
# operator application in the correction cycle injects error that the cycle
# amplifies.  The remedy is value accuracy: smoothing residuals from the
# float-float operators (kernel K6 on a stencil fine level), transfers applied
# as T_hi r_hi + (T_hi r_lo + T_lo r_hi), float-float defects, and the coarse
# solve from the float64 factorization.  The block-Jacobi preconditioner
# stays float32: a perturbed S is a different but valid smoother.


def _smooth_true(level, a_ff_k, u_ff: FF, rhs_ff: FF, n_sweeps: int, alpha: float, k=None) -> FF:
    """Value-accurate smoothing: each sweep's residual is the float-float
    defect; the float32 preconditioner is applied to its hi part.  A
    Chebyshev level over block Jacobi fuses each step's apply, recurrence
    and float-float update into one K14 launch on the card
    (:func:`_chebyshev_k14`); elsewhere the plain chain runs.  ``k``: the
    level's index (:func:`_schwarz_span`)."""
    s = level.smoother
    if isinstance(s, ChebyshevSmoother):
        residual = lambda u: ff_defect(a_ff_k, u, rhs_ff).hi  # noqa: E731
        if isinstance(s.base, BlockJacobiSmoother) and u_ff.hi.is_cuda and u_ff.hi.dtype == torch.float32:
            return _chebyshev_k14(s, n_sweeps, u_ff, residual)
        return _chebyshev(s, n_sweeps, u_ff, residual, lambda u, d: ff_add(u, FF(d, torch.zeros_like(d))), k=k)
    for _ in range(n_sweeps):
        r = ff_defect(a_ff_k, u_ff, rhs_ff)
        du = alpha * _smoother_apply(s, r.hi, k=k)
        u_ff = ff_add(u_ff, FF(du, torch.zeros_like(du)))
    return u_ff


def _chebyshev_k14(s, degree: int, u: FF, residual) -> FF:
    """:func:`_chebyshev` with the float-float update ``ff_add(u, (d, 0))``,
    each step one K14 launch (``block_kernels.ff_cheb_update``: ``S^-1`` of
    ``residual(u)``, the recurrence and the update), bit for bit the plain
    chain's; the recurrence's scalars are the level's host floats
    (``s.theta``, ``s.coef``): no 0-d launch, no host read."""
    if s.coef is None or s.theta is None or degree > len(s.coef):
        raise ValueError(
            f"a float32 Chebyshev level needs its recurrence table and theta for {degree} steps: build the "
            "hierarchy with make_low_precision_hierarchy (or prepare_fast_smoothers)"
        )
    d = None
    for step in range(degree):
        u_hi, u_lo, d = block_kernels.ff_cheb_update(
            s.base.inv, residual(u), u.hi, u.lo, d, theta=s.theta, coef=s.coef[step], keep_d=step < degree - 1
        )
        u = FF(u_hi, u_lo)
    return u


def _transfer_true(apply, t32, t_lo, v: FF) -> FF:
    """A transfer at float-float value accuracy: ``T_hi v_hi + (T_hi v_lo + T_lo v_hi)``."""
    hi = apply(t32, v.hi)
    cross = apply(t32, v.lo)
    if t_lo is not None:
        cross = cross + apply(t_lo, v.hi)
    return ff_add(FF(hi, torch.zeros_like(hi)), FF(cross, torch.zeros_like(cross)))


def v_cycle_true(h_low: Hierarchy, ffops, rhs_ff: FF, k: int = 0, *, n_pre=3, n_post=3, alpha=2.0 / 3.0) -> FF:
    """One TRUE-precision V-cycle from zero on levels ``k..end`` (see the
    section comment; ``ffops`` is ``stencil_setup.FFOps``).  On a stencil
    fine level it launches K6 ``n_pre + 1 + n_post`` times."""
    a_ffs, t32, t_los = ffops.a_ffs, h_low.transfers, ffops.t_los
    steps = _Steps(
        zeros=_ff_zeros_like,
        smooth=lambda k, u, rhs, n: _smooth_true(h_low.levels[k], a_ffs[k], u, rhs, n, alpha, k),
        defect=lambda k, u, rhs: ff_defect(a_ffs[k], u, rhs),
        restrict=lambda k, r: _transfer_true(transfer_restrict, t32[k], t_los[k], r),
        prolong=lambda k, e: _transfer_true(transfer_prolong, t32[k], t_los[k], e),
        add=ff_add,
        coarse=lambda r: _true_coarse_solve(ffops.coarse64, r),
    )
    with span("aggmg.vcycle.true"):
        return _cycle(h_low, steps, None, rhs_ff, k, n_pre, n_post)


def _f64_rel_defect(a_st: BTFFStencil, x_ff: FF, b_ff: FF, inv_norm_b) -> tuple:
    """The TRUE-float64 outer defect from the stencil operator, split to
    float-float for the cycle, and its relative norm (float64).  The
    float-float defect floors around ``2^-48 || |A| |x| || / ||b||`` (~4e-7
    at the north star); float64 floors ~2^-53 of the same."""
    r_ff = f64_bt_defect_stencil(a_st, x_ff, b_ff)
    return r_ff, torch.linalg.vector_norm(ff_join(r_ff).reshape(-1)) * float(inv_norm_b)


def _progressive_true_eager(
    h_low, ffops, x_ff: FF, b_ff: FF, inv_norm_b, *, maxiter: int, tol: float,
    n_pre: int = 3, n_post: int = 3, alpha: float = 2.0 / 3.0,
):
    """TRUE-precision iteration: :func:`v_cycle_true` cycles in
    :func:`_correction_loop`, driven by the float64 outer defect (stencil
    fine operators) or the float-float one, the history and stopping test
    in float64."""
    defect = _f64_rel_defect if isinstance(ffops.a_ffs[0], BTFFStencil) else _ff_rel_defect
    return _correction_loop(
        h_low.levels[0],
        lambda x: defect(ffops.a_ffs[0], x, b_ff, inv_norm_b),
        lambda r: v_cycle_true(h_low, ffops, r, n_pre=n_pre, n_post=n_post, alpha=alpha),
        x_ff, maxiter=maxiter, tol=tol, dtype=np.float64,
    )


def multigrid_true(
    h_low: Hierarchy,
    ffops,
    b_ff: FF,
    norm_b: float,
    maxiter: int = 40,
    tol: float = 1e-8,
    *,
    x0_ff: FF | None = None,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
) -> MultigridResult:
    """TRUE-precision progressive multigrid, the north-star solver, with the
    reference's observability contract (``solvers.jl:116-139``):
    ``iterations`` counts V-cycles and ``res_history[:iterations]`` is the
    relative residual times ``norm_b`` after each, from the float64 outer
    defect (NaN beyond; the float-float defect's hi part in float32 where
    the fine operator is no stencil).  Inputs come from
    ``stencil_setup.build_xl_problem(..., ff_levels=True)``, DG-topped
    (``slim_fine=True``: a stencil fine operator through K6 on the card) or
    CG-topped (``CgBandFF`` levels, Jacobi or Schwarz smoothing of the
    defect's hi part, no lo tails on the CG and seam transfers)::

        h_low, ffops, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True,
                                                      ff_levels=True, device="cuda")
        res = multigrid_true(h_low, ffops, b_ff, norm_b)

    It runs on whole hierarchies only, as in the JAX package (whose sharded
    build has no ``t_los`` or ``coarse64``).
    """
    if h_low.layout is not None:
        raise ValueError(
            "multigrid_true takes an unsharded hierarchy (a sharded TRUE-precision solve is a feature "
            "the JAX package lacks: ROADMAP queue 1, item 15, open question)"
        )
    with span("aggmg.solve.multigrid_true"):
        if x0_ff is None:
            zero = torch.zeros_like(b_ff.hi)
            x0_ff = FF(zero, zero)
        x_ff, it, res_h = _progressive_true_eager(
            h_low, ffops, x0_ff, b_ff, np.float32(1.0 / norm_b),
            maxiter=maxiter, tol=tol, n_pre=n_pre, n_post=n_post, alpha=alpha,
        )
    return MultigridResult(
        x=ff_join(x_ff),
        iterations=it,
        res_history=torch.from_numpy(res_h * norm_b),
        err_history=torch.full((maxiter,), float("nan"), dtype=torch.float64),
        inner_cycles=it,
    )
