"""Element-axis domain decomposition of DG-topped hierarchies over
``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``.  There, the
same ``models.solvers`` code runs on sharded arrays and XLA's partitioner
inserts the neighbour exchanges and reductions.  Here the solvers do it
explicitly, in the one code path that also serves the unsharded case: a
hierarchy from :func:`shard_hierarchy` carries its :class:`ShardLayout`, and
on a sharded level the solvers take the halo columns of every matvec from
the neighbours, all-reduce the norms, restrict and prolong locally, gather
after the last sharded level and solve the replicated coarsest level on
every rank.  A sharded float32 block level smooths through
:mod:`.sharded_kernels` (kernel K7 and the edge pair), with the operator
ghosts they read exchanged once and the level's edge plan built once, here
(:func:`attach_operator_ghosts`).

Typical use, one process per rank::

    g = initialize(rank, world, store_path=path)        # NCCL on the card
    prob = poisson_dg_hierarchy(n=..., device=g.device)
    h = shard_hierarchy(prob.hierarchy, g)
    h32 = make_low_precision_hierarchy(h)
    b = shard_vector(prob.b, g)
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b)
    x = unshard_vector(res.x, h)                        # the whole solution, on every rank

CG levels (the JAX package's ``_pad_cg_level`` / ``_pad_cg_smoother``) and
CG or seam transfers on sharded levels are not ported yet (ROADMAP queue 1,
item 15), nor are sharded block-pentadiagonal (mixed-switch) or block-COO
(scattered) levels, which the JAX package's partitioner shards:
:func:`shard_hierarchy` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import torch

from ..models.hierarchy import BlockLevel, CgLevel, Hierarchy, ShardLayout
from ..ops.block_tridiag import BlockTridiag
from ..ops.transfer_ops import BlockProlong
from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother
from ..utils.precision import tree_map, tree_to
from .multihost import SolverGroup, all_gather_cols, local_range
from .sharded_kernels import edge_plan, operator_ghosts


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} on a sharded level is not ported yet (ROADMAP queue 1, item 15: CG-level "
        "sharding); shard DG-topped hierarchies, or raise min_blocks_per_device so it stays whole"
    )


def _slice_cols(tree, n: int, g: SolverGroup):
    """The rank's columns of every tensor of ``tree`` whose last axis is the
    level's ``n`` elements, as tensors of their own on ``g.device``; other
    tensors (0-d bounds, stripped operators) whole."""
    lo, hi = local_range(n, g)

    def cut(t):
        if t.dim() > 0 and t.shape[-1] == n:
            t = t[..., lo:hi]
        return t.to(g.device).contiguous()

    return tree_map(cut, tree)


def shard_hierarchy(h: Hierarchy, group: SolverGroup, *, min_blocks_per_device: int = 8) -> Hierarchy:
    """Distribute a hierarchy: fine levels element-sharded, small levels whole.

    JAX's policy: a level is sharded when it gives every rank at least
    ``min_blocks_per_device`` blocks and its element count divides the world
    size; a transfer is sharded iff its coarse side is; the coarsest level
    and its factorization are replicated.  Each rank keeps only its own
    columns of the sharded levels (``[r n / W, (r + 1) n / W)``), and the
    float32 ones K7's operator ghosts (:func:`attach_operator_ghosts`).
    Raises where an agglomerate would straddle two ranks.  Collective."""
    if h.layout is not None:
        raise ValueError("the hierarchy is already sharded")
    w = group.world

    def shardable(lv):
        n = lv.a.n_el if isinstance(lv, CgLevel) else lv.a.n_blocks
        return n >= w * min_blocks_per_device and n % w == 0

    sharded = [shardable(lv) for lv in h.levels]
    sharded[-1] = False  # the coarsest level always replicates (dense direct solve)
    for k, (lv, sh) in enumerate(zip(h.levels, sharded)):
        if sh and isinstance(lv, CgLevel):
            raise _unported("a CG level")
        if sh and not isinstance(lv.a, BlockTridiag):
            # sliced by columns, its distance-2 or scattered couplings would be
            # cut and the level smoothed as if it were tridiagonal
            raise NotImplementedError(
                f"level {k} holds a {type(lv.a).__name__} operator; sharding it is not ported "
                "(ROADMAP queue 1, item 15 (d): the JAX package's partitioner shards it, the port "
                "shards block-tridiagonal levels only); raise min_blocks_per_device so it stays whole"
            )
    levels = [
        _slice_cols(lv, lv.a.n_blocks, group) if sh else tree_to(lv, group.device)
        for lv, sh in zip(h.levels, sharded)
    ]

    transfers = []
    for k, tr in enumerate(h.transfers):  # transfer k: level k + 1 (coarse) -> level k (fine)
        if not sharded[k]:
            if sharded[k + 1]:
                raise ValueError(f"level {k + 1} is sharded below the whole level {k}")
            transfers.append(tree_to(tr, group.device))
            continue
        if not isinstance(tr, BlockProlong):
            raise _unported(type(tr).__name__)
        n_f, n_c = h.levels[k].a.n_blocks, tr.n_coarse
        if n_f != tr.r * n_c or n_c % w:
            raise ValueError(
                f"level {k} ({n_f} blocks) over level {k + 1} ({n_c}): its agglomerates of "
                f"{tr.r} would straddle the {w} ranks (the coarse count must divide the world size)"
            )
        transfers.append(_slice_cols(tr, n_c, group) if sharded[k + 1] else tree_to(tr, group.device))

    return attach_operator_ghosts(Hierarchy(
        levels=tuple(levels),
        transfers=tuple(transfers),
        coarse=tree_to(h.coarse, group.device),
        layout=ShardLayout(group=group, sharded=tuple(sharded)),
    ))


def shard_vector(x: torch.Tensor, group: SolverGroup) -> torch.Tensor:
    """The rank's columns of a fine-level block vector ``(bs, n)``."""
    lo, hi = local_range(x.shape[-1], group)
    return x[..., lo:hi].to(group.device).contiguous()


def unshard_vector(x: torch.Tensor, h: Hierarchy) -> torch.Tensor:
    """The whole fine-level vector from the ranks' shards (on every rank)."""
    if h.layout is None or not h.layout.sharded[0]:
        return x
    return all_gather_cols(x, h.layout.group)


def attach_operator_ghosts(h: Hierarchy) -> Hierarchy:
    """Store K7's operator ghosts (``sharded_kernels.operator_ghosts``) and
    the edge plan (``sharded_kernels.edge_plan``: the operators checked and
    bound, the smoothing's messages allocated) on every sharded block level
    whose block-Jacobi smoother (also under a Chebyshev wrap) has its float32
    M-form streams: one exchange per level that has no ghosts yet, so
    smoothing exchanges only x and b; a plan wherever the level has none
    bound to its present tensors.  Collective: every rank calls it
    (``shard_hierarchy`` and, on a sharded hierarchy,
    ``models.hierarchy.prepare_fast_smoothers`` do)."""
    if h.layout is None:
        return h
    g = h.layout.group

    def fix_base(s, a_diag):
        if not isinstance(s, BlockJacobiSmoother) or s.ml is None or s.ml.dtype != torch.float32:
            return s
        gops = s.ghosts if s.ghosts is not None else operator_ghosts(s.ml, s.mu, s.inv, g)
        if s.plan is not None and s.plan.bound_to(s.ml, s.mu, s.inv, a_diag, gops):
            return s
        ops = tuple(t.contiguous() for t in (s.ml, s.mu, s.inv, a_diag))
        return s._replace(ghosts=gops, plan=edge_plan(*ops, gops.contiguous(), g))

    def fix(lv, sharded):
        if not sharded or not isinstance(lv, BlockLevel):
            return lv
        s = lv.smoother
        if isinstance(s, ChebyshevSmoother):
            s = s._replace(base=fix_base(s.base, lv.a.diag))
        else:
            s = fix_base(s, lv.a.diag)
        return lv._replace(smoother=s)

    return h._replace(levels=tuple(fix(lv, sh) for lv, sh in zip(h.levels, h.layout.sharded)))


def _sharded(h: Hierarchy) -> Hierarchy:
    if h.layout is None:
        raise ValueError("takes a hierarchy from shard_hierarchy")
    return h


def distributed_v_cycle(h: Hierarchy, x0, b, **kw):
    """One V-cycle on a sharded hierarchy (``models.solvers.v_cycle``)."""
    from ..models.solvers import v_cycle

    return v_cycle(_sharded(h), x0, b, **kw)


def distributed_multigrid(h: Hierarchy, x0, b, maxiter: int = 100, tol: float = 1e-10, **kw):
    """``models.solvers.multigrid`` on a sharded hierarchy."""
    from ..models.solvers import multigrid

    return multigrid(_sharded(h), x0, b, maxiter, tol, **kw)
