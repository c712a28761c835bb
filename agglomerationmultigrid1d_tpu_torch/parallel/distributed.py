"""Element-axis domain decomposition of multigrid hierarchies over
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
    prob = poisson_dg_hierarchy(n=..., device=g.device)  # or poisson_full_hierarchy
    h = shard_hierarchy(prob.hierarchy, g)
    h32 = make_low_precision_hierarchy(h)
    b = shard_vector(prob.b, g, h)
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b)
    x = unshard_vector(res.x, h)                        # the whole solution, on every rank

**CG levels.**  Every exchange is explicit here, so the layout of a CG level
is chosen to keep them few: each rank owns the nodes of its own elements,
``[r m, (r + 1) m)`` with ``m = n_el p / W``, and the last rank also the
level's last node (``multihost.node_range``; the node shards are unequal by
that one node).  The vertex shared by two ranks belongs to the right one; the
left one reads it, and adds its part of a scatter into it, through
:mod:`.cg_levels`.  p-coarsening keeps ``n_el`` on every CG level, so a CG
transfer is local up to that vertex.  The JAX package instead pads each CG
level's node axis to a device multiple with an identity band tail
(``_pad_cg_level``) and lets its partitioner move what crosses devices; the
unpadded layout here needs no pad, crop or identity tail, and
:func:`unshard_vector` returns the same ``n_el p + 1`` nodes as the JAX
package's does.

**Block-pentadiagonal (mixed-switch) levels** are sliced by columns like
block-tridiagonal ones; their matvec and float-float defect read two edge
columns a side of the neighbours, hi and lo in one exchange
(``halo.edge_columns(..., width=2)``), and their block-Jacobi smoothing is
local.  **Block-COO (scattered) levels** are cut by block rows: each rank
holds the entries of its rows, and the matvec reads the columns they name
through an exchange plan (:mod:`.columns`) that moves only those columns.

**Transfers.**  Agglomerates need not line up with the ranks: a coarse
column whose fine columns lie on two ranks (ragged groups, a coarse count
that the world does not divide) or on many (scattered owners) is read by
prolong from its owner and summed by restrict at its owner, through the
transfer's exchange plan (:mod:`.transfers`).  A whole coarse level below a
sharded one is read in place and restricted into by a sum over the ranks; a
sharded level below a whole one is gathered for prolong and takes its own
part of the whole restriction.  Every plan is built once, here, from the
whole hierarchy that every rank passes (the rank-local
``multihost.build_sharded_xl_problem`` builds the same plans from the level
counts alone).

NCCL between two cards is not verified (one card was at hand): two ranks
ran over gloo on one card, one rank over NCCL.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hierarchy import BlockLevel, CgLevel, Hierarchy, ShardLayout
from ..ops.block_coo import BlockCOO, bcoo_make
from ..ops.block_penta import BlockPenta
from ..ops.block_tridiag import BlockTridiag
from ..ops.transfer_ops import BlockProlong, CgProlong, SeamProlong
from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother
from ..utils.precision import tree_map, tree_to
from .columns import column_plan
from .multihost import SolverGroup, all_gather_cols, local_range, node_range, node_widths
from .sharded_kernels import edge_plan, operator_ghosts
from .transfers import shard_transfer


def _slice_cols(tree, n: int, g: SolverGroup, n_nodes: tuple | None = None):
    """The rank's columns of every tensor of ``tree`` whose last axis is the
    level's ``n`` elements (and, with ``n_nodes = (n_el, p)``, its nodes of
    every tensor whose last axis is the ``n_el p + 1`` CG nodes), as tensors
    of their own on ``g.device``; other tensors (0-d bounds, stripped
    operators) whole."""
    lo, hi = local_range(n, g)
    n_lo, n_hi = node_range(*n_nodes, g) if n_nodes is not None else (0, 0)

    def cut(t):
        if t.dim() > 0 and t.shape[-1] == n:
            t = t[..., lo:hi]
        elif n_nodes is not None and t.dim() > 0 and t.shape[-1] == n_nodes[0] * n_nodes[1] + 1:
            t = t[..., n_lo:n_hi]
        return t.to(g.device).contiguous()

    return tree_map(cut, tree)


def _shard_coo(a: BlockCOO, g: SolverGroup) -> BlockCOO:
    """The rank's block rows of a block-COO operator, numbered from 0, with
    the exchange plan of the columns they read (``BlockCOO.halo``; ``cols``
    number its ``need``).  Built from the whole operator, which every rank
    holds: no communication."""
    rows, cols = a.rows.cpu().numpy(), a.cols.cpu().numpy()
    lo, hi = local_range(a.n_rows, g)
    m = hi - lo
    bounds = np.searchsorted(rows, np.arange(g.world + 1) * m)  # rows are sorted
    needs = [np.unique(cols[bounds[q]:bounds[q + 1]]) for q in range(g.world)]
    plan = column_plan(needs, a.n_cols, g)
    s, e = bounds[g.rank], bounds[g.rank + 1]
    local = bcoo_make(rows[s:e] - lo, np.searchsorted(needs[g.rank], cols[s:e]), a.blocks[..., s:e],
                      m, plan.n_need, g.device)
    return local._replace(blocks=local.blocks.contiguous(), halo=plan)


def _shard_block_level(k: int, lv: BlockLevel, g: SolverGroup) -> BlockLevel:
    """The rank's columns of a block level: a block-tridiagonal or
    block-pentadiagonal level sliced by columns, a block-COO level's
    operators by block rows (:func:`_shard_coo`)."""
    n = lv.a.n_blocks
    if isinstance(lv.a, BlockPenta) and n // g.world < 2:
        raise ValueError(f"level {k}: a block-pentadiagonal shard reads two columns a side of its neighbours' "
                         f"and needs at least two of its own ({n} blocks over {g.world} ranks)")
    if not isinstance(lv.a, BlockCOO):
        return _slice_cols(lv, n, g)
    ops = {f: getattr(lv, f) for f in ("a", "g", "d", "c")}
    rest = _slice_cols(lv._replace(**dict.fromkeys(ops)), n, g)
    return rest._replace(**{f: _shard_coo(t, g) if isinstance(t, BlockCOO) else _slice_cols(t, n, g)
                            for f, t in ops.items()})


def level_size(lv) -> int:
    """A level's element (block) count: what is sharded."""
    return lv.a.n_el if isinstance(lv, CgLevel) else lv.a.n_blocks


def _shard_transfer(tr, fine, coarse, sh_f: bool, sh_c: bool, g: SolverGroup):
    """Transfer ``k`` (``coarse``, level ``k + 1``, onto ``fine``, level
    ``k``) on the ranks.  Under a whole fine level, and for a CG transfer
    (one constant matrix), the transfer is whole.  Agglomerates that line up
    with the ranks (uniform groups over a coarse count that divides the
    world) keep the aligned forms: a block transfer all its coarse columns
    unless the coarse level is sharded (``models.solvers`` slices it on
    use), a seam under a sharded CG level the rank's coarse columns and its
    nodes' lumped mass.  Every other transfer onto a sharded level becomes
    the rank's part of it (:func:`.transfers.shard_transfer`)."""
    n_c = level_size(coarse)
    if not sh_f or isinstance(tr, CgProlong):
        return tree_to(tr, g.device)
    aligned = n_c % g.world == 0
    if isinstance(tr, BlockProlong) and aligned:
        return _slice_cols(tr, n_c, g) if sh_c else tree_to(tr, g.device)
    if isinstance(tr, SeamProlong) and tr.offsets is None and aligned:
        return _slice_cols(tr, n_c, g, n_nodes=(fine.a.n_el, fine.a.p))
    return shard_transfer(tr, level_size(fine), n_c, sh_c, g)


def shard_hierarchy(h: Hierarchy, group: SolverGroup, *, min_blocks_per_device: int = 8) -> Hierarchy:
    """Distribute a hierarchy: fine levels element-sharded, small levels whole.

    JAX's policy: a level is sharded when it gives every rank at least
    ``min_blocks_per_device`` elements and its element count divides the
    world size (its ``_shard_last`` keeps the others whole); the coarsest
    level and its factorization are replicated.  A level may be sharded
    below a whole one, and agglomerates may straddle two ranks (see the
    module docstring).  Each rank keeps only its own columns of the sharded
    levels (``[r n / W, (r + 1) n / W)``; on a CG level its nodes; on a
    block-COO level its block rows), the transfers cut to match, and the
    float32 block-tridiagonal levels K7's operator ghosts
    (:func:`attach_operator_ghosts`).  The exchange plans are built here,
    from the whole hierarchy, which every rank passes.  Collective."""
    if h.layout is not None:
        raise ValueError("the hierarchy is already sharded")
    w = group.world

    def shardable(lv):
        n = level_size(lv)
        return n >= w * min_blocks_per_device and n % w == 0

    sharded = [shardable(lv) for lv in h.levels]
    sharded[-1] = False  # the coarsest level always replicates (dense direct solve)
    levels = []
    for k, (lv, sh) in enumerate(zip(h.levels, sharded)):
        if not sh:
            levels.append(tree_to(lv, group.device))
        elif isinstance(lv, CgLevel):
            levels.append(_slice_cols(lv, lv.a.n_el, group, n_nodes=(lv.a.n_el, lv.a.p)))
        else:
            levels.append(_shard_block_level(k, lv, group))
    transfers = [
        _shard_transfer(tr, h.levels[k], h.levels[k + 1], sharded[k], sharded[k + 1], group)
        for k, tr in enumerate(h.transfers)
    ]
    return attach_operator_ghosts(Hierarchy(
        levels=tuple(levels),
        transfers=tuple(transfers),
        coarse=tree_to(h.coarse, group.device),
        layout=ShardLayout(group=group, sharded=tuple(sharded)),
    ))


def level_widths(lv, g: SolverGroup) -> list | None:
    """Every rank's width of a sharded level's vectors where they differ (a
    CG level's node shards, ``multihost.node_widths``); None on a block
    level, whose shards are equal.  ``lv`` is the rank's shard."""
    if not isinstance(lv, CgLevel):
        return None
    return node_widths(lv.a.n_el * g.world, lv.a.p, g)


def shard_vector(x: torch.Tensor, group: SolverGroup, h: Hierarchy | None = None) -> torch.Tensor:
    """The rank's part of a fine-level vector: its columns of a block vector
    ``(bs, n)``; of a CG node vector ``(n_el p + 1,)`` its nodes, which needs
    the hierarchy ``h`` (whole or sharded: its fine level's order).  With a
    sharded ``h`` whose fine level is whole, all of ``x``."""
    if h is not None and h.layout is not None and not h.layout.sharded[0]:
        return x.to(group.device).contiguous()
    if x.dim() == 1:
        if h is None or not isinstance(h.levels[0], CgLevel):
            raise ValueError("a CG node vector is sharded by its level's nodes: pass the hierarchy h")
        p = h.levels[0].a.p
        lo, hi = node_range((x.shape[0] - 1) // p, p, group)
    else:
        lo, hi = local_range(x.shape[-1], group)
    return x[..., lo:hi].to(group.device).contiguous()


def unshard_vector(x: torch.Tensor, h: Hierarchy) -> torch.Tensor:
    """The whole fine-level vector from the ranks' shards (on every rank):
    ``(bs, n)`` on a block level, the ``n_el p + 1`` nodes on a CG level."""
    if h.layout is None or not h.layout.sharded[0]:
        return x
    g = h.layout.group
    return all_gather_cols(x, g, level_widths(h.levels[0], g))


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
        if not sharded or not isinstance(lv, BlockLevel) or not isinstance(lv.a, BlockTridiag):
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
