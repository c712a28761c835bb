"""Transfers on a sharded fine level whose agglomerates do not line up with
the ranks: ragged groups (``RaggedBlockProlong``, a seam with ``offsets``),
scattered owners (``ScatteredProlong``), and uniform groups over a coarse
count that the world size does not divide.

Block shards stay equal (``multihost.local_range``), so the rank boundaries
of the fine and the coarse level need not meet at an agglomerate boundary.
Every such transfer reads one coarse column per fine column (a seam: per CG
element), its owner.  Prolong reads the coarse columns its fine columns
name from their owners (``columns.gather_cols``: for contiguous groups at
most one a side once a shard is a group wide), or in place from a whole
coarse level.  Restrict comes in two forms, built once by
:func:`shard_transfer`:

* a block transfer (:class:`ShardBlock`) restricts each coarse column on
  one rank, its owner (onto a whole coarse level: the rank of its group's
  first fine column), which reads the group's fine columns that lie on the
  next rank; every value is then the unsharded transfer's own arithmetic,
  and onto a whole coarse level the sum over the ranks adds only zeros;
* a misaligned uniform seam (:class:`ShardScattered` with a
  :class:`SeamRestrict`) does the same from its elements' windows of CG
  nodes, with ``seam_gather``'s arithmetic;
* a scattered transfer or a ragged seam (:class:`ShardScattered`) forms its
  partial sums at the coarse columns it reads and sends them to their
  owners, who add them (``columns.scatter_add_cols``); onto a whole coarse
  level the partial restrictions are summed over the ranks.

A seam's CG side reads and folds the vertex two ranks share as the aligned
seam does (``halo.with_right_vertex`` / ``fold_right_vertex``,
``parallel.cg_levels``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cg_operator import cg_element_nodes
from ..ops.transfer_ops import BlockProlong, RaggedBlockProlong, SeamProlong
from ..transfer.scattered_transfer import ScatteredProlong, scattered_prolong, sp_prolong, sp_restrict
from .columns import ColumnPlan, column_plan, gather_cols, scatter_add_cols
from .halo import fold_right_vertex, with_right_vertex
from .multihost import SolverGroup, local_range, node_range


class SeamRestrict(NamedTuple):
    """The restriction of a uniform seam whose agglomerates straddle the
    ranks (onto its whole coarse level): each coarse column formed on one
    rank, its group's first element's, from the windows of CG nodes of the
    group's elements, those on the next rank read, with ``seam_gather``'s
    arithmetic, so every value is the unsharded restriction's."""

    n_win: torch.Tensor  # (w_cg, bs_c, r, n_mine) the windows of the coarse columns the rank forms
    idx: torch.Tensor  # (r, n_mine) their elements' positions in fplan.need
    fplan: ColumnPlan  # the elements whose windows restrict reads
    rplan: ColumnPlan  # the coarse columns it forms, summed over the ranks


class ShardScattered(NamedTuple):
    """The rank's part of a scattered transfer or of a ragged or misaligned
    seam onto a sharded fine level: per fine column (per CG element) the
    block it reads its owner through."""

    p: ScatteredProlong  # the rank's fine columns (a seam: its elements' CG windows) from the plan's columns
    plan: ColumnPlan  # the coarse columns it reads (a whole coarse level: in place)
    inv_lump: torch.Tensor | None = None  # a seam: its own nodes' inverse lumped mass
    exact: SeamRestrict | None = None  # a uniform seam: its restriction, column by column


class ShardBlock(NamedTuple):
    """The rank's part of a block transfer (uniform or ragged groups of
    contiguous fine columns) onto a sharded fine level whose groups need not
    line up with the ranks.  Prolong reads the coarse columns of its fine columns; each
    coarse column is restricted by one rank, its owner (onto a whole coarse
    level: the rank of its group's first fine column), from the whole group,
    whose fine columns on the next rank it reads: so every value is the
    unsharded transfer's own arithmetic."""

    pblocks: torch.Tensor  # (r, bs_f, bs_c, n_need) the groups of the coarse columns prolong reads
    slot: torch.Tensor  # (n_local,) each fine column's slot in its group
    pos: torch.Tensor  # (n_local,) its group's position in cplan.need
    cplan: ColumnPlan  # the coarse columns prolong reads
    rblocks: torch.Tensor  # (r, bs_f, bs_c, n_mine) the groups the rank restricts
    idx: torch.Tensor  # (r, n_mine) their fine columns' positions in fplan.need (clamped past a group's size)
    fplan: ColumnPlan  # the fine columns restrict reads
    rplan: ColumnPlan  # the coarse columns it restricts (its own; of a whole coarse level, summed over the ranks)
    uniform: bool  # a BlockProlong: restrict sums slot by slot, as bp_restrict does


def _owners(t, lo: int, hi: int) -> torch.Tensor:
    """The coarse column of each fine column (a seam: CG element) in ``[lo, hi)``."""
    if isinstance(t, ScatteredProlong):
        return t.cols[lo:hi]
    f = torch.arange(lo, hi, device=t.n_win.device)
    if t.offsets is None:
        return f // t.r
    return torch.searchsorted(t.offsets.long(), f, right=True) - 1


def _blocks(t, lo: int, hi: int, owner: torch.Tensor) -> torch.Tensor:
    """``(bs_f, bs_c, hi - lo)``: the block each fine column in ``[lo, hi)``
    reads its owner through (a seam: each element's ``(p + 1, bs_c)`` window)."""
    if isinstance(t, ScatteredProlong):
        return t.blocks[..., lo:hi]
    f = torch.arange(lo, hi, device=owner.device)
    slot = f - (owner * t.r if t.offsets is None else t.offsets.long()[owner])
    return t.n_win[:, :, slot, owner]


def _shard_scattered(t, n_fine: int, n_coarse: int, coarse_sharded: bool, g: SolverGroup) -> ShardScattered:
    needs = [None] * g.world
    for q in range(g.world) if coarse_sharded else (g.rank,):
        needs[q] = np.unique(_owners(t, *local_range(n_fine, g._replace(rank=q))).cpu().numpy())
    plan = column_plan(needs, n_coarse, g, whole=not coarse_sharded)
    lo, hi = local_range(n_fine, g)
    owner = _owners(t, lo, hi)
    cols = np.searchsorted(needs[g.rank], owner.cpu().numpy())
    blocks = _blocks(t, lo, hi, owner).contiguous()
    inv_lump = exact = None
    if isinstance(t, SeamProlong):  # its lumped mass whole, or already the rank's nodes (the rank-local build's)
        p = t.w_cg - 1
        inv_lump = t.inv_lump
        if inv_lump.shape[-1] == n_fine * p + 1:
            inv_lump = inv_lump[slice(*node_range(n_fine, p, g))]
        inv_lump = inv_lump.to(g.device).contiguous()
    if isinstance(t, SeamProlong) and t.offsets is None:
        mine, idx, fplan, rplan = _restrict_plans(np.arange(n_coarse) * t.r, np.full(n_coarse, t.r), n_fine,
                                                  n_coarse, coarse_sharded, g)
        exact = SeamRestrict(t.n_win[..., torch.from_numpy(mine).to(t.n_win.device)].to(g.device).contiguous(),
                             _tens(idx, g.device), fplan, rplan)
    return ShardScattered(scattered_prolong(cols, blocks, plan.n_need, g.device), plan, inv_lump, exact)


def _groups(t) -> tuple:
    """``(offsets, sizes)`` of a block transfer's groups of contiguous fine
    columns, host int64: coarse-level wide, so that a rank that holds only its
    part of the fine level (``multihost.build_sharded_xl_problem``) cuts the
    transfer as ``shard_hierarchy`` does."""
    if isinstance(t, BlockProlong):
        return np.arange(t.n_coarse) * t.r, np.full(t.n_coarse, t.r)
    return tuple(a.cpu().numpy().astype(np.int64) for a in (t.offsets, t.sizes))


def _tens(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _restrict_plans(off, size, n_fine: int, n_coarse: int, coarse_sharded: bool, g: SolverGroup) -> tuple:
    """``(mine, idx, fplan, rplan)`` of a restriction that forms each coarse
    column on one rank, from the groups of contiguous fine columns at
    ``off`` of ``size`` (host int64, coarse-level wide): the coarse columns
    the rank forms (of a sharded coarse level its own; of a whole one those
    whose group starts on the rank), the positions in ``fplan.need`` of
    their groups' fine columns (``(r_max, n_mine)``, clamped past a group's
    size), the plan of the fine columns read and that of the coarse columns
    formed."""
    w, r = g.world, g.rank
    if coarse_sharded:
        mines = [np.arange(*local_range(n_coarse, g._replace(rank=q))) for q in range(w)]
    else:
        first = np.searchsorted(off, [local_range(n_fine, g._replace(rank=q))[0] for q in range(w)] + [n_fine])
        mines = [np.arange(first[q], first[q + 1]) for q in range(w)]
    fneeds = [np.arange(off[m[0]], off[m[-1]] + size[m[-1]]) if m.size else np.zeros(0, np.int64) for m in mines]
    fplan = column_plan(fneeds, n_fine, g)
    rplan = column_plan(mines, n_coarse, g, whole=not coarse_sharded)
    mine = mines[r]
    start = fneeds[r][0] if fneeds[r].size else 0
    r_max = int(size.max())
    idx = np.clip(off[mine][None, :] + np.arange(r_max)[:, None] - start, 0, max(fneeds[r].size - 1, 0))
    return mine, idx, fplan, rplan


def _shard_block(t, n_fine: int, n_coarse: int, coarse_sharded: bool, g: SolverGroup) -> ShardBlock:
    off, size = _groups(t)
    dev = g.device
    lo, hi = local_range(n_fine, g)

    def owner(f):  # the group of fine column(s) f
        return np.searchsorted(off, f, side="right") - 1

    # prolong: the (contiguous) coarse columns of each rank's fine columns
    cneeds = [np.arange(owner(lo_), owner(hi_ - 1) + 1)
              for lo_, hi_ in (local_range(n_fine, g._replace(rank=q)) for q in range(g.world))]
    cplan = column_plan(cneeds, n_coarse, g, whole=not coarse_sharded)
    need = cneeds[g.rank]
    own = owner(np.arange(lo, hi))

    def blocks(cols):
        return t.blocks[..., torch.from_numpy(cols).to(t.blocks.device)].to(dev).contiguous()

    # restrict: the coarse columns each rank forms, and their groups' fine columns
    mine, idx, fplan, rplan = _restrict_plans(off, size, n_fine, n_coarse, coarse_sharded, g)
    return ShardBlock(
        pblocks=blocks(need), slot=_tens(np.arange(lo, hi) - off[own], dev), pos=_tens(own - need[0], dev),
        cplan=cplan, rblocks=blocks(mine), idx=_tens(idx, dev), fplan=fplan, rplan=rplan,
        uniform=isinstance(t, BlockProlong),
    )


def shard_transfer(t, n_fine: int, n_coarse: int, coarse_sharded: bool, g: SolverGroup):
    """The rank's part (:class:`ShardBlock` or :class:`ShardScattered`) of the
    transfer ``t`` from a coarse level of ``n_coarse`` columns (sharded or
    whole) onto a sharded fine level of ``n_fine`` columns (CG elements under
    a seam).  ``t`` is whole, apart from a seam's lumped mass, which may be
    the rank's nodes only.  Every rank calls it with the same arguments; no
    communication."""
    if isinstance(t, (BlockProlong, RaggedBlockProlong)):
        return _shard_block(t, n_fine, n_coarse, coarse_sharded, g)
    if isinstance(t, (ScatteredProlong, SeamProlong)):
        return _shard_scattered(t, n_fine, n_coarse, coarse_sharded, g)
    raise TypeError(f"no sharded form of a {type(t).__name__}")


SHARD_TRANSFERS = (ShardBlock, ShardScattered)


def shard_prolong(t, xc: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The rank's fine columns (a seam: its own CG nodes) of ``P xc``; ``xc``
    the rank's coarse vector (its shard, or the whole level)."""
    if isinstance(t, ShardBlock):  # rbp_prolong's (and bp_prolong's) arithmetic
        contrib = torch.einsum("jibc,bc->jic", t.pblocks, gather_cols(xc, t.cplan, g))
        return contrib[t.slot, :, t.pos].T.contiguous()
    y = sp_prolong(t.p, gather_cols(xc, t.plan, g))
    if t.inv_lump is None:
        return y
    p, n_el = y.shape[0] - 1, y.shape[1]
    ext = y.new_zeros((n_el * p + 1,))
    ext.index_add_(0, cg_element_nodes(p, n_el, y.device).reshape(-1), y.reshape(-1))
    return t.inv_lump * fold_right_vertex(ext, g)


def shard_restrict(t, rf: torch.Tensor, g: SolverGroup) -> torch.Tensor:
    """The rank's coarse vector (its shard, or the whole level) of ``P^T rf``,
    ``rf`` the rank's fine columns (a seam: its own CG nodes)."""
    if isinstance(t, ShardBlock):
        rg = gather_cols(rf, t.fplan, g)[:, t.idx]  # (bs_f, r, n_mine)
        if t.uniform:  # bp_restrict's order: slot by slot
            out = None
            for j in range(t.rblocks.shape[0]):
                oj = torch.einsum("ibn,in->bn", t.rblocks[j], rg[:, j])
                out = oj if out is None else out + oj
        else:  # rbp_restrict's
            out = torch.einsum("jibc,ijc->bc", t.rblocks, rg)
        # every column is formed on one rank: a sum over the ranks adds zeros
        return scatter_add_cols(out, t.rplan, g)
    if t.inv_lump is not None:
        z = with_right_vertex(t.inv_lump * rf, g)
        rf = z[cg_element_nodes(t.p.bs_fine - 1, t.p.n_fine, z.device)]  # (p + 1, n_el): the elements' windows
    if t.exact is not None:  # seam_gather's arithmetic
        e = t.exact
        zw = gather_cols(rf, e.fplan, g)[:, e.idx]  # (w_cg, r, n_mine)
        return scatter_add_cols(torch.einsum("amjc,ajc->mc", e.n_win, zw), e.rplan, g)
    return scatter_add_cols(sp_restrict(t.p, rf), t.plan, g)
