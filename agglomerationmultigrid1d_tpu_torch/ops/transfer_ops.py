"""Structured prolongations (coarse -> fine), their transposes and the
Galerkin triple products.

* :class:`BlockProlong` — block-aligned transfers: DG -> DG p-coarsening
  (r = 1), DG -> agglomerated (r = 4) and agg -> agg (r = 2).  Fine block
  ``r*c + j`` receives coarse block ``c`` through ``blocks[j][:, :, c]``.
* :class:`RaggedBlockProlong` — the same with variable group sizes (element
  counts that the coarsening factors do not divide).
* :class:`CgProlong` — CG -> CG p-coarsening: one constant matrix ``E``
  (coarse nodal basis at fine nodes, grid order) applied per element.
* :class:`SeamProlong` — the CG -> DG/agg seam (lumped-mass L2 projection):
  ``L = diag(lump)^-1 N`` with ``N`` kept in per-base-element windows
  (``offsets`` set for ragged agglomerates).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_tridiag import BlockTridiag, block_mul
from .cg_operator import CgOperator, cg_element_nodes, cg_from_windows
from .kernels.block_kernels import bp_prolong_gemv, bp_restrict_gemv
from .shifts import shift


class BlockProlong(NamedTuple):
    blocks: torch.Tensor  # (r, bs_f, bs_c, n_c)

    @property
    def r(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[3]


def block_prolong_constant(e: torch.Tensor, n: int) -> BlockProlong:
    """r = 1 prolongation with the same ``(bs_f, bs_c)`` matrix on every element."""
    return BlockProlong(e[None, :, :, None].expand(1, *e.shape, n))


def bp_prolong(l: BlockProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs_c, n_c) -> (bs_f, r * n_c)``: fine column ``r*c + j`` is
    ``blocks[j, :, :, c] @ xc[:, c]``; on the card one launch of
    ``bp_prolong_gemv_kernel`` (``ops.kernels.block_kernels.bp_prolong_gemv``)."""
    if xc.is_cuda:
        return bp_prolong_gemv(l.blocks, xc)
    t = torch.einsum("jibn,bn->jin", l.blocks, xc)  # (r, bs_f, n_c)
    return t.permute(1, 2, 0).reshape(l.bs_fine, l.r * xc.shape[-1])


def bp_restrict(l: BlockProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf``: ``(bs_f, r * n_c) -> (bs_c, n_c)``, one strided slice per
    offset ``j``, summed in ascending ``j``; on the card one launch of
    ``bp_restrict_gemv_kernel`` (``ops.kernels.block_kernels.bp_restrict_gemv``)."""
    if rf.is_cuda:
        return bp_restrict_gemv(l.blocks, rf)
    r = l.r
    out = None
    for j in range(r):
        oj = torch.einsum("ibn,in->bn", l.blocks[j], rf[:, j::r])
        out = oj if out is None else out + oj
    return out


def _sandwich(ba: torch.Tensor, m: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """``Ba^T M Bb`` per element: (bs_f,bs_c,n),(bs_f,bs_f,n),(bs_f,bs_c,n)->(bs_c,bs_c,n)."""
    return block_mul(ba.transpose(0, 1), block_mul(m, bb))


def bp_galerkin(l: BlockProlong, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` for block-tridiagonal fine X; the coarse result is
    block-tridiagonal because X couples only +-1 fine neighbours."""
    r, nc = l.r, l.n_coarse
    bs = x.block_size
    dg = x.diag.reshape(bs, bs, nc, r)
    lg = x.lower.reshape(bs, bs, nc, r)
    ug = x.upper.reshape(bs, bs, nc, r)
    b = l.blocks

    diag = _sandwich(b[0], dg[..., 0], b[0])
    for j in range(1, r):
        diag = diag + _sandwich(b[j], dg[..., j], b[j])
    for j in range(r - 1):
        diag = diag + _sandwich(b[j + 1], lg[..., j + 1], b[j])
        diag = diag + _sandwich(b[j], ug[..., j], b[j + 1])

    upper = _sandwich(b[r - 1], ug[..., r - 1], shift(b[0], +1))
    lower = _sandwich(b[0], lg[..., 0], shift(b[r - 1], -1))
    return BlockTridiag(lower=lower, diag=diag, upper=upper)


# ---------------------------------------------------------------------------
# RaggedBlockProlong: variable-size agglomerates
# ---------------------------------------------------------------------------


class RaggedBlockProlong(NamedTuple):
    """Block-aligned prolongation with *variable* group sizes: coarse block
    ``c`` owns the contiguous fine blocks ``offsets[c] .. offsets[c] +
    sizes[c] - 1`` through ``blocks[j, :, :, c]``; the slots ``j >=
    sizes[c]`` hold zero blocks.  ``owner`` / ``slot`` give each fine block's
    coarse block and slot, so the prolongation is a gather (one contribution
    per fine column, deterministic on any device).  Build it with
    :func:`ragged_prolong`."""

    blocks: torch.Tensor  # (r_max, bs_f, bs_c, n_c); slots j >= sizes[c] are zero
    sizes: torch.Tensor  # (n_c,) int32
    offsets: torch.Tensor  # (n_c,) int32, running sum of sizes, offsets[0] = 0
    owner: torch.Tensor  # (n_fine,) int64 coarse block of each fine block
    slot: torch.Tensor  # (n_fine,) int64 its slot j within the group
    n_fine: int

    @property
    def r_max(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[3]


def ragged_sizes_to_arrays(sizes) -> tuple:
    """``(sizes_i32, offsets_i32, n_fine)`` from any int sequence."""
    s = torch.tensor(np.asarray(sizes, dtype=np.int32))
    off = torch.cat([torch.zeros(1, dtype=torch.int32), torch.cumsum(s, 0, dtype=torch.int32)[:-1]])
    return s, off, int(s.sum())


def ragged_prolong(blocks: torch.Tensor, sizes) -> RaggedBlockProlong:
    """A :class:`RaggedBlockProlong` from its zero-padded blocks and group sizes."""
    s, off, n_fine = ragged_sizes_to_arrays(sizes)
    owner = torch.repeat_interleave(torch.arange(s.shape[0]), s.long())
    slot = torch.arange(n_fine) - off.long()[owner]
    dev = blocks.device
    return RaggedBlockProlong(
        blocks=blocks, sizes=s.to(dev), offsets=off.to(dev), owner=owner.to(dev), slot=slot.to(dev),
        n_fine=n_fine,
    )


def _rbp_fine_idx(l: RaggedBlockProlong) -> torch.Tensor:
    """``(r_max, n_c)`` fine block of slot ``(j, c)``, clamped into range (the
    padded slots carry zero blocks, so clamping is harmless)."""
    j = torch.arange(l.r_max, device=l.offsets.device)[:, None]
    return torch.clamp(l.offsets.long()[None, :] + j, max=l.n_fine - 1)


def rbp_prolong(l: RaggedBlockProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs_c, n_c) -> (bs_f, n_fine)``: fine column ``f`` is
    ``blocks[slot[f], :, :, owner[f]] @ xc[:, owner[f]]``, gathered."""
    contrib = torch.einsum("jibc,bc->jic", l.blocks, xc)  # (r_max, bs_f, n_c)
    return contrib[l.slot, :, l.owner].T.contiguous()


def rbp_restrict(l: RaggedBlockProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf``: ``(bs_f, n_fine) -> (bs_c, n_c)``."""
    rg = rf[:, _rbp_fine_idx(l)]  # (bs_f, r_max, n_c)
    return torch.einsum("jibc,ijc->bc", l.blocks, rg)


def _rbp_edge_blocks(l: RaggedBlockProlong) -> tuple:
    """``(first, last)``: the first and the last nonzero block of every group,
    each ``(bs_f, bs_c, n_c)``."""
    c = torch.arange(l.n_coarse, device=l.blocks.device)
    last = l.blocks[l.sizes.long() - 1, :, :, c]  # (n_c, bs_f, bs_c)
    return l.blocks[0], last.permute(1, 2, 0)


def rbp_galerkin(l: RaggedBlockProlong, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` with ragged groups; the coarse result stays
    block-tridiagonal because groups are contiguous and X couples only +-1
    fine neighbours."""
    idx = _rbp_fine_idx(l)  # (r_max, n_c)
    dg, lg, ug = x.diag[:, :, idx], x.lower[:, :, idx], x.upper[:, :, idx]  # (bs, bs, r_max, n_c)
    b = l.blocks

    # within a group: sum_j B_j^T D_j B_j + B_j^T L_j B_{j-1} + B_{j-1}^T U_{j-1} B_j
    diag = torch.einsum("jfbc,fgjc,jgdc->bdc", b, dg, b)
    if l.r_max > 1:
        diag = diag + torch.einsum("jfbc,fgjc,jgdc->bdc", b[1:], lg[:, :, 1:], b[:-1])
        diag = diag + torch.einsum("jfbc,fgjc,jgdc->bdc", b[:-1], ug[:, :, :-1], b[1:])

    # across groups: through the first block of group c and the last of c +- 1
    first, last = _rbp_edge_blocks(l)
    off = l.offsets.long()
    l_first = x.lower[:, :, torch.clamp(off, max=l.n_fine - 1)]
    u_last = x.upper[:, :, torch.clamp(off + l.sizes.long() - 1, max=l.n_fine - 1)]
    lower = torch.einsum("fbc,fgc,gdc->bdc", first, l_first, shift(last, -1))
    upper = torch.einsum("fbc,fgc,gdc->bdc", last, u_last, shift(first, +1))
    # einsum may hand back permuted views; the kernels take contiguous operators
    return BlockTridiag(lower=lower.contiguous(), diag=diag.contiguous(), upper=upper.contiguous())


def galerkin(l, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` for a uniform or a ragged block transfer."""
    return rbp_galerkin(l, x) if isinstance(l, RaggedBlockProlong) else bp_galerkin(l, x)


# ---------------------------------------------------------------------------
# CgProlong
# ---------------------------------------------------------------------------


class CgProlong(NamedTuple):
    e: torch.Tensor  # (w_f, w_c) coarse nodal basis at fine nodes, grid order

    @property
    def p_fine(self) -> int:
        return self.e.shape[0] - 1

    @property
    def p_coarse(self) -> int:
        return self.e.shape[1] - 1


def cgp_prolong(l: CgProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(n_c_nodes,) -> (n_f_nodes,)``: ``E`` on every coarse element window;
    node 0, then positions 1..p_f of every element left to right (shared
    vertices agree between neighbours)."""
    n_el = (xc.shape[0] - 1) // l.p_coarse
    xc_win = xc[cg_element_nodes(l.p_coarse, n_el, xc.device)]  # (w_c, n_el)
    out_win = l.e @ xc_win  # (w_f, n_el)
    return torch.cat([out_win[0, :1], out_win[1:, :].T.reshape(-1)])


def cgp_restrict(l: CgProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf``: each fine row of L lies in exactly one element window once
    row 0 is masked (the right endpoint row of window k carries vertex k+1)."""
    rc = cgp_restrict_windows(l, rf)
    rc[0] += rf[0]
    return rc


def cgp_restrict_windows(l: CgProlong, rf: torch.Tensor) -> torch.Tensor:
    """:func:`cgp_restrict` without its first fine node's term: the element
    windows' part, from and to the ``n_el p + 1`` nodes of the elements (on
    a shard, its own nodes and the vertex it shares with the next rank)."""
    p_f, p_c = l.p_fine, l.p_coarse
    n_el = (rf.shape[0] - 1) // p_f
    rf_win = rf[cg_element_nodes(p_f, n_el, rf.device)]
    rf_win[0, :] = 0.0
    rc_win = l.e.T @ rf_win  # (w_c, n_el)
    rc = torch.zeros((n_el * p_c + 1,), dtype=rf.dtype, device=rf.device)
    rc.index_add_(0, cg_element_nodes(p_c, n_el, rf.device).reshape(-1), rc_win.reshape(-1))
    return rc


def cgp_galerkin(l: CgProlong, a: CgOperator) -> CgOperator:
    """Window-level Galerkin ``L^T A L``; exact because the fine rows of L on
    element k are ``E`` on coarse window k."""
    return cg_from_windows(torch.einsum("ac,abn,bd->cdn", l.e, a.windows, l.e))


# ---------------------------------------------------------------------------
# SeamProlong (CG fine level <-> DG/agg coarse level)
# ---------------------------------------------------------------------------


class SeamProlong(NamedTuple):
    n_win: torch.Tensor  # (w_cg, bs, r, n_c): cross-mass windows, base el e = c*r + j
    inv_lump: torch.Tensor  # (n_cg_nodes,) inverse lumped CG mass
    # ragged agglomerates: base el e = offsets[c] + j, with zero windows past
    # the group's size (their clamped indices then add nothing)
    offsets: torch.Tensor | None = None  # (n_c,) int32

    @property
    def w_cg(self) -> int:
        return self.n_win.shape[0]

    @property
    def bs_coarse(self) -> int:
        return self.n_win.shape[1]

    @property
    def r(self) -> int:
        return self.n_win.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.n_win.shape[3]


def _seam_indices(l: SeamProlong) -> torch.Tensor:
    """CG node of window row ``a`` of base element ``c*r + j`` (uniform) or
    ``offsets[c] + j`` (ragged, clamped): ``(w_cg, r, n_c)``."""
    dev = l.n_win.device
    p_cg = l.w_cg - 1
    a = torch.arange(l.w_cg, device=dev)[:, None, None]
    j = torch.arange(l.r, device=dev)[None, :, None]
    if l.offsets is None:
        el = torch.arange(l.n_coarse, device=dev)[None, None, :] * l.r + j
    else:
        n_el = (l.inv_lump.shape[0] - 1) // p_cg
        el = torch.clamp(l.offsets.long()[None, None, :] + j, max=n_el - 1)
    return el * p_cg + a


def seam_prolong(l: SeamProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs, n_c) -> (n_cg_nodes,)``: ``diag(lump)^-1 N xc``."""
    return l.inv_lump * seam_scatter(l, xc, l.inv_lump.shape[0])


def seam_scatter(l: SeamProlong, xc: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``N xc`` on ``n_nodes`` CG nodes (on a shard: the nodes of its
    elements, its own and the vertex it shares with the next rank)."""
    contrib = torch.einsum("amjc,mc->ajc", l.n_win, xc)  # (w_cg, r, n_c)
    out = torch.zeros((n_nodes,), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, _seam_indices(l).reshape(-1), contrib.reshape(-1))
    return out


def seam_restrict(l: SeamProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf = N^T diag(lump)^-1 rf``: ``(n_cg_nodes,) -> (bs, n_c)``."""
    return seam_gather(l, l.inv_lump * rf)


def seam_gather(l: SeamProlong, z: torch.Tensor) -> torch.Tensor:
    """``N^T z`` from the CG nodes ``z`` of the base elements (on a shard,
    with the vertex it shares with the next rank)."""
    return torch.einsum("amjc,ajc->mc", l.n_win, z[_seam_indices(l)])
