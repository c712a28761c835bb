"""Structured prolongations (coarse -> fine), their transposes and the
Galerkin triple products.

* :class:`BlockProlong` — block-aligned transfers: DG -> DG p-coarsening
  (r = 1), DG -> agglomerated (r = 4) and agg -> agg (r = 2).  Fine block
  ``r*c + j`` receives coarse block ``c`` through ``blocks[j][:, :, c]``.
* :class:`CgProlong` — CG -> CG p-coarsening: one constant matrix ``E``
  (coarse nodal basis at fine nodes, grid order) applied per element.
* :class:`SeamProlong` — the CG -> DG/agg seam (lumped-mass L2 projection):
  ``L = diag(lump)^-1 N`` with ``N`` kept in per-base-element windows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .block_tridiag import BlockTridiag, block_mul
from .cg_operator import CgOperator, cg_element_nodes, cg_from_windows
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
    ``blocks[j, :, :, c] @ xc[:, c]``."""
    t = torch.einsum("jibn,bn->jin", l.blocks, xc)  # (r, bs_f, n_c)
    return t.permute(1, 2, 0).reshape(l.bs_fine, l.r * xc.shape[-1])


def bp_restrict(l: BlockProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf``: ``(bs_f, r * n_c) -> (bs_c, n_c)``, one strided slice per
    offset ``j``, summed in ascending ``j``."""
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
    p_f, p_c = l.p_fine, l.p_coarse
    n_el = (rf.shape[0] - 1) // p_f
    rf_win = rf[cg_element_nodes(p_f, n_el, rf.device)]
    rf_win[0, :] = 0.0
    rc_win = l.e.T @ rf_win  # (w_c, n_el)
    rc = torch.zeros((n_el * p_c + 1,), dtype=rf.dtype, device=rf.device)
    rc.index_add_(0, cg_element_nodes(p_c, n_el, rf.device).reshape(-1), rc_win.reshape(-1))
    rc[0] += rf[0]
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
    """CG node of window row ``a`` of base element ``c*r + j``: ``(w_cg, r, n_c)``."""
    dev = l.n_win.device
    a = torch.arange(l.w_cg, device=dev)[:, None, None]
    j = torch.arange(l.r, device=dev)[None, :, None]
    c = torch.arange(l.n_coarse, device=dev)[None, None, :]
    return (c * l.r + j) * (l.w_cg - 1) + a


def seam_prolong(l: SeamProlong, xc: torch.Tensor) -> torch.Tensor:
    """``(bs, n_c) -> (n_cg_nodes,)``: ``diag(lump)^-1 N xc``."""
    contrib = torch.einsum("amjc,mc->ajc", l.n_win, xc)  # (w_cg, r, n_c)
    out = torch.zeros_like(l.inv_lump)
    out.index_add_(0, _seam_indices(l).reshape(-1), contrib.reshape(-1))
    return l.inv_lump * out


def seam_restrict(l: SeamProlong, rf: torch.Tensor) -> torch.Tensor:
    """``L^T rf = N^T diag(lump)^-1 rf``: ``(n_cg_nodes,) -> (bs, n_c)``."""
    z_win = (l.inv_lump * rf)[_seam_indices(l)]  # (w_cg, r, n_c)
    return torch.einsum("amjc,ajc->mc", l.n_win, z_win)
