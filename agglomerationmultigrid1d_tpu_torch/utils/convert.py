"""Hand a hierarchy built by another package to this one.

:func:`hierarchy_from_numpy` reads a hierarchy whose leaves are NumPy arrays —
for example the JAX package's ``Hierarchy`` after
``jax.tree_util.tree_map(np.asarray, h)`` — by field name alone, so this
module never imports the other package.  :func:`xl_problem_from_numpy` does
the same for the four outputs of the JAX package's ``build_xl_problem``
(DG- or CG-topped, with or without ``slim_fine`` and ``ff_levels``), and
:func:`agg_mesh_from_numpy` for an agglomerated mesh (tabled or lite).  The
tests use them to feed identical inputs to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.agg_mesh import AggMesh
from ..mesh.topology import Mesh1D
from ..models.hierarchy import BlockLevel, CgLevel, Hierarchy, _with_chebyshev_table
from ..ops.block_coo import bcoo_make
from ..ops.block_diag import BlockDiag
from ..ops.block_penta import BlockPenta
from ..ops.block_tridiag import BlockTridiag
from ..ops.cg_operator import CgOperator
from ..ops.coarse_solve import BTCoarseSolver, CoarseSolver, PaddedBTCoarseSolver
from ..ops.df64 import FF, BlockPentaFF, BlockTridiagFF, BTFFStencil, CgBandFF
from ..ops.transfer_ops import BlockProlong, CgProlong, SeamProlong, ragged_prolong
from ..transfer.scattered_transfer import scattered_prolong
from ..smoothers.smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    JacobiSmoother,
    SchwarzSmoother,
)


def hierarchy_from_numpy(h, device="cuda", dtype: torch.dtype | None = None) -> Hierarchy:
    """Duck-typed conversion.  Reads ``levels`` — block levels with ``a``,
    ``g``, ``d``, ``c`` as ``lower/diag/upper`` (``a`` pentadiagonal with
    ``lower2/upper2`` too) or block-COO ``rows/cols/blocks/n_rows/n_cols``,
    and ``mass_inv``, CG levels with ``a`` as ``windows/band`` — each with a
    ``smoother`` (block-Jacobi ``inv/ml/mu``, Jacobi ``inv_diag``, Schwarz
    ``inv_windows/mult_inv``, or a Chebyshev ``base/lam_lo/lam_hi`` over one
    of them); ``transfers`` (block
    ``blocks``, ragged block ``blocks/sizes``, CG ``e``, seam
    ``n_win/inv_lump/offsets``, scattered ``cols/blocks/n_coarse``); and
    ``coarse`` (see :func:`coarse_from_numpy`).  ``dtype`` None keeps each
    array's own precision (index arrays stay integer); a float32 Chebyshev
    level gets its recurrence table."""

    def t(x):
        return None if x is None else _tensor(x, device, dtype)

    def op(a):
        return _op(a, device, dtype)

    def smoother(s):
        if hasattr(s, "base"):
            cheb = ChebyshevSmoother(base=smoother(s.base), lam_lo=t(s.lam_lo), lam_hi=t(s.lam_hi))
            if cheb.lam_hi.dtype == torch.float32:
                cheb = _with_chebyshev_table(cheb)
            return cheb
        if hasattr(s, "inv_diag"):
            return JacobiSmoother(inv_diag=t(s.inv_diag))
        if hasattr(s, "inv_windows"):
            return SchwarzSmoother(inv_windows=t(s.inv_windows), mult_inv=t(s.mult_inv))
        return BlockJacobiSmoother(
            inv=t(s.inv), ml=t(getattr(s, "ml", None)), mu=t(getattr(s, "mu", None))
        )

    def level(lv):
        if hasattr(lv, "g"):
            return BlockLevel(
                a=op(lv.a), g=op(lv.g), d=op(lv.d), c=op(lv.c), mass_inv=t(lv.mass_inv),
                smoother=smoother(lv.smoother),
            )
        return CgLevel(a=CgOperator(windows=t(lv.a.windows), band=t(lv.a.band)),
                       smoother=smoother(lv.smoother))

    def transfer(tr):
        return _transfer(tr, device, dtype)

    return Hierarchy(
        levels=tuple(level(lv) for lv in h.levels),
        transfers=tuple(transfer(tr) for tr in h.transfers),
        coarse=coarse_from_numpy(h.coarse, device, dtype),
    )


def _transfer(tr, device, dtype=None):
    """A CG (``e``), seam (``n_win``, ``inv_lump``, ``offsets``), ragged
    block (``blocks``, ``sizes``) or block (``blocks``) transfer."""
    if hasattr(tr, "e"):
        return CgProlong(e=_tensor(tr.e, device, dtype))
    if hasattr(tr, "n_win"):
        offsets = None if tr.offsets is None else _tensor(tr.offsets, device)
        return SeamProlong(n_win=_tensor(tr.n_win, device, dtype), inv_lump=_tensor(tr.inv_lump, device, dtype),
                           offsets=offsets)
    if getattr(tr, "sizes", None) is not None:
        return ragged_prolong(_tensor(tr.blocks, device, dtype), np.asarray(tr.sizes))
    if hasattr(tr, "cols"):
        return scattered_prolong(np.asarray(tr.cols), _tensor(tr.blocks, device, dtype), int(tr.n_coarse), device)
    return BlockProlong(_tensor(tr.blocks, device, dtype))


def _tensor(x, device, dtype=None) -> torch.Tensor:
    out = torch.tensor(np.asarray(x), device=device)  # copies: the source may be read-only
    return out if dtype is None else out.to(dtype)


def _bt(op, device, dtype=None) -> BlockTridiag:
    return BlockTridiag(*(_tensor(getattr(op, k), device, dtype) for k in ("lower", "diag", "upper")))


def _op(op, device, dtype=None):
    """A block-tridiagonal, block-pentadiagonal or block-COO operator."""
    if hasattr(op, "lower2"):
        return BlockPenta(*(_tensor(getattr(op, k), device, dtype) for k in BlockPenta._fields))
    if hasattr(op, "rows"):
        return bcoo_make(np.asarray(op.rows), np.asarray(op.cols), _tensor(op.blocks, device, dtype),
                         int(op.n_rows), int(op.n_cols), device)
    return _bt(op, device, dtype)


def coarse_from_numpy(c, device="cuda", dtype: torch.dtype | None = None):
    """A dense (``a_dense``, ``a_inv``), cyclic-reduction (``f``, ``g``,
    ``dinv_odd``, ``l_odd``, ``u_odd``, ``root_inv``, ``a``) or padded
    cyclic-reduction (``inner``, ``n_dof``) coarse solver."""
    if hasattr(c, "inner"):
        return PaddedBTCoarseSolver(inner=coarse_from_numpy(c.inner, device, dtype), n_dof=int(c.n_dof))
    if hasattr(c, "root_inv"):
        ts = lambda xs: tuple(_tensor(x, device, dtype) for x in xs)  # noqa: E731
        return BTCoarseSolver(
            f=ts(c.f), g=ts(c.g), dinv_odd=ts(c.dinv_odd), l_odd=ts(c.l_odd), u_odd=ts(c.u_odd),
            root_inv=_tensor(c.root_inv, device, dtype), a=_bt(c.a, device, dtype),
        )
    return CoarseSolver(a_dense=_tensor(c.a_dense, device, dtype), a_inv=_tensor(c.a_inv, device, dtype))


def _ff_operator(a, device):
    """A float-float stencil (``hi_left ... lo_right``, ``n``), BlockTridiag
    pair (``hi``, ``lo`` with ``lower/diag/upper``), BlockPenta pair (with
    ``lower2/upper2`` too) or CG band pair (``hi``, ``lo`` arrays)."""
    if hasattr(a, "hi_mid"):
        parts = {k: _bt(getattr(a, k), device)
                 for k in ("hi_left", "hi_mid", "hi_right", "lo_left", "lo_mid", "lo_right")}
        return BTFFStencil(**parts, n=int(a.n))
    if hasattr(a.hi, "lower2"):
        return BlockPentaFF(hi=_op(a.hi, device), lo=_op(a.lo, device))
    if hasattr(a.hi, "diag"):
        return BlockTridiagFF(hi=_bt(a.hi, device), lo=_bt(a.lo, device))
    return CgBandFF(hi=_tensor(a.hi, device), lo=_tensor(a.lo, device))


def xl_problem_from_numpy(h_low, a_ff, b_ff, norm_b: float, device="cuda"):
    """The four outputs of the JAX package's ``build_xl_problem`` with NumPy
    leaves -> this package's ``(h_low, a_ff, b_ff, norm_b)``: the float32
    hierarchy (DG- or CG-topped); in the ``a_ff`` slot either one
    float-float fine operator (the inputs of ``solvers._mixed_loop_ff``) or,
    from ``ff_levels=True``, the ``FFOps`` bundle (per-level operators, the
    transfers' lo tails, None where a transfer has none, the float64 coarse
    factorization; the inputs of ``solvers.multigrid_true``); the rhs as an
    (hi, lo) pair."""
    from ..models.stencil_setup import FFOps

    if hasattr(a_ff, "a_ffs"):
        a_ff = FFOps(
            a_ffs=tuple(_ff_operator(a, device) for a in a_ff.a_ffs),
            t_los=tuple(None if t is None else _transfer(t, device) for t in a_ff.t_los),
            coarse64=coarse_from_numpy(a_ff.coarse64, device),
        )
    else:
        a_ff = _ff_operator(a_ff, device)
    b = FF(_tensor(b_ff.hi, device), _tensor(b_ff.lo, device))
    return hierarchy_from_numpy(h_low, device), a_ff, b, float(norm_b)


def agg_mesh_from_numpy(m) -> AggMesh:
    """An agglomerated mesh from another package's (``mesh.vertex_x``, the
    partition arrays, ``boxes``, ``mass`` / ``mass_inv`` as ``blocks``, the
    switch and, where built, the quadrature tables), read by field name; its
    arrays stay on the host, as this package's meshes do."""
    def host(x):
        return None if x is None else np.array(x)

    return AggMesh(
        p=int(m.p), mesh=Mesh1D(vertex_x=np.array(m.mesh.vertex_x)), sizes=host(m.sizes),
        offsets=host(m.offsets), sub_sizes=host(m.sub_sizes), sub_offsets=host(m.sub_offsets),
        n_agg=int(m.n_agg), boxes=host(m.boxes), mass=BlockDiag(_tensor(m.mass.blocks, "cpu")),
        mass_inv=BlockDiag(_tensor(m.mass_inv.blocks, "cpu")), u_hat_left=host(m.u_hat_left),
        quad_nodes=host(m.quad_nodes), quad_weights=host(m.quad_weights), basis_q=host(m.basis_q),
        x_quad=host(m.x_quad), jacs=host(m.jacs),
    )
