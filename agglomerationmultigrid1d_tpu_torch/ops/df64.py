"""Float-float ("double-f32") arithmetic: float64-accurate defects from float32 pairs.

A float64 quantity is held as an unevaluated pair of float32 tensors
``hi + lo`` with ``|lo| <= ulp(hi)/2`` (~2^-48 relative), and the defect
``r = b - A x`` is evaluated with error-free transformations (EFTs):

* ``_two_sum``  — Knuth's branch-free exact addition (6 float32 operations),
* ``_two_prod`` — Dekker's exact product through 12-bit operand splitting
  (17 float32 operations; no FMA: each operation rounds once).

Every torch elementwise operation rounds once, so these chains run as written
on either device.  The order of operations is the JAX package's
(``agglomerationmultigrid1d_tpu/ops/df64.py``), and the CUDA kernels K6
(``ops/kernels/block_kernels.py: ff_stencil_mid_defect``), K12
(``ff_bt_defect``, which :func:`ff_bt_defect` launches on the card) and K13
(``ff_cg_defect``, which :func:`ff_cg_defect` launches) are held to it bit
for bit: the sign goes on the product, never on the multiplicand; block
columns are contracted in ascending order; the diagonals in the order diag,
lower, upper (a CG band's offsets ascending); and :func:`ff_add` is the
"sloppy" add as written.

The TRUE-precision outer defect :func:`f64_bt_defect_stencil` runs in native
float64 (the card has FP64), with float-float pairs in and out.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .block_penta import BlockPenta
from .block_tridiag import BlockTridiag
from .shifts import shift

_SPLITTER = 4097.0  # 2^12 + 1 for float32's 24-bit mantissa


class FF(NamedTuple):
    """A float-float tensor: value = hi + lo (both float32)."""

    hi: torch.Tensor
    lo: torch.Tensor


class BlockTridiagFF(NamedTuple):
    """A block-tridiagonal operator with float-float entries."""

    hi: BlockTridiag  # float32
    lo: BlockTridiag  # float32


def ff_split(x: torch.Tensor) -> FF:
    """Exactly split a float64 tensor into a float32 pair
    (``hi = round(x)``, ``lo = round(x - hi)``)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return FF(hi, lo)


def ff_join(x: FF) -> torch.Tensor:
    """Recombine to float64."""
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def bt_split(a: BlockTridiag) -> BlockTridiagFF:
    parts = [ff_split(d) for d in a]
    return BlockTridiagFF(BlockTridiag(*(p.hi for p in parts)), BlockTridiag(*(p.lo for p in parts)))


class BlockPentaFF(NamedTuple):
    """A block-pentadiagonal operator (mixed-switch levels, see
    ``ops.block_penta``) with float-float entries."""

    hi: BlockPenta  # float32
    lo: BlockPenta  # float32


def bp5_split(a: BlockPenta) -> BlockPentaFF:
    parts = [ff_split(d) for d in a]
    return BlockPentaFF(BlockPenta(*(p.hi for p in parts)), BlockPenta(*(p.lo for p in parts)))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Exact ``a + b`` assuming ``|a| >= |b|``."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ff_add(x: FF, y: FF) -> FF:
    """Float-float addition (QD-style 'sloppy' add: sufficient here because the
    accumulation chains are short and renormalized every step)."""
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return FF(*_quick_two_sum(s, e))


def ff_neg(x: FF) -> FF:
    return FF(-x.hi, -x.lo)


def ff_mul(x: FF, y: FF) -> FF:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return FF(*_quick_two_sum(p, e))


def ff_from_f32(x: torch.Tensor) -> FF:
    return FF(x, torch.zeros_like(x))


def _contract_ff(m: BlockTridiagFF, sel, x: FF, acc: FF, sign: float) -> FF:
    """``acc += sign * (sel(m)[i, j, :] @ x[j, :])`` over the block rows, block
    columns ascending; the sign goes on the product."""
    mh, ml = sel(m.hi), sel(m.lo)
    for j in range(mh.shape[1]):
        t = ff_mul(FF(mh[:, j, :], ml[:, j, :]), FF(x.hi[j : j + 1, :], x.lo[j : j + 1, :]))
        if sign < 0:
            t = ff_neg(t)
        acc = ff_add(acc, t)
    return acc


def _shifted(x: FF, d: int) -> FF:
    return FF(shift(x.hi, d), shift(x.lo, d))


def ff_bt_matvec(a: BlockTridiagFF, x: FF) -> FF:
    """Block-tridiagonal matvec in float-float."""
    z = torch.zeros_like(x.hi)
    acc = FF(z, z)
    acc = _contract_ff(a, lambda t: t.diag, x, acc, +1.0)
    acc = _contract_ff(a, lambda t: t.lower, _shifted(x, -1), acc, +1.0)
    return _contract_ff(a, lambda t: t.upper, _shifted(x, +1), acc, +1.0)


def ff_bt_defect_chain(a: BlockTridiagFF, x: FF, b: FF, xm: FF, xp: FF) -> FF:
    """``r = b - A x`` in float-float as a chain of torch elementwise
    operations, ~2^-48-accurate.  ``xm`` / ``xp`` are the vectors the lower
    and upper diagonals multiply (``x_{k-1}`` / ``x_{k+1}``).  The plain
    versions of kernels K6 and K12 run it."""
    acc = _contract_ff(a, lambda t: t.diag, x, b, -1.0)
    acc = _contract_ff(a, lambda t: t.lower, xm, acc, -1.0)
    return _contract_ff(a, lambda t: t.upper, xp, acc, -1.0)


def ff_bt_defect(a: BlockTridiagFF, x: FF, b: FF, ghost_left=None, ghost_right=None) -> FF:
    """``r = b - A x`` in float-float, ~2^-48-accurate: one launch of kernel
    K12 for CUDA tensors, the plain chain (:func:`ff_bt_defect_chain`) for
    CPU tensors, equal bit for bit.  ``ghost_left`` / ``ghost_right`` (a
    shard's: ``(2, bs)``, hi then lo) are the neighbours' edge columns of x
    past its two ends; zeros by default."""
    from .kernels.block_kernels import ff_bt_defect as k12

    return FF(*k12(a, x.hi, x.lo, b.hi, b.lo, ghost_left, ghost_right))


def ff_bp5_defect(a: BlockPentaFF, x: FF, b: FF, left: FF | None = None, right: FF | None = None) -> FF:
    """Pentadiagonal ``r = b - A x`` in float-float: :func:`ff_bt_defect`'s
    three contractions, then the distance-2 ones (lower2, upper2).  ``left``
    / ``right`` are the two columns beyond x's first and last where the
    caller has them (a shard's, from its neighbours); by default zeros."""
    if left is None:
        xs = {d: _shifted(x, d) for d in (-2, -1, 1, 2)}
    else:
        n = x.hi.shape[-1]
        hi, lo = (torch.cat([s, t, e], dim=-1) for s, t, e in ((left.hi, x.hi, right.hi), (left.lo, x.lo, right.lo)))
        xs = {d: FF(hi[..., 2 + d : 2 + d + n], lo[..., 2 + d : 2 + d + n]) for d in (-2, -1, 1, 2)}
    acc = _contract_ff(a, lambda t: t.diag, x, b, -1.0)
    for d, sel in ((-1, lambda t: t.lower), (+1, lambda t: t.upper),
                   (-2, lambda t: t.lower2), (+2, lambda t: t.upper2)):
        acc = _contract_ff(a, sel, xs[d], acc, -1.0)
    return acc


def _bt_broadcast(t: BlockTridiag, n: int) -> BlockTridiag:
    return BlockTridiag(*(d.expand(*d.shape[:-1], n) for d in t))


def _bt_concat(parts: list) -> BlockTridiag:
    return BlockTridiag(*(torch.cat([p[i] for p in parts], dim=-1) for i in range(3)))


def stencil_blocks(hi_left, hi_mid, hi_right, lo_left, lo_mid, lo_right) -> torch.Tensor:
    """The stencil packed as one contiguous float32 tensor of shape
    ``(2, 3, bs, bs, 2 bw + 1)``: axis 0 hi / lo, axis 1 diag / lower / upper,
    trailing axis the ``bw`` left boundary columns, the mid column, the ``bw``
    right boundary columns.  This is what kernel K6 reads."""

    def side(l, m, r):
        return torch.stack([torch.cat([l[i], m[i], r[i]], dim=-1) for i in (1, 0, 2)])

    return torch.stack(
        [side(hi_left, hi_mid, hi_right), side(lo_left, lo_mid, lo_right)]
    ).contiguous()


@dataclasses.dataclass(frozen=True)
class BTFFStencil:
    """A float-float block-tridiagonal operator on a UNIFORM mesh, stored as
    translation-invariant stencils instead of ``(bs, bs, n)`` streams.

    Away from the first/last ``bw`` block columns every block of the operator
    is identical (see ``models.stencil_setup``), so the defect contracts with
    ONE ``(bs, bs)`` block per diagonal broadcast over the element axis: the
    operator moves no bytes; only x, b and r do.

    ``left`` / ``right`` hold the ``bw`` boundary columns, ``mid`` one interior
    column, each as an (hi, lo) pair of BlockTridiags; ``n`` is the full
    element count.  ``blocks`` packs all of them once, at construction, for
    kernel K6 (:func:`stencil_blocks`)."""

    hi_left: BlockTridiag  # (bs, bs, bw)
    hi_mid: BlockTridiag  # (bs, bs, 1)
    hi_right: BlockTridiag  # (bs, bs, bw)
    lo_left: BlockTridiag
    lo_mid: BlockTridiag
    lo_right: BlockTridiag
    n: int
    blocks: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        packed = stencil_blocks(
            self.hi_left, self.hi_mid, self.hi_right, self.lo_left, self.lo_mid, self.lo_right
        )
        object.__setattr__(self, "blocks", packed)

    @property
    def bw(self) -> int:
        return self.hi_left.diag.shape[-1]


def ff_bt_defect_stencil(a: BTFFStencil, x: FF, b: FF, col0: int | None = None,
                         ghost_left=None, ghost_right=None) -> FF:
    """``r = b - A x`` where A lives as stencils (see :class:`BTFFStencil`):
    the interior pass with the broadcast mid blocks, with the first/last
    ``bw`` columns computed from the exact boundary blocks — both in one
    launch of kernel K6 for CUDA tensors, the plain torch chain (interior pass,
    then the boundary columns spliced in) for CPU tensors.

    With ``col0``, ``x`` and ``b`` are one shard: the global columns
    ``[col0, col0 + n)`` of ``a.n``, and ``ghost_left`` / ``ghost_right``
    (``(2, bs)``, hi then lo) are the neighbours' edge columns of x, None at
    a ring end (kernel K6s)."""
    from .kernels.block_kernels import ff_stencil_mid_defect, ff_stencil_shard_defect

    x_hi, x_lo, b_hi, b_lo = (t.contiguous() for t in (x.hi, x.lo, b.hi, b.lo))
    if col0 is None:
        return FF(*ff_stencil_mid_defect(a.blocks, x_hi, x_lo, b_hi, b_lo))
    return FF(*ff_stencil_shard_defect(a.blocks, x_hi, x_lo, b_hi, b_lo, col0, a.n, ghost_left, ghost_right))


def f64_bt_defect_stencil(a: BTFFStencil, x_ff: FF, b_ff: FF) -> FF:
    """``r = b - A x`` in TRUE float64 from the stencil operator, consumed and
    produced as float-float PAIRS.

    The float-float defect is accurate to ``2^-48 || |A| |x| || / ||b||``
    relative, about 4e-7 at the 1e8-DoF north star's c_dir = 1000 n, which
    floors the iteration above a 1e-8 target.  ``hi + lo`` IS the float64
    operator, so the blocks cost nothing to join; the card runs the pass in
    native float64 (the JAX package emulates it in chunks)."""
    n = a.n
    bs = x_ff.hi.shape[0]

    def blocks64(bt_hi: BlockTridiag, bt_lo: BlockTridiag) -> BlockTridiag:
        return BlockTridiag(*(h.to(torch.float64) + l.to(torch.float64) for h, l in zip(bt_hi, bt_lo)))

    mid = blocks64(a.hi_mid, a.lo_mid)
    left = blocks64(a.hi_left, a.lo_left)
    right = blocks64(a.hi_right, a.lo_right)
    bw = left.diag.shape[-1]

    def defect_win(bt: BlockTridiag, xw, bww, m):
        # xw: (bs, m + 2) with a +-1 halo; bt diagonals broadcastable over m
        def c(mat, vec):
            acc = mat[:, 0, :] * vec[0:1, :]
            for j in range(1, bs):
                acc = acc + mat[:, j, :] * vec[j : j + 1, :]
            return acc

        return bww - c(bt.diag, xw[:, 1 : m + 1]) - c(bt.lower, xw[:, :m]) - c(bt.upper, xw[:, 2:])

    def split(r):
        hi = r.to(torch.float32)
        return hi, (r - hi.to(torch.float64)).to(torch.float32)

    zcol = torch.zeros((bs, 1), dtype=torch.float64, device=x_ff.hi.device)
    xp = torch.cat([zcol, ff_join(x_ff), zcol], dim=1)
    o_hi, o_lo = split(defect_win(mid, xp, ff_join(b_ff), n))
    del xp

    # boundary windows with the exact blocks (cf. ff_stencil_mid_defect_plain)
    w = bw + 2
    bl = _bt_concat([left, _bt_broadcast(mid, w - bw)])
    xw = torch.cat([zcol, ff_join(FF(x_ff.hi[:, : w + 1], x_ff.lo[:, : w + 1]))], dim=1)
    r_l_hi, r_l_lo = split(defect_win(bl, xw, ff_join(FF(b_ff.hi[:, :w], b_ff.lo[:, :w])), w))
    br = _bt_concat([_bt_broadcast(mid, w - bw), right])
    xw = torch.cat([ff_join(FF(x_ff.hi[:, n - w - 1 :], x_ff.lo[:, n - w - 1 :])), zcol], dim=1)
    r_r_hi, r_r_lo = split(
        defect_win(br, xw, ff_join(FF(b_ff.hi[:, n - w :], b_ff.lo[:, n - w :])), w)
    )

    def splice(full, left_v, right_v):
        full[:, :bw] = left_v[:, :bw]
        full[:, n - bw :] = right_v[:, -bw:]
        return full

    return FF(splice(o_hi, r_l_hi, r_r_hi), splice(o_lo, r_l_lo, r_r_lo))


class CgBandFF(NamedTuple):
    """An assembled CG DIA band (see ``ops.cg_operator``) with float-float entries."""

    hi: torch.Tensor  # (2p+1, n_nodes) float32
    lo: torch.Tensor  # (2p+1, n_nodes) float32


def cg_band_split(band: torch.Tensor) -> CgBandFF:
    p = ff_split(band)
    return CgBandFF(p.hi, p.lo)


def ff_cg_defect(a: CgBandFF, x: FF, b: FF, halo: tuple | None = None) -> FF:
    """``r = b - A x`` for a scalar-banded CG operator in float-float: the
    2p+1 shifted products of ``ops.cg_operator.cg_matvec``, in one launch of
    kernel K13 for CUDA tensors, the plain chain
    (``ops.kernels.block_kernels.ff_cg_defect_plain``) for CPU tensors, equal
    bit for bit.  ``halo``, on a shard: ``(left, right)``, the ``p`` nodes
    before the shard and after it as float-float pairs (the neighbours'),
    zeros by default."""
    from .kernels.block_kernels import ff_cg_defect as k13

    left, right = (None, None) if halo is None else halo
    return FF(*k13(a.hi, a.lo, x.hi, x.lo, b.hi, b.lo, left, right))


def ff_defect(a, x: FF, b: FF) -> FF:
    """Dispatch ``r = b - A x`` on the float-float operator type."""
    if isinstance(a, BlockTridiagFF):
        return ff_bt_defect(a, x, b)
    if isinstance(a, BTFFStencil):
        return ff_bt_defect_stencil(a, x, b)
    if isinstance(a, BlockPentaFF):
        return ff_bp5_defect(a, x, b)
    if isinstance(a, CgBandFF):
        return ff_cg_defect(a, x, b)
    raise TypeError(type(a))


def ff_norm(x: FF) -> torch.Tensor:
    """2-norm of a float-float vector, as a float64 0-d tensor."""
    return torch.linalg.vector_norm(ff_join(x).reshape(-1))
