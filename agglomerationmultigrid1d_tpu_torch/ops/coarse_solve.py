"""Coarsest-level direct solve (the reference's ``A \\ b``, ``solvers.jl:39``).

Two factorizations, both on the host in float64 at setup, both applied on
the level's device:

* :class:`CoarseSolver` — an explicit dense inverse plus one iterative-
  refinement step; for small coarsest levels and CG coarsest levels.
* :class:`BTCoarseSolver` — **block cyclic reduction** of a block-tridiagonal
  coarsest operator.  Setup is O(n bs^3) host NumPy; the solve is
  ~2 log2(n) stages of batched small products with O(n bs^2) memory, so no
  dense matrix is formed and there is no size cliff.  One refinement step
  against the stored operator restores direct-solve accuracy for the
  penalty-dominated (c_dir = 1000 n) agglomerated coarse operators.
* :class:`PaddedBTCoarseSolver` — the same for a block-pentadiagonal
  (mixed-switch) coarsest operator with an odd block count, pair-merged into
  a tridiagonal one of block size ``2 bs`` (``make_penta_coarse_solver``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_tridiag import BlockTridiag, bt_matvec


class CoarseSolver(NamedTuple):
    a_dense: torch.Tensor  # (n, n)
    a_inv: torch.Tensor  # (n, n) host-computed inverse

    @property
    def n(self) -> int:
        return self.a_dense.shape[0]


def make_coarse_solver(a_dense: torch.Tensor) -> CoarseSolver:
    """The inverse is taken with NumPy's LAPACK in f64 on the host, the same
    routine the JAX package uses, so both packages hold the same inverse."""
    inv = np.linalg.inv(a_dense.detach().cpu().numpy())
    return CoarseSolver(a_dense=a_dense, a_inv=torch.from_numpy(inv).to(a_dense.device))


def _dense_solve(f: CoarseSolver, b: torch.Tensor) -> torch.Tensor:
    """``A^-1 b`` with one iterative-refinement correction."""
    x = f.a_inv @ b
    r = b - f.a_dense @ x
    return x + f.a_inv @ r


class BTCoarseSolver(NamedTuple):
    """Block-cyclic-reduction factorization of a :class:`BlockTridiag`.

    Per reduction level (n -> ceil(n/2) even-position blocks): ``f`` / ``g``
    fold the odd neighbours into the even rows on the way down, ``dinv_odd``
    / ``l_odd`` / ``u_odd`` recover the odd unknowns on the way up.
    ``root_inv`` inverts the final single block; ``a`` is kept for one
    refinement step."""

    f: tuple  # of (bs, bs, ne) — L_even Dinv_odd(left), zero at j = 0
    g: tuple  # of (bs, bs, ne) — U_even Dinv_odd(right), zero past the end
    dinv_odd: tuple  # of (bs, bs, no)
    l_odd: tuple  # of (bs, bs, no)
    u_odd: tuple  # of (bs, bs, no)
    root_inv: torch.Tensor  # (bs, bs, 1)
    a: BlockTridiag

    @property
    def n(self) -> int:
        return self.a.n_dof


def _bmm(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(bs, bs, m) @ (bs, bs, m) batched over the trailing axis."""
    return np.einsum("ijm,jkm->ikm", x, y)


def _inv_soa(d: np.ndarray) -> np.ndarray:
    """Batched inverse of (bs, bs, m) blocks, in the SoA layout (closed form
    for bs <= 2, as the JAX package; LAPACK on the batch otherwise)."""
    bs = d.shape[0]
    if bs == 1:
        return 1.0 / d
    if bs == 2:
        a, b, c, dd = d[0, 0], d[0, 1], d[1, 0], d[1, 1]
        idet = 1.0 / (a * dd - b * c)
        out = np.empty_like(d)
        out[0, 0] = dd * idet
        out[0, 1] = -b * idet
        out[1, 0] = -c * idet
        out[1, 1] = a * idet
        return out
    return np.moveaxis(np.linalg.inv(np.moveaxis(d, -1, 0)), 0, -1)


def make_bt_coarse_solver(a: BlockTridiag) -> BTCoarseSolver:
    """Factorize a block-tridiagonal operator by cyclic reduction (host
    float64); the factors go to ``a``'s device."""
    bs = a.block_size
    dd, ll, uu = (t.detach().cpu().numpy().astype(np.float64) for t in (a.diag, a.lower, a.upper))
    # the BlockTridiag convention leaves lower[..., 0] and upper[..., -1]
    # unused; the reduction would read them as real couplings
    ll[:, :, 0] = 0.0
    uu[:, :, -1] = 0.0

    fs, gs, dinvs, lodds, uodds = [], [], [], [], []
    n = dd.shape[2]
    while n > 1:
        ne, no = (n + 1) // 2, n // 2
        d_e, l_e, u_e = dd[:, :, 0::2], ll[:, :, 0::2], uu[:, :, 0::2]
        d_o, l_o, u_o = dd[:, :, 1::2], ll[:, :, 1::2], uu[:, :, 1::2]
        dinv_o = _inv_soa(d_o)

        # F_j = L_e[j] Dinv_o[j-1] (j >= 1); G_j = U_e[j] Dinv_o[j] (j < no)
        f = np.zeros((bs, bs, ne))
        f[:, :, 1:] = _bmm(l_e[:, :, 1:], dinv_o[:, :, : ne - 1])
        g = np.zeros((bs, bs, ne))
        g[:, :, :no] = _bmm(u_e[:, :, :no], dinv_o)

        # odd-neighbour couplings shifted onto the even index space
        u_o_left = np.zeros((bs, bs, ne))
        u_o_left[:, :, 1:] = u_o[:, :, : ne - 1]
        l_o_left = np.zeros((bs, bs, ne))
        l_o_left[:, :, 1:] = l_o[:, :, : ne - 1]
        l_o_pad = np.zeros((bs, bs, ne))
        l_o_pad[:, :, :no] = l_o
        u_o_pad = np.zeros((bs, bs, ne))
        u_o_pad[:, :, :no] = u_o

        fs.append(f)
        gs.append(g)
        dinvs.append(dinv_o)
        lodds.append(l_o)
        uodds.append(u_o)

        dd = d_e - _bmm(f, u_o_left) - _bmm(g, l_o_pad)
        ll = -_bmm(f, l_o_left)
        uu = -_bmm(g, u_o_pad)
        n = ne

    dev = a.diag.device
    t = lambda arrs: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)  # noqa: E731
    return BTCoarseSolver(
        f=t(fs), g=t(gs), dinv_odd=t(dinvs), l_odd=t(lodds), u_odd=t(uodds),
        root_inv=torch.from_numpy(_inv_soa(dd)).to(dev), a=a,
    )


def _mm(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijm,jm->im", m, v)


def _bcr_apply(s: BTCoarseSolver, b: torch.Tensor) -> torch.Tensor:
    """One cyclic-reduction solve; ``b`` is (bs, n) in the level's SoA layout."""
    # downsweep: fold the odd rhs into the even rows, keep the odd rhs per level
    b_odds = []
    for f, g in zip(s.f, s.g):
        ne = f.shape[2]
        b_e, b_o = b[:, 0::2], b[:, 1::2]
        no = b_o.shape[1]
        b_o_left = torch.zeros_like(b_e)
        b_o_left[:, 1:] = b_o[:, : ne - 1]
        b_o_pad = torch.zeros_like(b_e)
        b_o_pad[:, :no] = b_o
        b_odds.append(b_o)
        b = b_e - _mm(f, b_o_left) - _mm(g, b_o_pad)

    x = _mm(s.root_inv, b)

    # upsweep: recover the odd unknowns, interleave
    for f, dinv_o, l_o, u_o, b_o in zip(
        reversed(s.f), reversed(s.dinv_odd), reversed(s.l_odd), reversed(s.u_odd), reversed(b_odds)
    ):
        ne, no = f.shape[2], b_o.shape[1]
        x_right = torch.zeros((x.shape[0], no), dtype=x.dtype, device=x.device)
        x_right[:, : ne - 1] = x[:, 1:]
        x_o = _mm(dinv_o, b_o - _mm(l_o, x[:, :no]) - _mm(u_o, x_right))
        out = torch.zeros((x.shape[0], ne + no), dtype=x.dtype, device=x.device)
        out[:, 0::2] = x
        out[:, 1::2] = x_o
        x = out
    return x


def _bt_solve(s: BTCoarseSolver, b: torch.Tensor) -> torch.Tensor:
    """Cyclic-reduction solve plus one refinement step; flat DoF vector in/out."""
    bs, n = s.a.block_size, s.a.n_blocks
    b2 = b.reshape(n, bs).T
    x = _bcr_apply(s, b2)
    r = b2 - bt_matvec(s.a, x)
    x = x + _bcr_apply(s, r)
    return x.T.reshape(-1)


class PaddedBTCoarseSolver(NamedTuple):
    """A :class:`BTCoarseSolver` of a pair-merged pentadiagonal operator whose
    block count was odd: the flat rhs gets one zero fine block appended
    before the merged solve and the solution is cropped back (the padding
    row is the identity, so the padded unknowns are exactly zero)."""

    inner: BTCoarseSolver
    n_dof: int  # real (unpadded) DoF count

    @property
    def n(self) -> int:
        return self.n_dof


def make_penta_coarse_solver(a) -> PaddedBTCoarseSolver | BTCoarseSolver:
    """Cyclic-reduction factorization of a :class:`~.block_penta.BlockPenta`
    coarsest operator through pair-merging to block size ``2 bs``."""
    from .block_penta import bp5_pair_merge

    inner = make_bt_coarse_solver(bp5_pair_merge(a))
    if a.n_blocks % 2 == 0:
        return inner
    return PaddedBTCoarseSolver(inner=inner, n_dof=a.n_dof)


def coarse_solve(f, b: torch.Tensor) -> torch.Tensor:
    """Direct solve, dispatched on the factorization type (flat vector in/out)."""
    if isinstance(f, PaddedBTCoarseSolver):
        pad = f.inner.a.n_dof - f.n_dof
        return _bt_solve(f.inner, torch.nn.functional.pad(b, (0, pad)))[: f.n_dof]
    if isinstance(f, BTCoarseSolver):
        return _bt_solve(f, b)
    return _dense_solve(f, b)
