"""Reference ``dg_block_tridiag``: the DG fine problem of a configuration,
worked out again from its ``discretization`` block, and a direct solve of
it, in plain PyTorch and NumPy.

It imports nothing of the measured package (nor of the JAX package beside
it) and takes nothing that the program made: the benchmark judges the
program's operator, right-hand side and answers against what this module
computes from the configuration and the seed.

The scheme is the local DG discretization of ``-u'' = f`` on a uniform mesh
of ``n`` elements (the reference solver ``mheinz757/AgglomerationMultigrid1D``,
``src/dg_mesh.jl``): nodal basis of order ``p`` on ``[-1, 1]`` with the nodes in
slot order ``(-1, +1, cos(pi i / p) for i = 1 .. p-1)``, Gauss quadrature of
``p + 1`` points, the first-order system ``q = u'``, ``-q' = f`` with ``u``
taken from the left and ``q`` from the right at every interior vertex, and a
penalty ``c_dir`` on Dirichlet ends.  The solved operator is the Schur
complement ``A = C - D M^-1 G`` (block-tridiagonal, ``(bs, bs, n)`` diagonals
with ``y[:, e] = lower[..., e] x[:, e-1] + diag[..., e] x[:, e] +
upper[..., e] x[:, e+1]``) and the right-hand side ``b = f - D M^-1 r``.

Everything is computed in column blocks, so the 10^8-DoF problem fits beside
nothing else on one card, and in the dtype asked for: float64 for the
reference, a lower precision for the control.  The interface every
reference module has is set out in ``aggmg_bench/reference.py``.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 22  # columns per block of the blocked loops


# ---------------------------------------------------------------------------
# the reference element
# ---------------------------------------------------------------------------


def element_tables(p: int) -> dict:
    """Nodal basis tables of order ``p`` (float64 NumPy): ``weights`` (q,),
    ``points`` (q,), ``phi`` (q, bs) values and ``dphi`` (q, bs) derivatives
    at the Gauss points, ``mass`` (bs, bs) and ``vol`` (bs, bs) with
    ``vol[i, j] = sum_q w_q phi_i'(x_q) phi_j(x_q)``."""
    if p < 1:
        raise ValueError("the reference covers p >= 1")
    nodes = np.concatenate([[-1.0, 1.0], np.cos(np.pi * np.arange(1, p) / p)])
    pts, w = np.polynomial.legendre.leggauss(p + 1)
    bs = p + 1
    phi = np.ones((pts.size, bs))
    dphi = np.zeros((pts.size, bs))
    for i in range(bs):
        others = [j for j in range(bs) if j != i]
        den = np.prod([nodes[i] - nodes[j] for j in others])
        for j in others:
            phi[:, i] *= pts - nodes[j]
        for k in others:  # product rule: drop one factor at a time
            term = np.ones_like(pts)
            for j in others:
                if j != k:
                    term = term * (pts - nodes[j])
            dphi[:, i] += term
        phi[:, i] /= den
        dphi[:, i] /= den
    mass = np.einsum("q,qi,qj->ij", w, phi, phi)
    vol = np.einsum("q,qi,qj->ij", w, dphi, phi)
    return dict(weights=w, points=pts, phi=phi, dphi=dphi, mass=mass, vol=vol)


class Problem:
    """The fine problem of a configuration's ``discretization`` block:
    ``p``, ``n_elements``, ``domain`` ``[x0, x1]``, ``c_dir``, the kinds
    ``left`` / ``right`` (``"dirichlet"`` or ``"neumann"``) and ``mesh``:
    ``"vertices"`` (element ``e`` spans the float64 vertices
    ``x0 + (k / n) (x1 - x0)``, ``k = e, e + 1``, each element its own width)
    or ``"width"`` (every element ``h = (x1 - x0) / n`` wide, element ``e``
    centred at ``x0 + (e + 1/2) h``).  Which of the two a deployment has
    decides the operator's last digits, and at ``c_dir = 1000 n`` those move
    the residual of a converged solve by more than its tolerance."""

    def __init__(self, disc: dict, dtype=torch.float64, device="cpu"):
        self.p = int(disc["p"])
        self.n = int(disc["n_elements"])
        self.bs = self.p + 1
        self.x0, self.x1 = (float(v) for v in disc["domain"])
        self.c_dir = float(disc["c_dir"])
        self.left, self.right = disc["left"], disc["right"]
        for kind in (self.left, self.right):
            if kind not in ("dirichlet", "neumann"):
                raise ValueError(f"unknown boundary kind {kind!r}")
        self.dtype, self.device = dtype, torch.device(device)
        self.mesh = disc["mesh"]
        if self.mesh not in ("vertices", "width"):
            raise ValueError(f"unknown mesh rule {self.mesh!r}")
        self.h = (self.x1 - self.x0) / self.n
        t = element_tables(self.p)
        f64 = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        self._w, self._pts, self._phi = f64(t["weights"]), f64(t["points"]), f64(t["phi"])
        self._vol = f64(t["vol"])
        self._minv_ref = f64(np.linalg.inv(t["mass"]))  # M^-1 = M_ref^-1 / J per element
        self.s1 = 1  # slot of the right end point

    def geometry(self, lo: int, hi: int, device="cpu") -> tuple:
        """``(jacobians, centers)`` of elements ``[lo, hi)``, float64."""
        f64 = dict(dtype=torch.float64, device=device)
        if self.mesh == "width":
            jac = torch.full((hi - lo,), 0.5 * self.h, **f64)
            return jac, self.x0 + (torch.arange(lo, hi, **f64) + 0.5) * self.h
        v = self.x0 + (torch.arange(lo, hi + 1, **f64) / self.n) * (self.x1 - self.x0)
        if lo == 0:
            v[0] = self.x0
        return 0.5 * (v[1:] - v[:-1]), 0.5 * (v[:-1] + v[1:])

    # -- operator ------------------------------------------------------------

    def _unit(self, i, j, dev) -> torch.Tensor:
        e = torch.zeros(self.bs, self.bs, dtype=torch.float64, device=dev)
        e[i, j] = 1.0
        return e

    def _element_blocks(self, lo: int, hi: int, dev) -> dict:
        """G (lower, diag), D (diag, upper), C (diag) and M^-1 of elements
        ``[lo, hi)`` as (bs, bs, m) float64 tensors on ``dev``."""
        n, m, s1 = self.n, hi - lo, self.s1
        e = torch.arange(lo, hi, device=dev)
        interior_left = (e >= 1).double()  # has a vertex on its left inside the domain
        interior_right = (e <= n - 2).double()
        vol = self._vol.to(dev)[:, :, None]
        g_lower = self._unit(0, s1, dev)[:, :, None] * interior_left
        g_diag = vol - self._unit(s1, s1, dev)[:, :, None] * interior_right
        d_diag = vol + self._unit(0, 0, dev)[:, :, None] * interior_left
        d_upper = -self._unit(s1, 0, dev)[:, :, None] * interior_right
        c_diag = torch.zeros(self.bs, self.bs, m, dtype=torch.float64, device=dev)
        if lo == 0:
            if self.left == "dirichlet":
                d_diag[0, 0, 0] += 1.0
                c_diag[0, 0, 0] += self.c_dir
            else:
                g_diag[0, 0, 0] += 1.0
        if hi == n:
            if self.right == "dirichlet":
                d_diag[s1, s1, -1] += -1.0
                c_diag[s1, s1, -1] += self.c_dir
            else:
                g_diag[s1, s1, -1] += -1.0
        jac, _ = self.geometry(lo, hi, dev)
        minv = self._minv_ref.to(dev)[:, :, None] / jac
        return dict(g_lower=g_lower, g_diag=g_diag, d_diag=d_diag, d_upper=d_upper, c_diag=c_diag, minv=minv)

    def operator_columns(self, lo: int, hi: int) -> tuple:
        """``(lower, diag, upper)`` of ``A = C - D M^-1 G`` for the block
        columns ``[lo, hi)``, each (bs, bs, hi - lo), in ``self.dtype`` on
        ``self.device`` (worked out there in float64, then cast)."""
        ext = min(hi + 1, self.n)  # element hi's G enters column hi - 1
        blk = self._element_blocks(lo, ext, self.device)
        mul = lambda a, b: torch.einsum("ijm,jkm->ikm", a, b)  # noqa: E731
        y_lower = mul(blk["minv"], blk["g_lower"])  # M^-1 G, below the diagonal
        y_diag = mul(blk["minv"], blk["g_diag"])
        m = hi - lo
        d_diag, d_upper = blk["d_diag"][..., :m], blk["d_upper"][..., :m]
        lower = -mul(d_diag, y_lower[..., :m])
        diag = blk["c_diag"][..., :m] - mul(d_diag, y_diag[..., :m])
        if ext > hi:  # the element right of the block
            nxt_lower, nxt_diag = y_lower[..., 1:], y_diag[..., 1:]
        else:  # the last column has no right neighbour
            z = torch.zeros(self.bs, self.bs, 1, dtype=torch.float64, device=self.device)
            nxt_lower = torch.cat([y_lower[..., 1:], z], dim=-1)
            nxt_diag = torch.cat([y_diag[..., 1:], z], dim=-1)
        diag = diag - mul(d_upper, nxt_lower)
        upper = -mul(d_upper, nxt_diag)
        return tuple(t.to(self.dtype) for t in (lower, diag, upper))

    # -- right-hand side -----------------------------------------------------

    def rhs_columns(self, source, g_left: float, g_right: float, lo: int, hi: int) -> torch.Tensor:
        """``b = f - D M^-1 r`` for the columns ``[lo, hi)``, (bs, hi - lo),
        in float64 on ``self.device`` and then cast: the volume load of
        ``source`` (a function of a float64 tensor of points) by Gauss
        quadrature, plus the boundary data ``g_left`` / ``g_right`` (a value
        on a Dirichlet end, the outward flux on a Neumann one)."""
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        jac, centers = self.geometry(lo, hi, dev)
        w, pts, phi = (t.to(dev) for t in (self._w, self._pts, self._phi))
        b = torch.zeros(self.bs, hi - lo, **f64)
        for q in range(pts.numel()):
            fq = source(centers + jac * pts[q]) * jac
            b += (w[q] * phi[q])[:, None] * fq[None, :]
        del centers, jac
        n, s1 = self.n, self.s1
        # boundary patches: f gets the data, r the Dirichlet value, b = f - D M^-1 r
        patch = torch.zeros(self.bs, 2, dtype=torch.float64)  # columns 0 and n - 1
        r_last = torch.zeros(self.bs, dtype=torch.float64)
        r_first = torch.zeros(self.bs, dtype=torch.float64)
        if self.left == "dirichlet":
            patch[0, 0] += self.c_dir * g_left
            r_first[0] = -g_left
        else:
            patch[0, 0] += -g_left
        if self.right == "dirichlet":
            patch[s1, 1] += self.c_dir * g_right
            r_last[s1] = g_right
        else:
            patch[s1, 1] += g_right
        cols = {0: patch[:, 0].clone(), n - 1: patch[:, 1].clone()}
        if n == 1:
            cols = {0: patch[:, 0] + patch[:, 1]}
        # - D M^-1 r: r lives on the end elements; D couples element e to e and e + 1
        for e_r, r in ((0, r_first), (n - 1, r_last)):
            if not bool(r.any()):
                continue
            blk = self._element_blocks(max(e_r - 1, 0), e_r + 1, "cpu")
            y = blk["minv"][..., -1] @ r
            d_diag = blk["d_diag"][..., -1]
            cols[e_r] = cols.get(e_r, torch.zeros(self.bs, dtype=torch.float64)) - d_diag @ y
            if e_r >= 1:
                d_upper = blk["d_upper"][..., 0]  # element e_r - 1's coupling to e_r
                cols[e_r - 1] = cols.get(e_r - 1, torch.zeros(self.bs, dtype=torch.float64)) - d_upper @ y
        for c, v in cols.items():
            if lo <= c < hi:
                b[:, c - lo] += v.to(dev)
        return b.to(self.dtype)

    # -- blocked checks ------------------------------------------------------

    def blocks(self):
        """``(lo, hi)`` column blocks covering ``[0, n)``."""
        return [(lo, min(lo + BLOCK, self.n)) for lo in range(0, self.n, BLOCK)]

    def matvec_columns(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """``(A x)[:, lo:hi]`` in float64 for a whole (bs, n) ``x`` on any
        device; the operator is worked out for those columns."""
        lower, diag, upper = (t.to(torch.float64) for t in self.operator_columns(lo, hi))
        xs = x[:, lo:hi].to(device=self.device, dtype=torch.float64)
        left = x[:, lo - 1 : hi - 1] if lo > 0 else torch.cat([x.new_zeros(self.bs, 1), x[:, : hi - 1]], dim=1)
        right = x[:, lo + 1 : hi + 1]
        if hi == self.n:
            right = torch.cat([right, x.new_zeros(self.bs, 1)], dim=1)
        left = left.to(device=self.device, dtype=torch.float64)
        right = right.to(device=self.device, dtype=torch.float64)
        y = torch.einsum("ijm,jm->im", diag, xs)
        y += torch.einsum("ijm,jm->im", lower, left)
        y += torch.einsum("ijm,jm->im", upper, right)
        return y


# ---------------------------------------------------------------------------
# direct solve: block cyclic reduction
# ---------------------------------------------------------------------------


def cyclic_reduction_solve(lower, diag, upper, b) -> torch.Tensor:
    """Solve the block-tridiagonal system (``(bs, bs, n)`` diagonals, ``b``
    (bs, n)) by block cyclic reduction in the inputs' dtype and device:
    each step eliminates the even-numbered unknowns, the recursion solves
    the odd ones, back-substitution recovers the even ones."""
    lo = lower.permute(2, 0, 1).clone()
    di = diag.permute(2, 0, 1).clone()
    up = upper.permute(2, 0, 1).clone()
    rhs = b.permute(1, 0).clone()
    lo[0].zero_()
    up[-1].zero_()
    stack = []
    while di.shape[0] > 1:
        n = di.shape[0]
        ev_inv = torch.linalg.inv(di[0::2])  # the eliminated (even) unknowns
        od = slice(1, n, 2)
        m = di[od].shape[0]
        alpha = lo[od] @ ev_inv[:m]  # couples odd i to even i - 1
        n_right = ev_inv.shape[0] - 1  # odd rows with an even neighbour on their right
        beta = up[od][:n_right] @ ev_inv[1 : 1 + n_right]
        ev_lo, ev_di, ev_up, ev_b = lo[0::2], di[0::2], up[0::2], rhs[0::2]
        new_lo = -(alpha @ ev_lo[:m])
        new_di = di[od] - alpha @ ev_up[:m]
        new_up = torch.zeros_like(new_lo)
        new_b = rhs[od] - (alpha @ ev_b[:m, :, None])[..., 0]
        new_di[:n_right] -= beta @ ev_lo[1 : 1 + n_right]
        new_up[:n_right] = -(beta @ ev_up[1 : 1 + n_right])
        new_b[:n_right] -= (beta @ ev_b[1 : 1 + n_right, :, None])[..., 0]
        stack.append((ev_inv, ev_lo, ev_up, ev_b, n))
        lo, di, up, rhs = new_lo, new_di, new_up, new_b
    x = torch.linalg.solve(di, rhs[..., None])[..., 0]
    while stack:
        ev_inv, ev_lo, ev_up, ev_b, n = stack.pop()
        x_odd = x
        x = torch.zeros(n, rhs.shape[-1], dtype=x_odd.dtype, device=x_odd.device)
        x[1::2] = x_odd
        t = ev_b.clone()
        k = ev_b.shape[0]
        # even j: its left neighbour j - 1 and right neighbour j + 1 are odd
        t[1:] -= (ev_lo[1:] @ x_odd[: k - 1, :, None])[..., 0]
        n_right = min(k, x_odd.shape[0])
        t[:n_right] -= (ev_up[:n_right] @ x_odd[:n_right, :, None])[..., 0]
        x[0::2] = (ev_inv @ t[..., None])[..., 0]
    return x.permute(1, 0).contiguous()


def direct_solve(op: tuple, b: torch.Tensor) -> torch.Tensor:
    """The control's solve: ``op`` as :meth:`Problem.operator_columns` gives
    it over all columns, in its own dtype."""
    return cyclic_reduction_solve(*op, b)
