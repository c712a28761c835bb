"""Reference ``cg_band``: the CG fine problem of a configuration, worked out
again from its ``discretization`` block, and a direct solve of it, in plain
PyTorch and NumPy.

It imports nothing of the measured package (nor of the JAX package beside
it) and takes nothing that the program made: the benchmark judges the
program's operator, right-hand side and answers against what this module
computes from the configuration and the seed.

The scheme is the continuous Galerkin discretization of ``-u'' = f`` of
order ``p`` on a uniform mesh of ``n`` elements, each ``h = (x1 - x0) / n``
wide (the reference solver ``mheinz757/AgglomerationMultigrid1D``,
``src/cg_mesh.jl``, ``src/reference_element.jl``): the nodal basis on
``[-1, 1]`` with the nodes in slot order ``(-1, +1, cos(pi i / p) for i = 1
.. p-1)``, numbered here in grid order, so element ``e`` owns the nodes ``e p
.. e p + p`` and the ``N = n p + 1`` nodes make a scalar band of ``2 p + 1``
diagonals.  Both the element stiffness ``K_ij = sum_l w_l phi_i'(xi_l)
phi_j'(xi_l) / J`` (``J = h / 2``) and the load ``sum_l J w_l phi_i(xi_l)
f(x_l)`` take the Gauss-Legendre rule of ``p + 1`` points, the source's
``gauss_quad(2p)`` (``src/gauss_quad.jl``: the rule of precision ``2p``).
Neumann data enter the end node's load (``-g`` left, ``+g`` right); a
Dirichlet end is strong: its row and column are the unit ones, its load the
value ``g``, after the lift ``b -= A_raw[:, end] g`` inside the end element.

The operator is the band ``(2p+1, N)`` with ``band[off + p, i] = A[i, i +
off]`` (zero where ``i + off`` lies outside the nodes).  Everything is
computed in node blocks, and in the dtype asked for: float64 for the
reference, a lower precision for the control.  The interface every reference
module has is set out in ``aggmg_bench/reference.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from aggmg_bench.references import dg_block_tridiag

BLOCK = 1 << 22  # nodes per block of the blocked loops
NODES = "chebyshev_lobatto"  # the one node set: (-1, +1, cos(pi i / p)), the source's


# ---------------------------------------------------------------------------
# the reference element
# ---------------------------------------------------------------------------


def element_tables(p: int) -> dict:
    """Nodal basis tables of order ``p`` (float64 NumPy) with the nodes in
    grid (ascending) order: ``weights`` (q,), ``points`` (q,), ``phi`` (q, w)
    values and ``dphi`` (q, w) derivatives at the ``q = p + 1`` Gauss
    points, and the reference stiffness ``stiff`` (w, w), ``w = p + 1``: the
    DG reference's basis (the same nodes, in slot order there), reordered."""
    t = dg_block_tridiag.element_tables(p)
    pos = np.argsort(np.concatenate([[-1.0, 1.0], np.cos(np.pi * np.arange(1, p) / p)]))
    phi, dphi = t["phi"][:, pos], t["dphi"][:, pos]
    stiff = np.einsum("q,qi,qj->ij", t["weights"], dphi, dphi)
    return dict(weights=t["weights"], points=t["points"], phi=phi, dphi=dphi, stiff=stiff)


class Problem:
    """The fine problem of a configuration's ``discretization`` block:
    ``p``, ``n_elements``, ``domain`` ``[x0, x1]``, the kinds ``left`` /
    ``right`` (``"dirichlet"`` or ``"neumann"``), ``mesh`` (``"width"``:
    every element ``h`` wide, element ``e`` centred at ``x0 + (e + 1/2) h``)
    and ``nodes`` (``"chebyshev_lobatto"``)."""

    def __init__(self, disc: dict, dtype=torch.float64, device="cpu"):
        self.p = int(disc["p"])
        self.n = int(disc["n_elements"])
        self.n_nodes = self.n * self.p + 1
        self.x0, self.x1 = (float(v) for v in disc["domain"])
        self.left, self.right = disc["left"], disc["right"]
        for kind in (self.left, self.right):
            if kind not in ("dirichlet", "neumann"):
                raise ValueError(f"unknown boundary kind {kind!r}")
        if disc["mesh"] != "width":
            raise ValueError(f"the CG reference takes a uniform mesh (\"width\"), not {disc['mesh']!r}")
        if disc["nodes"] != NODES:
            raise ValueError(f"unknown node set {disc['nodes']!r}")
        self.dtype, self.device = dtype, torch.device(device)
        self.h = (self.x1 - self.x0) / self.n
        self.jac = 0.5 * self.h
        t = element_tables(self.p)
        self._w, self._pts, self._phi = (torch.tensor(t[k], dtype=torch.float64) for k in ("weights", "points", "phi"))
        self._k = torch.tensor(t["stiff"], dtype=torch.float64) / self.jac  # every element's stiffness

    # -- operator ------------------------------------------------------------

    def _period(self) -> torch.Tensor:
        """``(2p+1, p)``: ``A[i, i + off]`` at an interior node ``i`` by its
        position ``i mod p`` in its element (0: a vertex, shared by two
        elements)."""
        p, k = self.p, self._k
        out = torch.zeros(2 * p + 1, p, dtype=torch.float64)
        for a in range(p):
            for b in range(p + 1):
                out[b - a + p, a] += k[a, b]  # the element on the node's right (its own for a > 0)
        for off in range(-p, 1):
            out[off + p, 0] += k[p, p + off]  # a vertex's element on its left
        return out

    def operator_columns(self, lo: int, hi: int) -> tuple:
        """``(band,)`` of the nodes ``[lo, hi)``, ``(2p+1, hi - lo)``, in
        ``self.dtype`` on ``self.device`` (worked out in float64, then
        cast)."""
        p, n_nodes, k = self.p, self.n_nodes, self._k
        band = self._period()[:, torch.arange(lo, hi) % p]
        first, last = 0, n_nodes - 1
        if lo <= first < hi:  # no element on its left
            band[: p + 1, first - lo] = 0.0
            band[p:, first - lo] = k[0, :]
        if lo <= last < hi:  # no element on its right
            band[p:, last - lo] = 0.0
            band[: p + 1, last - lo] = k[p, :]
        # strong Dirichlet: the unit row, and the column's other entries zero
        for on, node, sign in ((self.left == "dirichlet", first, -1), (self.right == "dirichlet", last, 1)):
            if not on:
                continue
            if lo <= node < hi:
                band[:, node - lo] = 0.0
                band[p, node - lo] = 1.0
            for off in range(1, p + 1):  # rows node - sign off, whose entry at offset sign off is the node
                row = node - sign * off
                if lo <= row < hi:
                    band[sign * off + p, row - lo] = 0.0
        return (band.to(device=self.device, dtype=self.dtype),)

    # -- right-hand side -----------------------------------------------------

    def rhs_columns(self, source, g_left: float, g_right: float, lo: int, hi: int) -> torch.Tensor:
        """The right-hand side of the nodes ``[lo, hi)``, ``(1, hi - lo)``,
        in float64 on ``self.device`` and then cast: the volume load of
        ``source`` (a function of a float64 tensor of points) scattered from
        the elements that touch the nodes, plus the boundary data ``g_left``
        / ``g_right`` (a value on a Dirichlet end, the outward flux on a
        Neumann one)."""
        p, n, n_nodes, dev = self.p, self.n, self.n_nodes, self.device
        f64 = dict(dtype=torch.float64, device=dev)
        e0, e1 = max(0, -(-lo // p) - 1), min(n, (hi - 1) // p + 1)  # the elements whose nodes meet [lo, hi)
        centers = self.x0 + (torch.arange(e0, e1, **f64) + 0.5) * self.h
        w, pts, phi = (t.to(dev) for t in (self._w, self._pts, self._phi))
        fe = torch.zeros(p + 1, e1 - e0, **f64)  # each element's load, by node position
        for q in range(pts.numel()):
            fq = source(centers + self.jac * pts[q]) * self.jac
            fe += (w[q] * phi[q])[:, None] * fq[None, :]
        del centers
        b = torch.zeros(hi - lo, **f64)
        rows = p * torch.arange(e0, e1, device=dev) - lo
        for a in range(p + 1):  # a node takes at most two loads: exact in any order
            r = rows + a
            keep = (r >= 0) & (r < hi - lo)
            b.index_add_(0, r[keep], fe[a, keep])
        del fe
        # boundary data: Neumann flux at the end node, or the Dirichlet lift and value
        k = self._k.to(dev)
        for kind, g, node, col, j0 in ((self.left, g_left, 0, k[:, 0], 0),
                                       (self.right, g_right, n_nodes - 1, k[:, p], n_nodes - 1 - p)):
            if kind == "neumann":
                if lo <= node < hi:
                    b[node - lo] += -g if node == 0 else g
                continue
            c0, c1 = max(j0, lo), min(j0 + p + 1, hi)
            if c1 > c0:
                b[c0 - lo : c1 - lo] -= col[c0 - j0 : c1 - j0] * g
            if lo <= node < hi:
                b[node - lo] = g
        return b[None].to(self.dtype)

    # -- blocked checks ------------------------------------------------------

    def blocks(self):
        """``(lo, hi)`` node blocks covering ``[0, N)``."""
        return [(lo, min(lo + BLOCK, self.n_nodes)) for lo in range(0, self.n_nodes, BLOCK)]

    def matvec_columns(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """``(A x)[lo:hi]`` as ``(1, hi - lo)`` in float64 for a whole node
        vector ``x``, ``(N,)`` or ``(1, N)``, on any device: the block and
        the ``p`` nodes on either side of it."""
        p = self.p
        (band,) = self.operator_columns(lo, hi)
        band = band.to(torch.float64)
        x = x.reshape(-1)
        a, b = max(lo - p, 0), min(hi + p, self.n_nodes)
        xs = torch.zeros(hi - lo + 2 * p, dtype=torch.float64, device=self.device)
        xs[a - (lo - p) : b - (lo - p)] = x[a:b].to(device=self.device, dtype=torch.float64)
        y = torch.zeros(hi - lo, dtype=torch.float64, device=self.device)
        for off in range(-p, p + 1):
            y += band[off + p] * xs[p + off : p + off + hi - lo]
        return y[None]


# ---------------------------------------------------------------------------
# direct solve: static condensation, then scalar cyclic reduction
# ---------------------------------------------------------------------------


def tridiagonal_solve(lower, diag, upper, b) -> torch.Tensor:
    """Solve the scalar tridiagonal system (``lower[i]`` couples ``i`` to
    ``i - 1``, ``upper[i]`` to ``i + 1``) by cyclic reduction in the inputs'
    dtype and device: each step eliminates the even-numbered unknowns, the
    recursion solves the odd ones, back-substitution recovers the even
    ones."""
    lo, di, up, rhs = (t.clone() for t in (lower, diag, upper, b))
    lo[0] = 0.0
    up[-1] = 0.0
    stack = []
    while di.shape[0] > 1:
        n = di.shape[0]
        ev_inv = 1.0 / di[0::2]
        ev_lo, ev_up, ev_b = lo[0::2], up[0::2], rhs[0::2]
        m = n // 2  # odd unknowns
        n_right = ev_inv.shape[0] - 1  # odd rows with an even neighbour on their right
        alpha = lo[1::2] * ev_inv[:m]  # couples odd i to even i - 1
        beta = up[1::2][:n_right] * ev_inv[1 : 1 + n_right]
        new_lo = -(alpha * ev_lo[:m])
        new_di = di[1::2] - alpha * ev_up[:m]
        new_up = torch.zeros_like(new_lo)
        new_b = rhs[1::2] - alpha * ev_b[:m]
        new_di[:n_right] -= beta * ev_lo[1 : 1 + n_right]
        new_up[:n_right] = -(beta * ev_up[1 : 1 + n_right])
        new_b[:n_right] -= beta * ev_b[1 : 1 + n_right]
        stack.append((ev_inv, ev_lo, ev_up, ev_b, n))
        lo, di, up, rhs = new_lo, new_di, new_up, new_b
    x = rhs / di
    while stack:
        ev_inv, ev_lo, ev_up, ev_b, n = stack.pop()
        x_odd = x
        x = torch.zeros(n, dtype=x_odd.dtype, device=x_odd.device)
        x[1::2] = x_odd
        t = ev_b.clone()
        k = ev_b.shape[0]
        t[1:] -= ev_lo[1:] * x_odd[: k - 1]  # even j's left neighbour j - 1 is odd
        n_right = min(k, x_odd.shape[0])
        t[:n_right] -= ev_up[:n_right] * x_odd[:n_right]
        x[0::2] = ev_inv * t
    return x


def direct_solve(op: tuple, b: torch.Tensor) -> torch.Tensor:
    """The control's solve, in ``op``'s dtype: ``op`` is ``(band,)`` as
    :meth:`Problem.operator_columns` gives it over all nodes, ``b`` the
    ``(1, N)`` or ``(N,)`` right-hand side; returns ``(1, N)``.  Each
    element's ``p - 1`` interior nodes are condensed out (batched), which
    leaves a tridiagonal system on the ``n + 1`` vertices (cyclic
    reduction); the interiors follow by back-substitution."""
    (band,) = op
    w = band.shape[0]
    p = w // 2
    n_nodes = band.shape[1]
    n = (n_nodes - 1) // p
    b = b.reshape(-1).to(band.dtype)
    dev = band.device
    verts = p * torch.arange(n + 1, device=dev)
    s_lo, s_di, s_up = band[0, verts].clone(), band[p, verts].clone(), band[2 * p, verts].clone()
    g = b[verts].clone()
    if p == 1:
        return tridiagonal_solve(s_lo, s_di, s_up, g)[None]
    m = p - 1
    a_idx = torch.arange(1, p, device=dev)
    rows = p * torch.arange(n, device=dev)[:, None] + a_idx[None, :]  # (n, m) interior nodes
    # A_II[e, a, c] = A[e p + a, e p + c] = band[c - a + p, e p + a]
    a_ii = band[(a_idx[None, :] - a_idx[:, None] + p)[None], rows[:, :, None]]
    # A_IV[e, a, 0 / 1] = A[e p + a, e p / (e + 1) p]; A_VI[e, 0 / 1, c] = A[e p / (e + 1) p, e p + c]
    a_iv = torch.stack([band[p - a_idx[None, :], rows], band[2 * p - a_idx[None, :], rows]], dim=2)
    a_vi = torch.stack([band[p + a_idx[None, :], verts[:-1, None]], band[a_idx[None, :], verts[1:, None]]], dim=1)
    lu, piv = torch.linalg.lu_factor(a_ii)
    b_i = b[rows]
    y = torch.linalg.lu_solve(lu, piv, torch.cat([a_iv, b_i[..., None]], dim=2))  # A_II^-1 [A_IV, b_I]
    c = a_vi @ y  # (n, 2, 3): the Schur terms and the condensed loads
    s_di[:-1] -= c[:, 0, 0]
    s_di[1:] -= c[:, 1, 1]
    s_up[:-1] -= c[:, 0, 1]
    s_lo[1:] -= c[:, 1, 0]
    g[:-1] -= c[:, 0, 2]
    g[1:] -= c[:, 1, 2]
    x_v = tridiagonal_solve(s_lo, s_di, s_up, g)
    x = torch.empty(n_nodes, dtype=band.dtype, device=dev)
    x[verts] = x_v
    ends = torch.stack([x_v[:-1], x_v[1:]], dim=1)[..., None]  # (n, 2, 1)
    x[rows] = y[..., 2] - (y[..., :2] @ ends)[..., 0]
    return x[None]
