"""Reference ``cg_hybrid_schwarz``: the reference solver's overlapping Schwarz
smoothers of a CG level, and the CG levels of a CG-topped chain they smooth,
in plain PyTorch and NumPy and in float64.

It imports nothing of the measured package (nor of the JAX package beside
it) and takes nothing that the program made but the vectors it is asked to
smooth: ``tools/schwarz_reference_gap.py`` and the tests hold the program's
Schwarz applies to what this module computes from the configuration.

The smoother (``mheinz757/AgglomerationMultigrid1D``, ``src/smoother.jl``:
``AddSchwarzSmoother`` and ``HybridSchwarzSmoother`` ``:1-46``, built by
``cg_smoother(mesh, A, :addSchwarz | :hybridSchwarz)`` ``:88-139``) is

    y = D^-1 sum_e R_e^T A_e^-1 R_e r

over the elements ``e`` of the level, ``R_e`` the restriction to the
``p + 1`` nodes of element ``e`` (in grid order here: element ``e`` owns the
nodes ``e p .. e p + p``), ``A_e = A[nodes_e, nodes_e]`` the window of the
*assembled* operator (so a shared vertex carries both elements' entries),
and ``D`` the node multiplicity, the number of elements that hold the node
(the reference's counting matrix), for the hybrid form; the additive form
has no ``D``.  Departures from the source, each without effect on ``y``:
``A_e^-1 R_e r`` is a batched LU solve (``torch.linalg.solve``), where the
source keeps one LU factorization per element; the elements go in blocks
of :data:`BLOCK` so that a full-size level fits; ``D^-1`` divides (its
entries are 1 or 2).

The levels: the fine band is ``references/cg_band.py``'s (its
``Problem(disc)``), and each coarser CG level of order ``p_c`` below a
level of order ``p_f`` is the Galerkin product ``P^T A P``, ``P`` the
nodal interpolation of the order-``p_c`` element basis (Chebyshev-Lobatto
nodes) at the order-``p_f`` nodes, element by element (the reference's
``cg_cg_interpolation`` in ``src/interpolation.jl``).  The product is read
off ``2 p_c + 1`` probes ``P^T A P x``, ``x`` the indicator of the coarse
nodes ``j = s mod (2 p_c + 1)``: each row meets one such node in its band.
"""

from __future__ import annotations

import numpy as np
import torch

from aggmg_bench.references import cg_band

BLOCK = 1 << 18  # elements per block of the window solves


def grid_nodes(p: int) -> np.ndarray:
    """The ``p + 1`` Chebyshev-Lobatto nodes on ``[-1, 1]`` in grid
    (ascending) order: ``(-1, +1, cos(pi i / p))`` sorted."""
    return np.sort(np.concatenate([[-1.0, 1.0], np.cos(np.pi * np.arange(1, p) / p)]))


def interpolation(p_f: int, p_c: int) -> np.ndarray:
    """``E[a, c]``: the order-``p_c`` Lagrange basis function of coarse node
    ``c`` at fine node ``a`` of one element, ``(p_f + 1, p_c + 1)``, both in
    grid order."""
    xf, xc = grid_nodes(p_f), grid_nodes(p_c)
    e = np.ones((p_f + 1, p_c + 1))
    for c in range(p_c + 1):
        for m in range(p_c + 1):
            if m != c:
                e[:, c] *= (xf - xc[m]) / (xc[c] - xc[m])
    return e


def prolong(x_c: torch.Tensor, p_f: int, p_c: int) -> torch.Tensor:
    """``P x_c``: the coarse CG function at the fine nodes, element by
    element (a vertex is a node of both orders, with its value kept)."""
    n = (x_c.shape[0] - 1) // p_c
    e = torch.as_tensor(interpolation(p_f, p_c), dtype=x_c.dtype, device=x_c.device)
    el = x_c[p_c * torch.arange(n, device=x_c.device)[:, None] + torch.arange(p_c + 1, device=x_c.device)]
    x_f = torch.empty(n * p_f + 1, dtype=x_c.dtype, device=x_c.device)
    x_f[: n * p_f].view(n, p_f)[:] = el @ e[:p_f].T
    x_f[-1] = x_c[-1]
    return x_f


def restrict(y_f: torch.Tensor, p_f: int, p_c: int) -> torch.Tensor:
    """``P^T y_f``: each fine node's value sent to the coarse nodes of its
    element by the interpolation weights, a vertex's to itself alone."""
    n = (y_f.shape[0] - 1) // p_f
    e = torch.as_tensor(interpolation(p_f, p_c), dtype=y_f.dtype, device=y_f.device)
    y_c = torch.zeros(n * p_c + 1, dtype=y_f.dtype, device=y_f.device)
    y_c[p_c * torch.arange(n + 1, device=y_f.device)] = y_f[p_f * torch.arange(n + 1, device=y_f.device)]
    inner = y_f[: n * p_f].view(n, p_f)[:, 1:] @ e[1:p_f]  # (n, p_c + 1): the element's interior fine nodes
    idx = p_c * torch.arange(n, device=y_f.device)[:, None] + torch.arange(p_c + 1, device=y_f.device)
    return y_c.index_add_(0, idx.reshape(-1), inner.reshape(-1))


def band_matvec(band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x`` for the band ``(2p+1, N)``, ``band[off + p, i] = A[i, i + off]``."""
    p = band.shape[0] // 2
    n = x.shape[0]
    y = band[p] * x
    for off in range(1, p + 1):
        y[: n - off] += band[off + p, : n - off] * x[off:]
        y[off:] += band[p - off, off:] * x[: n - off]
    return y


def galerkin_band(band: torch.Tensor, p_f: int, p_c: int) -> torch.Tensor:
    """The band ``(2 p_c + 1, N_c)`` of ``P^T A P``, ``A`` the order-``p_f``
    level's band, read off ``2 p_c + 1`` probes."""
    n = (band.shape[1] - 1) // p_f
    n_c, m = n * p_c + 1, 2 * p_c + 1
    rows = torch.arange(n_c, device=band.device)
    out = torch.zeros(m, n_c, dtype=band.dtype, device=band.device)
    for s in range(m):
        x = (rows % m == s).to(band.dtype)
        y = restrict(band_matvec(band, prolong(x, p_f, p_c)), p_f, p_c)
        off = (s - rows + p_c) % m - p_c  # the probed node j = i + off in row i's band
        keep = (rows + off >= 0) & (rows + off < n_c)
        out[(off + p_c)[keep], rows[keep]] = y[keep]
    return out


def level_bands(disc: dict, orders, device="cpu") -> list:
    """The float64 bands of a CG-topped chain's CG levels, fine to coarse:
    ``cg_band.Problem(disc)``'s band of order ``orders[0] == disc["p"]``,
    then the Galerkin products down ``orders``."""
    prob = cg_band.Problem(disc, torch.float64, device)
    if int(orders[0]) != prob.p:
        raise ValueError(f"the chain's first order {orders[0]} is not the discretization's p = {prob.p}")
    (band,) = prob.operator_columns(0, prob.n_nodes)
    bands = [band]
    for p_f, p_c in zip(orders, orders[1:]):
        bands.append(galerkin_band(bands[-1], int(p_f), int(p_c)))
    return bands


def windows(band: torch.Tensor, e0: int, e1: int) -> torch.Tensor:
    """``A_e = A[nodes_e, nodes_e]`` of the elements ``[e0, e1)``, ``(e1 - e0,
    p + 1, p + 1)``: ``A[e p + a, e p + b] = band[b - a + p, e p + a]``."""
    p = band.shape[0] // 2
    a = torch.arange(p + 1, device=band.device)
    rows = p * torch.arange(e0, e1, device=band.device)[:, None, None] + a[None, :, None]
    return band[(a[None, None, :] - a[None, :, None] + p), rows]


def multiplicity(p: int, n: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """How many of the ``n`` elements hold each of the ``n p + 1`` nodes."""
    idx = p * torch.arange(n, device=device)[:, None] + torch.arange(p + 1, device=device)
    return torch.zeros(n * p + 1, dtype=dtype, device=device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=dtype, device=device))


def schwarz_apply(band: torch.Tensor, r: torch.Tensor, hybrid: bool = True, block: int = BLOCK,
                  absolute: bool = False) -> torch.Tensor:
    """``y = D^-1 sum_e R_e^T A_e^-1 R_e r`` (hybrid) or without ``D^-1``
    (additive) for the level of band ``band`` and the node vector ``r``, in
    float64 on ``band``'s device, the elements in blocks of ``block``.  With
    ``absolute``, ``D^-1 sum_e R_e^T |A_e^-1| |R_e r|`` instead: the scale
    of each entry's rounding error when ``A_e^-1`` and ``r`` are held in a
    lower precision (the entries of ``|S| |r|``)."""
    p = band.shape[0] // 2
    n = (band.shape[1] - 1) // p
    band = band.to(torch.float64)
    r = r.reshape(-1).to(device=band.device, dtype=torch.float64)
    y = torch.zeros_like(r)
    for e0 in range(0, n, block):
        e1 = min(e0 + block, n)
        idx = p * torch.arange(e0, e1, device=band.device)[:, None] + torch.arange(p + 1, device=band.device)
        if absolute:
            y_e = (torch.linalg.inv(windows(band, e0, e1)).abs() @ r[idx].abs()[..., None])[..., 0]
        else:
            y_e = torch.linalg.solve(windows(band, e0, e1), r[idx])
        y.index_add_(0, idx.reshape(-1), y_e.reshape(-1))
    return y / multiplicity(p, n, device=band.device) if hybrid else y
