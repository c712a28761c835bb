"""Reference ``scattered_dg``: the DG fine problem of a configuration with
scattered (non-contiguous) agglomerates below it, worked out again from
the configuration, in plain PyTorch and NumPy.

It imports nothing of the measured package (nor of the JAX package beside
it) and takes nothing that the program made.  The fine problem is the
DG one of ``dg_block_tridiag`` (its operator columns, right-hand side,
matvec and direct solve serve here unchanged): the benchmark judges the
program's fine operator, right-hand side and answers against it.

The agglomerated levels are worked out from the reference solver's
definitions (``mheinz757/AgglomerationMultigrid1D``,
``src/agglomerated_dg_mesh.jl:400-635`` for agglomerates given as
element-id lists, ``src/mesh_heirarchy.jl:140-181`` for the DG-topped
chain), for the tests and for a comparison on the card:

- the partition (:func:`owner_maps`) from the configuration's
  ``partition`` block;
- an agglomerate's bounding box over its member elements and its modal
  basis ``{1, 2 (x - xc) / h}`` on that box;
- the prolongation: the agglomerate's basis at the fine DG nodes below the
  DG level, the exact re-expansion of a coarse basis in the fine
  agglomerate's basis below an agglomerated level;
- each agglomerate's mass, integrated element by element over its members;
- the Galerkin products ``P^T G P``, ``P^T D P``, ``P^T C P`` of the level
  above, and ``A = C - D M^-1 G`` with the level's own mass.

Operators are scalar ``torch`` sparse COO tensors numbered block-index
major (dof ``k bs + i``), products are ``torch.sparse.mm``: a general
sparse algebra, independent of the program's block-COO re-keying.
"""

from __future__ import annotations

import numpy as np
import torch

from aggmg_bench import reference

DG = reference.load("dg_block_tridiag")
torch.backends.cuda.matmul.allow_tf32 = False  # the control's float32 products stay float32
torch.backends.cudnn.allow_tf32 = False

Problem = DG.Problem
direct_solve = DG.direct_solve
BS = 2  # the agglomerated levels' modal order is 1: two basis functions


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------


def owner_maps(partition: dict, n: int) -> list:
    """The owner map of every agglomerated level, fine to coarse, as int64
    NumPy arrays: ``maps[0][e]`` is the level-1 agglomerate of base element
    ``e``; ``maps[k][c]`` the level-``k + 1`` agglomerate of level-``k``
    agglomerate ``c``.  ``"interleaved_pairs"``: the base elements of each
    run of four pair as ``{4b, 4b + 2}`` (agglomerate ``2b``) and ``{4b + 1,
    4b + 3}`` (``2b + 1``); then each level merges agglomerates ``{2c, 2c +
    1}``, down to ``coarsest`` agglomerates."""
    if partition["kind"] != "interleaved_pairs":
        raise ValueError(f"unknown partition {partition['kind']!r}")
    coarsest = int(partition["coarsest"])
    if n % 4 or coarsest < 1:
        raise ValueError("interleaved pairs need 4 | n and coarsest >= 1")
    e = np.arange(n, dtype=np.int64)
    maps, m = [2 * (e // 4) + e % 2], n // 2
    while m > coarsest:
        if m % 2:
            raise ValueError(f"{m} agglomerates do not merge in pairs")
        maps.append(np.arange(m, dtype=np.int64) // 2)
        m //= 2
    return maps


def members(owner: np.ndarray) -> np.ndarray:
    """``(m, K)`` the ids each agglomerate of ``owner`` holds, ascending
    (every agglomerate the same count)."""
    m = int(owner.max()) + 1
    order = np.argsort(owner, kind="stable")
    return order.reshape(m, -1)


# ---------------------------------------------------------------------------
# sparse helpers
# ---------------------------------------------------------------------------


def block_sparse(rows, cols, blocks: torch.Tensor, n_rows: int, n_cols: int) -> torch.Tensor:
    """The scalar sparse COO matrix of block triples: block ``t`` (``blocks[...,
    t]``, (bs_r, bs_c)) at block row ``rows[t]``, block column ``cols[t]``;
    duplicates summed.  Shape ``(n_rows bs_r, n_cols bs_c)``."""
    bs_r, bs_c, nnz = blocks.shape
    dev = blocks.device
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    i = torch.arange(bs_r, device=dev)[:, None, None]
    j = torch.arange(bs_c, device=dev)[None, :, None]
    r = (rows[None, None, :] * bs_r + i).expand(bs_r, bs_c, nnz)
    c = (cols[None, None, :] * bs_c + j).expand(bs_r, bs_c, nnz)
    idx = torch.stack([r.reshape(-1), c.reshape(-1)])
    return torch.sparse_coo_tensor(idx, blocks.reshape(-1), (n_rows * bs_r, n_cols * bs_c),
                                   check_invariants=False).coalesce()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sparse.mm(a, b).coalesce()


def column_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``max|got - want|`` of a column over ``max|want|`` of that
    column (a zero column judged against 1), for two sparse or dense
    matrices of one shape: ``reference.max_column_gap`` without a dense
    copy."""
    got, want = got.to_sparse().coalesce(), want.to(got.device).to_sparse().coalesce()
    n = got.shape[1]

    def col_max(s):
        out = torch.zeros(n, dtype=torch.float64, device=s.device)
        return out.scatter_reduce_(0, s.indices()[1], s.values().abs().to(torch.float64), "amax")

    diff, scale = col_max((got - want).coalesce()), col_max(want)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return float((diff / scale).max())


# ---------------------------------------------------------------------------
# the levels
# ---------------------------------------------------------------------------


def _vertices(prob) -> torch.Tensor:
    """The fine mesh's ``n + 1`` vertices, float64, as ``Problem.geometry``
    places them."""
    f64 = dict(dtype=torch.float64, device=prob.device)
    if prob.mesh == "width":
        return prob.x0 + torch.arange(prob.n + 1, **f64) * prob.h
    v = prob.x0 + (torch.arange(prob.n + 1, **f64) / prob.n) * (prob.x1 - prob.x0)
    v[0] = prob.x0
    return v


def _basis(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``(..., 2)``: the modal basis ``1, 2 (x - xc) / h`` of the box ``[lo,
    hi]`` at ``x`` (all broadcast)."""
    phi1 = 2.0 * (x - 0.5 * (lo + hi)) / (hi - lo)
    return torch.stack([torch.ones_like(phi1), phi1], dim=-1)


def fine_operators(prob) -> dict:
    """The DG fine level's ``g``, ``d``, ``c`` (scalar sparse) from
    ``dg_block_tridiag``'s element blocks: ``G`` on the diagonal and the
    left neighbour, ``D`` on the diagonal and the right neighbour, ``C`` on
    the diagonal."""
    n, dev = prob.n, prob.device
    blk = prob._element_blocks(0, n, dev)
    e = torch.arange(n, device=dev)

    def bt(diag, off, side):
        if side < 0:
            rows, cols, offb = e[1:], e[1:] - 1, off[..., 1:]
        else:
            rows, cols, offb = e[:-1], e[:-1] + 1, off[..., :-1]
        return block_sparse(torch.cat([e, rows]), torch.cat([e, cols]), torch.cat([diag, offb], dim=-1), n, n)

    return dict(g=bt(blk["g_diag"], blk["g_lower"], -1), d=bt(blk["d_diag"], blk["d_upper"], +1),
                c=block_sparse(e, e, blk["c_diag"], n, n))


def scattered_levels(prob, partition: dict) -> list:
    """The agglomerated levels below ``prob``'s DG level (a
    ``dg_block_tridiag.Problem``), fine to coarse: per level a dict of its
    block count ``m``, the base elements' ``owner``, the ``boxes`` (m, 2),
    the ``mass`` (m, 2, 2), the prolongation ``p`` from it to the level
    above and its ``g``, ``d``, ``c``, ``a`` (scalar sparse, float64 on
    ``prob.device``)."""
    dev = prob.device
    v = _vertices(prob)
    jac, centers = prob.geometry(0, prob.n, dev)
    nodes = torch.tensor(np.concatenate([[-1.0, 1.0], np.cos(np.pi * np.arange(1, prob.p) / prob.p)]),
                         dtype=torch.float64, device=dev)
    pts, w = (torch.tensor(t, dtype=torch.float64, device=dev) for t in np.polynomial.legendre.leggauss(2))
    x_q = centers[:, None] + jac[:, None] * pts[None, :]  # (n, 2): exact for the mass's quadratics

    above = fine_operators(prob)
    base_owner = torch.arange(prob.n, device=dev)
    out = []
    for k, step in enumerate(owner_maps(partition, prob.n)):
        step = torch.as_tensor(step, device=dev)
        m = int(step.max()) + 1
        owner = step[base_owner]
        lo = torch.full((m,), torch.inf, dtype=torch.float64, device=dev).scatter_reduce_(0, owner, v[:-1], "amin")
        hi = torch.full((m,), -torch.inf, dtype=torch.float64, device=dev).scatter_reduce_(0, owner, v[1:], "amax")
        if k == 0:  # the basis at each fine element's DG nodes
            x_n = centers[:, None] + jac[:, None] * nodes[None, :]  # (n, bs_f)
            p_blocks = _basis(x_n, lo[owner, None], hi[owner, None])  # (n, bs_f, 2)
        else:  # the coarse basis re-expanded in each fine box's: values at the fine box's ends
            f_lo, f_hi = prev["boxes"][:, 0], prev["boxes"][:, 1]
            ends = torch.stack([f_lo, f_hi], dim=1)  # (m_f, 2)
            v_f = _basis(ends, f_lo[:, None], f_hi[:, None])  # (m_f, 2 ends, 2)
            v_c = _basis(ends, lo[step, None], hi[step, None])
            p_blocks = torch.linalg.solve(v_f, v_c)  # (m_f, 2 fine, 2 coarse)
        p = block_sparse(torch.arange(step.numel(), device=dev), step, p_blocks.permute(1, 2, 0), step.numel(), m)
        phi_q = _basis(x_q, lo[owner, None], hi[owner, None])  # (n, 2 points, 2)
        per_el = torch.einsum("e,q,eqi,eqj->eij", jac, w, phi_q, phi_q)
        mass = torch.zeros(m, BS, BS, dtype=torch.float64, device=dev).index_add_(0, owner, per_el)
        pt = p.t().coalesce()
        g, d, c = (_mm(pt, _mm(above[x], p)) for x in ("g", "d", "c"))
        ids = torch.arange(m, device=dev)
        minv = block_sparse(ids, ids, torch.linalg.inv(mass).permute(1, 2, 0), m, m)
        a = (c - _mm(d, _mm(minv, g))).coalesce()
        prev = dict(m=m, owner=owner, boxes=torch.stack([lo, hi], dim=1), mass=mass, p=p, g=g, d=d, c=c, a=a)
        out.append(prev)
        above, base_owner = prev, owner
    return out
