"""Block-COO operators: uniform block size, arbitrary block sparsity.

Every operator on contiguous 1D levels is block-tridiagonal; a
*non-contiguous* (scattered) agglomerate couples, through its interface
vertices, to every agglomerate adjacent to any of its runs — a general, if
very sparse, block graph.  Its operators are stored as SoA block COO:

* ``rows`` / ``cols``  (nnz,) int64 block coordinates, row-major sorted and
  coalesced (the construction helpers below enforce this),
* ``blocks``           (bs_r, bs_c, nnz) dense blocks on the trailing axis,
* ``n_rows`` / ``n_cols`` the block counts (host ints),
* ``ell``              (n_rows, K) int64: row r's entries, in order, padded
  with ``nnz`` (a zero column) — the row sums' plan, built at setup.

The matvec is one gather, one broadcast block product and the row sums: one
gather of the products through ``ell`` and K - 1 adds, each row summed in
entry order.  That is ``index_add_``'s sum on the CPU, without the atomics
that make it run-dependent on the card, so CPU and card agree bit for bit.
Products with block-diagonal matrices and the general SpGEMM run on the host
in NumPy at setup, like every other coarse-level factorization here.  These
operators appear only on scattered agglomerated levels; no fused kernel
takes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_diag import BlockDiag
from .block_tridiag import BlockTridiag


class BlockCOO(NamedTuple):
    rows: torch.Tensor  # (nnz,) int64, row-major sorted
    cols: torch.Tensor  # (nnz,) int64
    blocks: torch.Tensor  # (bs_r, bs_c, nnz)
    n_rows: int  # block-row count
    n_cols: int  # block-column count
    ell: torch.Tensor  # (n_rows, K) each row's entries, padded with nnz
    # on a shard (parallel.distributed.shard_hierarchy): the
    # parallel.columns.ColumnPlan of the columns the rank's rows read; rows
    # are then the rank's, numbered from 0, and cols number halo.need (the
    # global columns), n_cols = halo.n_need.  None on a whole operator.
    halo: object | None = None

    @property
    def bs_row(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_col(self) -> int:
        return self.blocks.shape[1]

    @property
    def nnz(self) -> int:
        return self.blocks.shape[2]

    @property
    def block_size(self) -> int:
        if self.blocks.shape[0] != self.blocks.shape[1]:
            raise ValueError("non-square blocks have no single block_size")
        return self.blocks.shape[0]

    @property
    def n_blocks(self) -> int:
        """Block-row count (the ``BlockTridiag`` name, so level code can read
        either operator)."""
        return self.n_rows

    @property
    def n_dof(self) -> int:
        return self.n_rows * self.blocks.shape[0]


def _contract(blocks: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """``out[a, t] = sum_b blocks[a, b, t] xg[b, t]``, ``b`` ascending."""
    out = blocks[:, 0, :] * xg[0]
    for b in range(1, blocks.shape[1]):
        out = out + blocks[:, b, :] * xg[b]
    return out


def row_sums(contrib: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[:, r] = sum_k contrib[:, table[r, k]]``, k ascending; entries
    equal to ``contrib.shape[1]`` read a zero column.  A fixed order on every
    device."""
    g = torch.nn.functional.pad(contrib, (0, 1))[:, table]  # (bs, n, K)
    out = g[:, :, 0]
    for k in range(1, table.shape[1]):
        out = out + g[:, :, k]
    return out


def entry_table(owner: np.ndarray, n: int) -> np.ndarray:
    """``(n, K)`` table of the positions ``t`` with ``owner[t] == r`` for each
    ``r``, ascending, padded with ``len(owner)`` (host NumPy)."""
    owner = np.asarray(owner, dtype=np.int64)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n, max(int(counts.max(initial=0)), 1)), owner.size, dtype=np.int64)
    table[owner[order], np.arange(owner.size) - starts[owner[order]]] = order
    return table


def bcoo_matvec(a: BlockCOO, x: torch.Tensor) -> torch.Tensor:
    """``(bs_c, n_cols) -> (bs_r, n_rows)``."""
    return row_sums(_contract(a.blocks, x[:, a.cols]), a.ell)


def bcoo_matvec_t(a: BlockCOO, r: torch.Tensor) -> torch.Tensor:
    """``A^T r``: ``(bs_r, n_rows) -> (bs_c, n_cols)`` without forming the transpose."""
    contrib = _contract(a.blocks.transpose(0, 1), r[:, a.rows])  # (bs_c, nnz)
    out = torch.zeros((a.bs_col, a.n_cols), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(1, a.cols, contrib)


# ---------------------------------------------------------------------------
# Host construction and algebra (setup only, NumPy in float64)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _host(a: BlockCOO) -> tuple:
    return _np(a.rows).astype(np.int64), _np(a.cols).astype(np.int64), _np(a.blocks)


def bcoo_make(rows, cols, blocks, n_rows: int, n_cols: int, device) -> BlockCOO:
    """A BlockCOO from sorted, coalesced host index arrays and blocks (a
    NumPy array or a tensor), with its ``ell`` table, on ``device``."""
    rows = np.asarray(rows, dtype=np.int64)
    return BlockCOO(rows=_to(rows, device), cols=_to(np.asarray(cols, dtype=np.int64), device),
                    blocks=_to(blocks, device), n_rows=int(n_rows), n_cols=int(n_cols),
                    ell=_to(entry_table(rows, n_rows), device))


def _to(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def bcoo_coalesce(rows, cols, blocks, n_rows: int, n_cols: int, *, prune_tol: float = 0.0,
                  device="cuda") -> BlockCOO:
    """Sort row-major, sum duplicate coordinates, drop all-zero blocks (all
    are kept if every block is zero); on the host, the result on
    ``device``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    blocks = _np(blocks)
    if rows.size == 0:
        e = np.zeros((0,), np.int64)
        return bcoo_make(e, e, np.zeros(blocks.shape[:2] + (0,), blocks.dtype), n_rows, n_cols, device)
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq, start = np.unique(key, return_index=True)
    summed = np.add.reduceat(blocks[:, :, order], start, axis=2)
    keep = np.abs(summed).max(axis=(0, 1)) > prune_tol
    if not keep.any():
        keep[:] = True
    uniq, summed = uniq[keep], summed[:, :, keep]
    return bcoo_make(uniq // n_cols, uniq % n_cols, summed, n_rows, n_cols, device)


def _bt_entries(a: BlockTridiag) -> tuple:
    """``(rows, cols, blocks)`` of a block-tridiagonal's used blocks, host
    NumPy: the diagonal, then the lower, then the upper diagonal."""
    n = a.n_blocks
    k = np.arange(n)
    rows = np.concatenate([k, k[1:], k[:-1]])
    cols = np.concatenate([k, k[1:] - 1, k[:-1] + 1])
    blocks = np.concatenate([_np(a.diag), _np(a.lower)[:, :, 1:], _np(a.upper)[:, :, :-1]], axis=2)
    return rows, cols, blocks


def bcoo_from_bt(a: BlockTridiag) -> BlockCOO:
    """Block-tridiagonal -> block-COO, on ``a``'s device."""
    rows, cols, blocks = _bt_entries(a)
    return bcoo_coalesce(rows, cols, blocks, a.n_blocks, a.n_blocks, device=a.diag.device)


def bcoo_to_dense(a: BlockCOO) -> torch.Tensor:
    """Materialize dense (tests / coarse-level factorization only), in the
    block-index-major DoF order of ``bt_to_dense`` (dof = k * bs + i)."""
    bs_r, bs_c = a.bs_row, a.bs_col
    dense = torch.zeros((a.n_rows, bs_r, a.n_cols, bs_c), dtype=a.blocks.dtype, device=a.blocks.device)
    dev = a.blocks.device
    i = torch.arange(bs_r, device=dev)[None, :, None]
    j = torch.arange(bs_c, device=dev)[None, None, :]
    idx = (a.rows[:, None, None], i, a.cols[:, None, None], j)
    dense.index_put_(idx, torch.movedim(a.blocks, -1, 0), accumulate=True)
    return dense.reshape(a.n_rows * bs_r, a.n_cols * bs_c)


def bcoo_scale_cols(a: BlockCOO, d: BlockDiag | torch.Tensor) -> BlockCOO:
    """``A @ blockdiag(D)``: right-multiply each block by ``D[cols[t]]``;
    ``d`` is ``(bs_c, bs_c, n_cols)`` or a BlockDiag holding it."""
    db = d.blocks if isinstance(d, BlockDiag) else d
    _, cols, blocks = _host(a)
    blocks = np.einsum("abt,bct->act", blocks, _np(db)[:, :, cols])
    return a._replace(blocks=torch.from_numpy(blocks).to(a.blocks.device))


def bcoo_spgemm(a: BlockCOO, b: BlockCOO) -> BlockCOO:
    """``A @ B`` (host, a vectorised join on ``a.cols == b.rows``)."""
    if a.n_cols != b.n_rows or a.bs_col != b.bs_row:
        raise ValueError("bcoo_spgemm: inner dimensions do not match")
    ar, ac, ab = _host(a)
    br, bc, bb = _host(b)
    counts = np.bincount(br, minlength=a.n_cols)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(br, kind="stable")
    rep = counts[ac]  # matches per entry of a
    a_idx = np.repeat(np.arange(ar.size), rep)
    offs = np.arange(rep.sum()) - np.repeat(np.cumsum(rep) - rep, rep)
    b_idx = order[np.repeat(starts[ac], rep) + offs]
    blocks = np.einsum("abt,bct->act", ab[:, :, a_idx], bb[:, :, b_idx])
    return bcoo_coalesce(ar[a_idx], bc[b_idx], blocks, a.n_rows, b.n_cols, device=a.blocks.device)


def bcoo_add(a: BlockCOO, b: BlockCOO, *, beta: float = 1.0) -> BlockCOO:
    """``A + beta * B`` (host coalesce)."""
    if (a.n_rows, a.n_cols) != (b.n_rows, b.n_cols):
        raise ValueError("bcoo_add: shape mismatch")
    ar, ac, ab = _host(a)
    br, bc, bb = _host(b)
    return bcoo_coalesce(np.concatenate([ar, br]), np.concatenate([ac, bc]),
                         np.concatenate([ab, beta * bb], axis=2), a.n_rows, a.n_cols, device=a.blocks.device)


def bcoo_diag_blocks(a: BlockCOO) -> torch.Tensor:
    """``(bs, bs, n_rows)`` diagonal blocks (zero where absent), on ``a``'s device."""
    if a.n_rows != a.n_cols:
        raise ValueError("diagonal of a non-square operator")
    out = torch.zeros((a.bs_row, a.bs_col, a.n_rows), dtype=a.blocks.dtype, device=a.blocks.device)
    on_diag = a.rows == a.cols
    out[:, :, a.rows[on_diag]] = a.blocks[:, :, on_diag]
    return out
