"""The V-cycle's hot kernels: CUDA wrappers and their plain versions.

* K3 :func:`fused_bt_matvec` — ``y = A_D x + A_L x_{-1} + A_U x_{+1}``;
* K2 :func:`multisweep` — ``n_sweeps`` damped block-Jacobi sweeps in M-form;
* K1 :func:`multisweep_residual` — K2 plus the residual ``b - A x``;
* K5 :func:`chebyshev_multisweep` / :func:`chebyshev_multisweep_residual` —
  ``k`` steps of the Chebyshev recurrence over block-Jacobi in M-form
  (``z = (c - x) - (ML x_{-1} + MU x_{+1})``, ``d = c_d d + c_z z``,
  ``x += d``, with ``d = 0`` at the start), without or with the residual;
* K6 :func:`ff_stencil_mid_defect` — the float-float defect ``r = b - A x``
  of a stencil operator (``ops.df64.BTFFStencil``), error-free arithmetic,
  bit for bit equal to :func:`ff_stencil_mid_defect_plain`; K6s
  :func:`ff_stencil_shard_defect` — the same on one shard of a sharded
  vector, with its global column offset and its neighbours' edge columns;
* K12 :func:`ff_bt_defect` — the same float-float defect of a materialised
  ``ops.df64.BlockTridiagFF`` (per-column operator streams; streams and
  vectors at any strides), with optional ghost columns, bit for bit equal to :func:`ff_bt_defect_plain`;
* K13 :func:`ff_cg_defect` — the same float-float defect of an assembled CG
  band (``ops.df64.CgBandFF``, ``(2p + 1, n)``; any order p, every operand
  at its strides), with an optional halo of p nodes a side, bit for bit
  equal to :func:`ff_cg_defect_plain`;
* K14 :func:`ff_cheb_update` — one step of the true cycle's Chebyshev
  smoothing on a block-Jacobi level: ``z = S^-1 r_hi`` (K9's rounding), ``d
  = z / theta`` or ``d = c_d d + c_z z``, ``u = ff_add(u, (d, 0))``, every
  operand at its strides, bit for bit equal to :func:`ff_cheb_update_plain`;
* K7 — K1, K2 and K5 (four forms) with ``ghosts=(gops, gvec)``: one shard of
  an element-sharded operator, with its neighbours' columns as ghosts
  (``parallel.sharded_kernels``); the result is the sweeps over
  ``[left ghosts | shard | right ghosts]``, cropped to the shard;
* the edge pair, :class:`EdgePlan` — what the sharded path launches per
  smoothing in K7's place: :meth:`EdgePlan.pack` copies the shard's edge
  columns of x and b into the two messages its ring neighbours receive (one
  launch), and :meth:`EdgePlan.sweep_edges` / :meth:`EdgePlan.chebyshev_edges`
  recompute both shard edges of a zero-ghost K1 / K2 / K5 pass in place in ONE
  launch, reading the received messages where the exchange left them.  A plan
  binds a level's operators, checked once, and owns the messages;
* K8 :func:`block_jacobi_sweep` — one A-form sweep ``x + alpha S^-1 (b - A x)``
  on four operator streams (a public op; no solver path calls it);
* K4 :func:`stream_kernel` — the bandwidth yardstick: reads the multisweep's
  operands (ML, MU, S^-1, x, b) once and writes one vector, one add each;
* the block contractions of the solve path, off the library's batched gemv:
  :func:`bd_gemv` (``ops.block_diag.bd_matvec``, every block-Jacobi apply),
  :func:`bp_prolong_gemv` and :func:`bp_restrict_gemv`
  (``ops.transfer_ops.bp_prolong`` / ``bp_restrict``, every block-aligned
  transfer), float32 and float64, each block size in
  ``SUPPORTED_BLOCK_SIZES``, operands at any strides.
  Each output entry is rounded as the card's gemv rounds it (``_gemv_dot``);
  their plain versions emulate the fused multiply-add exactly.

M-form: with ``S^-1`` the exact inverse of ``A_D``, the damped sweep
``x + alpha S^-1 (b - A x)`` equals ``x + alpha ((c - x) - (ML x_{-1} + MU x_{+1}))``
with ``c = S^-1 b``, ``ML = S^-1 A_L`` and ``MU = S^-1 A_U`` (precomputed at
setup by :func:`..models.hierarchy.prepare_fast_smoothers`), and
``A x = A_D ((x + ML x_{-1}) + MU x_{+1})``.

Each wrapper checks its inputs (float32, matching shapes, contiguous, one
device) and then dispatches by device: a CUDA tensor launches the hand-written
kernel of ``csrc/block_kernels.cu`` (built with nvcc at first use), a CPU
tensor runs the ``*_plain`` version beside it, which follows the kernel's
order of operations.  There is no fallback from a CUDA tensor to the plain
version: a build or launch failure raises.

``LAUNCHES`` counts kernel launches per wrapper (plain runs do not count), so
a run can show that it went through the kernels; K6s counts under
``ff_stencil_shard_defect``, K12 under ``ff_bt_defect``, K13 under ``ff_cg_defect``, K14 under
``ff_cheb_update``, K7's four
forms under the ``*_ghost`` names, the edge pair's under the ``*edge_pair*`` names
and its packing under ``pack_edges``.

K5's coefficient table (:func:`chebyshev_coefficients`) is passed to the
kernel by value, as host floats, and so are K14's ``theta``
(:func:`chebyshev_theta`) and row: a launch reads no scalar from the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..block_tridiag import BlockTridiag
from ..shifts import shift

SUPPORTED_BLOCK_SIZES = (1, 2, 3, 4, 5, 9)
MAX_SWEEPS = 8  # the kernel's 256-column window keeps >= 238 centre columns

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = _PKG_DIR / "csrc" / "block_kernels.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "aggmg_torch_kernels"

LAUNCHES = {
    "bt_matvec": 0,
    "multisweep": 0,
    "multisweep_residual": 0,
    "chebyshev_multisweep": 0,
    "chebyshev_multisweep_residual": 0,
    "ff_stencil_mid_defect": 0,
    "ff_stencil_shard_defect": 0,
    "ff_bt_defect": 0,
    "ff_cg_defect": 0,
    "ff_cheb_update": 0,
    "multisweep_ghost": 0,
    "multisweep_residual_ghost": 0,
    "chebyshev_multisweep_ghost": 0,
    "chebyshev_multisweep_residual_ghost": 0,
    "block_jacobi_sweep": 0,
    "stream_kernel": 0,
    "edge_pair": 0,
    "edge_pair_residual": 0,
    "chebyshev_edge_pair": 0,
    "chebyshev_edge_pair_residual": 0,
    "pack_edges": 0,
    "bd_gemv": 0,
    "bp_prolong_gemv": 0,
    "bp_restrict_gemv": 0,
}

_LIB = None
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _mat(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``y[i, :] = sum_j m[i, j, :] * v[j, :]``, j ascending."""
    acc = m[:, 0, :] * v[0:1, :]
    for j in range(1, m.shape[1]):
        acc = acc + m[:, j, :] * v[j : j + 1, :]
    return acc


def bt_matvec_plain(a: BlockTridiag, x: torch.Tensor) -> torch.Tensor:
    return (_mat(a.diag, x) + _mat(a.lower, shift(x, -1))) + _mat(a.upper, shift(x, +1))


def _ghost_window(ghosts, ops, vecs):
    """K7's plain form: the operator streams and vectors widened to
    ``[left ghosts | shard | right ghosts]``; a stream with no ghost stream
    (A_D, which only the shard's own residual reads) is widened with zeros.
    Returns ``(ops, vecs, g)``."""
    gops, gvec = ghosts
    g = gops.shape[-1] // 2

    def wide(t, gt):
        return torch.cat([gt[..., :g], t, gt[..., g:]], dim=-1)

    ops = tuple(
        wide(m, gops[s] if s < gops.shape[0] else torch.zeros_like(gops[0]))
        for s, m in enumerate(ops)
    )
    return ops, tuple(wide(v, gvec[s]) for s, v in enumerate(vecs)), g


def multisweep_plain(ml, mu, s_inv, x, b, n_sweeps: int = 3, alpha: float = 2.0 / 3.0, ghosts=None):
    if ghosts is not None:
        n = x.shape[-1]
        (ml, mu, s_inv), (x, b), g = _ghost_window(ghosts, (ml, mu, s_inv), (x, b))
        return multisweep_plain(ml, mu, s_inv, x, b, n_sweeps, alpha)[:, g : g + n]
    c = _mat(s_inv, b)
    for _ in range(n_sweeps):
        t = _mat(ml, shift(x, -1)) + _mat(mu, shift(x, +1))
        x = x + alpha * ((c - x) - t)
    return x


def multisweep_residual_plain(
    ml, mu, s_inv, a_diag, x, b, n_sweeps: int = 3, alpha: float = 2.0 / 3.0, ghosts=None
):
    if ghosts is not None:
        n = x.shape[-1]
        ops, (x, b), g = _ghost_window(ghosts, (ml, mu, s_inv, a_diag), (x, b))
        out = multisweep_residual_plain(*ops, x, b, n_sweeps, alpha)
        return tuple(t[:, g : g + n] for t in out)
    x = multisweep_plain(ml, mu, s_inv, x, b, n_sweeps, alpha)
    t = (x + _mat(ml, shift(x, -1))) + _mat(mu, shift(x, +1))
    return x, b - _mat(a_diag, t)


def chebyshev_theta(lam_lo, lam_hi) -> np.float32:
    """The centre ``0.5 (lam_hi + lam_lo)`` of the float32 interval, in float32
    arithmetic: what the Chebyshev recurrence's first step divides by."""
    f = np.float32
    return f(0.5) * (f(lam_hi) + f(lam_lo))


def chebyshev_coefficients(lam_lo, lam_hi, degree: int) -> np.ndarray:
    """``(degree, 2)`` recurrence coefficients ``[c_d, c_z]`` of the classic
    Chebyshev smoother on ``[lam_lo, lam_hi]`` (step s: ``d = c_d d + c_z z;
    x += d``).  Computed in float32 arithmetic from the float32 interval, in
    the JAX package's order of operations, so both packages hold the same
    table.  Row s does not depend on ``degree``."""
    f = np.float32
    lam_lo, lam_hi = f(lam_lo), f(lam_hi)
    theta = chebyshev_theta(lam_lo, lam_hi)
    delta = f(0.5) * (lam_hi - lam_lo)
    sigma = theta / delta
    rows = [(f(0.0), f(1.0) / theta)]
    rho = f(1.0) / sigma
    for _ in range(1, degree):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        rows.append((rho_new * rho, f(2.0) * rho_new / delta))
        rho = rho_new
    return np.asarray(rows, dtype=np.float32).reshape(degree, 2)


def chebyshev_multisweep_plain(ml, mu, s_inv, x, b, coef, ghosts=None):
    """``len(coef)`` Chebyshev steps in M-form; ``coef`` rows are ``(c_d, c_z)``."""
    if ghosts is not None:
        n = x.shape[-1]
        (ml, mu, s_inv), (x, b), g = _ghost_window(ghosts, (ml, mu, s_inv), (x, b))
        return chebyshev_multisweep_plain(ml, mu, s_inv, x, b, coef)[:, g : g + n]
    c = _mat(s_inv, b)
    d = torch.zeros_like(x)
    for c_d, c_z in coef:
        t = _mat(ml, shift(x, -1)) + _mat(mu, shift(x, +1))
        d = float(c_d) * d + float(c_z) * ((c - x) - t)
        x = x + d
    return x


def chebyshev_multisweep_residual_plain(ml, mu, s_inv, a_diag, x, b, coef, ghosts=None):
    if ghosts is not None:
        n = x.shape[-1]
        ops, (x, b), g = _ghost_window(ghosts, (ml, mu, s_inv, a_diag), (x, b))
        out = chebyshev_multisweep_residual_plain(*ops, x, b, coef)
        return tuple(t[:, g : g + n] for t in out)
    x = chebyshev_multisweep_plain(ml, mu, s_inv, x, b, coef)
    t = (x + _mat(ml, shift(x, -1))) + _mat(mu, shift(x, +1))
    return x, b - _mat(a_diag, t)


def pack_edges_plain(x, b, g: int, left: bool = True, right: bool = True) -> tuple:
    """The two messages ``(2, bs, g)`` a shard sends its ring neighbours: the
    first ``g`` columns of x and of b to the left, the last ``g`` to the
    right; None on a side without a neighbour."""
    n = x.shape[-1]
    to_left = torch.stack([x[:, :g], b[:, :g]]) if left else None
    to_right = torch.stack([x[:, n - g :], b[:, n - g :]]) if right else None
    return to_left, to_right


def _edge_windows(ops, x, b, gops, from_left, from_right, s: int, halo: int):
    """The edge pair's two windows, left then right: per side the operator
    streams and ``(x, b)`` on the ``s`` edge columns with ``halo`` columns on
    either side of them: outside, the neighbour's nearest columns (the
    operators from K7's ``gops``, x and b from the received message
    ``(2, bs, g)``; zeros for a None message, a ring end), inside, the
    shard's own.  A stream with no ghost stream (A_D) is widened with zeros."""
    n, g = x.shape[-1], gops.shape[-1] // 2
    if halo > g or n < 2 * s:
        raise ValueError(f"the edge pair needs {halo} <= {g} ghost columns and {n} >= {2 * s} columns")
    for side, msg in ((0, from_left), (1, from_right)):
        inner = slice(0, s + halo) if side == 0 else slice(n - s - halo, n)
        near = slice(g - halo, g) if side == 0 else slice(0, halo)  # of the neighbour's g columns
        gcols = near if side == 0 else slice(g, g + halo)

        def wide(t, gt):
            gt = torch.zeros_like(t[..., :halo]) if gt is None else gt
            pair = [gt, t[..., inner]]
            return torch.cat(pair if side == 0 else pair[::-1], dim=-1)

        w_ops = tuple(
            wide(m, gops[k][..., gcols] if msg is not None and k < gops.shape[0] else None)
            for k, m in enumerate(ops)
        )
        yield w_ops, tuple(wide(v, None if msg is None else msg[k][:, near]) for k, v in enumerate((x, b)))


def _edges_plain(sweep, ops, x, b, gops, from_left, from_right, k: int, residual: bool) -> tuple:
    """``sweep(ops, x, b)`` (a plain multisweep, zeros beyond the window as
    in the kernel) on each edge window, cropped to its ``s = k + 1`` output
    columns: ``(x_left, x_right)``, with the residual also ``r_left, r_right``."""
    s, halo = k + 1, k + (1 if residual else 0)
    outs = []
    for w_ops, (wx, wb) in _edge_windows(ops, x, b, gops, from_left, from_right, s, halo):
        res = sweep(w_ops, wx, wb)
        outs.append(tuple(t[:, halo : halo + s] for t in (res if residual else (res,))))
    return tuple(side[i] for i in range(len(outs[0])) for side in outs)


def multisweep_edges_plain(
    ml, mu, s_inv, x, b, gops, from_left, from_right, n_sweeps: int = 3, alpha: float = 2.0 / 3.0
):
    """The edge pair's plain version, damped: the ``s = n_sweeps + 1`` first
    and last columns of the sweeps over ``[left ghosts | shard | right
    ghosts]``, each computed from its own window of ``s + 2 n_sweeps`` columns
    in the kernel's order of operations (not by sweeping the shard).
    ``from_left`` / ``from_right``: the neighbours' messages ``(2, bs, g)``
    (:func:`pack_edges_plain`), None at a ring end.  Returns ``(x_left, x_right)``."""
    return _edges_plain(
        lambda o, xx, bb: multisweep_plain(*o, xx, bb, n_sweeps, alpha),
        (ml, mu, s_inv), x, b, gops, from_left, from_right, n_sweeps, False,
    )


def multisweep_residual_edges_plain(
    ml, mu, s_inv, a_diag, x, b, gops, from_left, from_right, n_sweeps: int = 3, alpha: float = 2.0 / 3.0
):
    """:func:`multisweep_edges_plain` plus the residual's edge columns, from
    windows one column wider a side: ``(x_left, x_right, r_left, r_right)``."""
    return _edges_plain(
        lambda o, xx, bb: multisweep_residual_plain(*o, xx, bb, n_sweeps, alpha),
        (ml, mu, s_inv, a_diag), x, b, gops, from_left, from_right, n_sweeps, True,
    )


def chebyshev_multisweep_edges_plain(ml, mu, s_inv, x, b, coef, gops, from_left, from_right):
    """The edge pair's plain version, Chebyshev (``coef`` rows ``(c_d, c_z)``);
    see :func:`multisweep_edges_plain`."""
    return _edges_plain(
        lambda o, xx, bb: chebyshev_multisweep_plain(*o, xx, bb, coef),
        (ml, mu, s_inv), x, b, gops, from_left, from_right, len(coef), False,
    )


def chebyshev_multisweep_residual_edges_plain(ml, mu, s_inv, a_diag, x, b, coef, gops, from_left, from_right):
    return _edges_plain(
        lambda o, xx, bb: chebyshev_multisweep_residual_plain(*o, xx, bb, coef),
        (ml, mu, s_inv, a_diag), x, b, gops, from_left, from_right, len(coef), True,
    )


def block_jacobi_sweep_plain(a: BlockTridiag, s_inv, x, b, alpha: float = 2.0 / 3.0):
    """K8's plain version: ``x + alpha S^-1 r`` with
    ``r = ((b - A_D x) - A_L x_{-1}) - A_U x_{+1}``, the Pallas body's order."""
    r = ((b - _mat(a.diag, x)) - _mat(a.lower, shift(x, -1))) - _mat(a.upper, shift(x, +1))
    return x + alpha * _mat(s_inv, r)


def stream_kernel_plain(ml, mu, s_inv, x, b):
    """K4's plain version: ``(x + b)`` plus every entry of row ``i`` of ML,
    then MU, then S^-1, block columns ascending."""
    acc = x + b
    for m in (ml, mu, s_inv):
        for j in range(m.shape[1]):
            acc = acc + m[:, j, :]
    return acc


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``(s, e)`` with ``s = a + b`` rounded and ``s + e = a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The float64 ``s + e`` (``s`` its rounding to nearest, ``e`` exact)
    rounded to odd: ``s`` where ``e = 0``, else the neighbour of ``s + e``
    whose last bit is 1.  Rounding that value once more to fewer than 52
    bits gives the correct rounding of ``s + e`` (Boldo and Melquiond, IEEE
    Trans. Computers 57(4), 2008)."""
    bits = s.view(torch.int64) - ((e != 0) & ((e < 0) != (s < 0))).to(torch.int64)  # toward zero
    return torch.where(e != 0, bits | 1, bits).view(torch.float64)


def _split(a: torch.Tensor) -> tuple:
    t = 134217729.0 * a  # 2^27 + 1: Veltkamp's split of a float64
    hi = t - (t - a)
    return hi, a - hi


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, in the operands' dtype, as a fused
    multiply-add unit rounds it.  float32: the product is exact in float64,
    and the float64 sum is rounded to odd before its rounding to float32
    (a plain float64 sum would round twice, and can miss by one ulp).
    float64: Dekker's exact product and the same rounding to odd (the
    emulated FMA of Boldo and Melquiond)."""
    if a.dtype == torch.float32:
        return _round_to_odd(*_two_sum(a.double() * b.double(), c.double())).float()
    p = a * b
    (ah, al), (bh, bl) = _split(a), _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    return th + _round_to_odd(*_two_sum(tl, e))


def _fma_chain(ms, vs) -> torch.Tensor:
    """``ms[0] * vs[0]`` rounded, then one fused multiply-add per further
    term, ascending."""
    acc = ms[0] * vs[0]
    for m, v in zip(ms[1:], vs[1:]):
        acc = _fma(m, v, acc)
    return acc


def _gemv_dot(ms, vs) -> torch.Tensor:
    """``sum_j ms[j] * vs[j]`` (``j < K``) as the card's batched gemv rounds
    it at the cells' shapes (``tools/gemv_rounding_order.py``) and the
    ``*_gemv_kernel`` s form it: the halves ``j < h`` and ``j >= h``, ``h =
    ceil(K / 2)``, each an fma chain (:func:`_fma_chain`), then their rounded
    sum.  K = 2: ``m0 v0 + m1 v1``, both products rounded; K = 4:
    ``fma(m1, v1, m0 v0) + fma(m3, v3, m2 v2)``."""
    h = (len(ms) + 1) // 2
    lo = _fma_chain(ms[:h], vs[:h])
    return lo if h == len(ms) else lo + _fma_chain(ms[h:], vs[h:])


def bd_gemv_plain(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`bd_gemv`'s plain version: ``y[i] = sum_j blocks[i, j] x[j]``
    per column, in the kernel's order (:func:`_gemv_dot`)."""
    bs = x.shape[0]
    return torch.stack([_gemv_dot(blocks[i], x) for i in range(bs)])


def bp_prolong_gemv_plain(blocks: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """:func:`bp_prolong_gemv`'s plain version: fine column ``r c + j`` is
    ``blocks[j, :, :, c] @ xc[:, c]``, each entry in the kernel's order."""
    r, bs_f, _, n_c = blocks.shape
    t = torch.stack([torch.stack([_gemv_dot(blocks[j, i], xc) for i in range(bs_f)]) for j in range(r)])
    return t.permute(1, 2, 0).reshape(bs_f, r * n_c)


def bp_restrict_gemv_plain(blocks: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """:func:`bp_restrict_gemv`'s plain version: per offset ``j`` the
    contraction ``blocks[j, :, b, c] . rf[:, r c + j]`` in the kernel's order,
    the offsets added in ascending ``j`` with rounded adds."""
    r, bs_f, bs_c, _ = blocks.shape
    out = None
    for j in range(r):
        v = rf[:, j::r]
        oj = torch.stack([_gemv_dot(blocks[j, :, b], v) for b in range(bs_c)])
        out = oj if out is None else out + oj
    return out


def _stencil_op(blocks: torch.Tensor, cols):
    """The float-float BlockTridiag of the packed stencil's columns ``cols``."""
    from ..df64 import BlockTridiagFF

    def bt(h):
        return BlockTridiag(lower=blocks[h, 1][..., cols], diag=blocks[h, 0][..., cols],
                            upper=blocks[h, 2][..., cols])

    return BlockTridiagFF(bt(0), bt(1))


def _stencil_boundary(bw: int, col0: int, n: int, n_total: int) -> tuple:
    """The shard's columns among the first and last ``bw`` global ones:
    ``(local, stencil)``, the local column indices and their columns of the
    packed stencil (``k`` for global column ``k < bw``, ``bw + 1 + j`` for
    the ``j``-th of the last ``bw``)."""
    local, stencil = [], []
    for g0, g1, shift_ in ((col0, min(bw, col0 + n), 0),
                           (max(n_total - bw, col0), min(n_total, col0 + n), 2 * bw + 1 - n_total)):
        local += [kg - col0 for kg in range(g0, g1)]
        stencil += [kg + shift_ for kg in range(g0, g1)]
    return local, stencil


def _neighbours(x_hi, x_lo, ghost_left, ghost_right) -> tuple:
    """``(x_{k-1}, x_{k+1})`` as float-float pairs: x shifted by one column,
    the ghost column ``(2, bs)`` (hi, then lo) at each end where given, else
    zeros (the zero-padded shift)."""
    from ..df64 import FF

    def ghost(gc):
        if gc is None:
            z = x_hi.new_zeros((x_hi.shape[0], 1))
            return z, z
        return gc[0][:, None], gc[1][:, None]

    (gl_hi, gl_lo), (gr_hi, gr_lo) = ghost(ghost_left), ghost(ghost_right)
    xm = FF(torch.cat([gl_hi, x_hi[:, :-1]], dim=1), torch.cat([gl_lo, x_lo[:, :-1]], dim=1))
    xp = FF(torch.cat([x_hi[:, 1:], gr_hi], dim=1), torch.cat([x_lo[:, 1:], gr_lo], dim=1))
    return xm, xp


def ff_bt_defect_plain(a, x_hi, x_lo, b_hi, b_lo, ghost_left=None, ghost_right=None):
    """K12's plain version: ``r = b - A x`` in float-float for the
    materialised operator ``a`` (``ops.df64.BlockTridiagFF``), the chain of
    ``ops.df64.ff_bt_defect_chain`` in the kernel's order (acc = b; diag on
    x, lower on ``x_{k-1}``, upper on ``x_{k+1}``; block columns ascending).
    ``x_{k-1}`` / ``x_{k+1}`` past the ends are ``ghost_left`` /
    ``ghost_right`` (``(2, bs)``: hi, then lo), zero where None.  Returns
    ``(r_hi, r_lo)``."""
    from ..df64 import FF, ff_bt_defect_chain

    r = ff_bt_defect_chain(a, FF(x_hi, x_lo), FF(b_hi, b_lo), *_neighbours(x_hi, x_lo, ghost_left, ghost_right))
    return r.hi, r.lo


def ff_cg_defect_plain(band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, halo_left=None, halo_right=None):
    """K13's plain version: ``r = b - A x`` in float-float for the CG band
    ``(band_hi, band_lo)`` (``ops.df64.CgBandFF``: ``(2p + 1, n)``, row ``p +
    off`` holding ``A[i, i + off]``), the chain in the kernel's order: acc =
    b; for ``off = -p .. p`` ascending, ``acc = ff_add(acc,
    ff_neg(ff_mul(band[p + off], x[i + off])))``.  The p nodes past each end
    of x are ``halo_left`` / ``halo_right`` (each a ``(hi, lo)`` pair of
    ``(p,)`` tensors: a shard's neighbours' nodes), zero where None.  Returns
    ``(r_hi, r_lo)``."""
    from ..df64 import FF, ff_add, ff_mul, ff_neg

    rows, n = band_hi.shape
    p = rows // 2
    zero = x_hi.new_zeros(p)
    (l_hi, l_lo), (r_hi, r_lo) = ((zero, zero) if h is None else h for h in (halo_left, halo_right))
    ext = FF(torch.cat([l_hi, x_hi, r_hi]), torch.cat([l_lo, x_lo, r_lo]))
    acc = FF(b_hi, b_lo)
    for off in range(-p, p + 1):
        xs = FF(ext.hi[p + off : p + off + n], ext.lo[p + off : p + off + n])
        acc = ff_add(acc, ff_neg(ff_mul(FF(band_hi[off + p], band_lo[off + p]), xs)))
    return acc.hi, acc.lo


def ff_cheb_update_plain(s_inv, r_hi, u_hi, u_lo, d=None, *, theta=None, coef=None, keep_d=True):
    """K14's plain version: one step of ``models.solvers._chebyshev`` with
    ``_smooth_true``'s float-float update, in the chain's order: ``z = S^-1
    r_hi`` as K9 rounds it (:func:`bd_gemv_plain`; the chain's ``1.0 *``
    changes no bit); ``d = z / theta`` on the first step (``d`` None), else
    ``d = c_d d + c_z z`` with ``coef = (c_d, c_z)``; ``u = ff_add(u, (d,
    0))``.  The scalars act as float32 0-d tensors on the data's device, as
    the chain's recurrence leaves them (so the division is a true one, not a
    product with the reciprocal).  Returns ``(u_hi, u_lo, d)``, ``d`` None
    where not ``keep_d`` (the last step)."""
    from ..df64 import FF, ff_add

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=r_hi.device)

    z = bd_gemv_plain(s_inv, r_hi)
    if d is None:
        d = z / scalar(theta)
    else:
        c_d, c_z = coef
        d = scalar(c_d) * d + scalar(c_z) * z
    u = ff_add(FF(u_hi, u_lo), FF(d, torch.zeros_like(d)))
    return u.hi, u.lo, (d if keep_d else None)


def ff_stencil_mid_defect_plain(blocks, x_hi, x_lo, b_hi, b_lo, col0: int = 0, n_total: int | None = None,
                                ghost_left=None, ghost_right=None):
    """``r = b - A x`` in float-float for the packed stencil ``blocks``
    (``(2, 3, bs, bs, 2 bw + 1)``, see ``ops.df64.stencil_blocks``): the
    interior pass with the mid blocks broadcast over every column (the Pallas
    kernel's computation), then, for ``bw > 0``, the columns among the first
    and last ``bw`` recomputed with their exact blocks and spliced in (the
    JAX package's ``ff_bt_defect_stencil``).  Returns ``(r_hi, r_lo)``.

    On a shard (K6s) the columns are global columns ``[col0, col0 + n)`` of
    ``n_total``, and ``x_{-1}`` / ``x_{+1}`` past the shard's ends are the
    neighbours' edge columns ``ghost_left`` / ``ghost_right`` (``(2, bs)``:
    hi, then lo), zero where None (a ring end).  Every column runs the same
    operations in the same order as in the whole array."""
    from ..df64 import FF, ff_bt_defect_chain

    bw = (blocks.shape[-1] - 1) // 2
    n = x_hi.shape[1]
    n_total = n if n_total is None else n_total
    x = FF(x_hi, x_lo)
    xm, xp = _neighbours(x_hi, x_lo, ghost_left, ghost_right)
    r = ff_bt_defect_chain(_stencil_op(blocks, slice(bw, bw + 1)), x, FF(b_hi, b_lo), xm, xp)
    local, stencil = _stencil_boundary(bw, col0, n, n_total)
    if not local:
        return r.hi, r.lo
    idx = torch.tensor(local, device=x_hi.device)

    def at(v: FF) -> FF:
        return FF(v.hi[:, idx], v.lo[:, idx])

    rb = ff_bt_defect_chain(_stencil_op(blocks, stencil), at(x), FF(b_hi[:, idx], b_lo[:, idx]), at(xm), at(xp))
    r_hi, r_lo = r.hi.clone(), r.lo.clone()
    r_hi[:, idx], r_lo[:, idx] = rb.hi, rb.lo
    return r_hi, r_lo


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the built library lives; its name carries the source's hash, so
    an edited source builds anew."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libaggmg_torch_kernels_{digest}.so"


def build() -> Path:
    """Compile ``csrc/block_kernels.cu`` for sm_90a unless this source's
    library is already built; returns the library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / (so.stem + ".ptxas.txt")).write_text(proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees no half-written file
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.aggmg_bt_matvec.argtypes = [i, p, p, p, p, p, ll, p]
            lib.aggmg_bt_matvec.restype = i
            lib.aggmg_multisweep.argtypes = [i, p, p, p, p, p, p, p, p, i, p, p, ll, ll, ll, i, f, p]
            lib.aggmg_multisweep.restype = i
            lib.aggmg_chebyshev.argtypes = [i, p, p, p, p, p, p, p, p, i, p, p, ll, ll, ll, i, p, p]
            lib.aggmg_chebyshev.restype = i
            lib.aggmg_ff_stencil_defect.argtypes = [i, p, i, p, p, p, p, p, p, ll, ll, ll, p, p, p]
            lib.aggmg_ff_stencil_defect.restype = i
            lib.aggmg_ff_bt_defect.argtypes = [i, p, p, ll, p, p, p]
            lib.aggmg_ff_bt_defect.restype = i
            lib.aggmg_ff_cg_defect.argtypes = [i, p, p, ll, p]
            lib.aggmg_ff_cg_defect.restype = i
            lib.aggmg_ff_cheb_update.argtypes = [i, p, p, ll, f, f, f, p]
            lib.aggmg_ff_cheb_update.restype = i
            lib.aggmg_block_jacobi_sweep.argtypes = [i, p, p, p, p, p, p, p, ll, f, p]
            lib.aggmg_block_jacobi_sweep.restype = i
            lib.aggmg_stream.argtypes = [i, p, p, p, p, p, p, ll, p]
            lib.aggmg_stream.restype = i
            lib.aggmg_edge_pair.argtypes = [i, p, p, p, p, p, p, p, p, p, i, p, p, ll, i, f, p]
            lib.aggmg_edge_pair.restype = i
            lib.aggmg_edge_pair_chebyshev.argtypes = [i, p, p, p, p, p, p, p, p, p, i, p, p, ll, i, p, p]
            lib.aggmg_edge_pair_chebyshev.restype = i
            lib.aggmg_pack_edges.argtypes = [i, p, p, p, p, i, ll, p]
            lib.aggmg_pack_edges.restype = i
            lib.aggmg_bd_gemv.argtypes = [i, i, p, ll, ll, ll, p, ll, ll, p, ll, p]
            lib.aggmg_bd_gemv.restype = i
            for fn in (lib.aggmg_bp_prolong_gemv, lib.aggmg_bp_restrict_gemv):
                fn.argtypes = [i, i, i, p, ll, ll, ll, ll, p, ll, ll, p, i, ll, p]
                fn.restype = i
            lib.aggmg_empty.argtypes = [p]
            lib.aggmg_empty.restype = i
            _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_tensors(tensors, bs: int | None, dev: torch.device, contiguous: bool = True) -> None:
    """float32, on ``dev``, contiguous unless told otherwise; a block size
    the kernels have on CUDA (None: the operands have none)."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the block kernels take float32 only, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"all inputs must be on one device ({dev} and {t.device})")
        if contiguous and not t.is_contiguous():
            raise ValueError("the block kernels take contiguous tensors")
    if dev.type == "cuda" and bs is not None and bs not in SUPPORTED_BLOCK_SIZES:
        raise ValueError(f"block size {bs} has no kernel (supported: {SUPPORTED_BLOCK_SIZES})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check(ops, vecs) -> tuple[int, int, torch.device]:
    """Validate operator streams ``(bs, bs, n)`` and vectors ``(bs, n)``."""
    bs, _, n = ops[0].shape
    dev = ops[0].device
    _check_tensors((*ops, *vecs), bs, dev)
    for m in ops:
        if tuple(m.shape) != (bs, bs, n):
            raise ValueError(f"operator stream of shape {tuple(m.shape)}, expected {(bs, bs, n)}")
    for v in vecs:
        if tuple(v.shape) != (bs, n):
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected {(bs, n)}")
    return bs, n, dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        why = {-1: "unsupported block size", -2: "too many steps",
               -3: "shard or ghost width out of range"}.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {why}")


# The current stream's handle without building a torch.cuda.Stream object (a
# lookup that costs more than the launch itself on a busy host); the public
# form where this torch has no such function.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream.  The launch goes to
    the current device, so ``dev``'s context is entered where it is not the
    current one (it is, on the solvers' paths: nothing is entered there)."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args, _stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _stream(dev))


def fused_bt_matvec(a: BlockTridiag, x: torch.Tensor) -> torch.Tensor:
    """K3: ``y = A_D x + A_L x_{-1} + A_U x_{+1}``."""
    bs, n, dev = _check((a.diag, a.lower, a.upper), (x,))
    if dev.type == "cpu":
        return bt_matvec_plain(a, x)
    y = torch.empty_like(x)
    if n == 0:
        return y
    rc = _launch(
        dev, _lib().aggmg_bt_matvec, bs, a.diag.data_ptr(), a.lower.data_ptr(), a.upper.data_ptr(),
        x.data_ptr(), y.data_ptr(), n,
    )
    _raise_on(rc, "bt_matvec")
    LAUNCHES["bt_matvec"] += 1
    return y


def _check_sweeps(n_sweeps: int) -> None:
    if not 0 <= n_sweeps <= MAX_SWEEPS:
        raise ValueError(f"n_sweeps must be in [0, {MAX_SWEEPS}], got {n_sweeps}")


def _ghost_ops_width(gops, bs: int) -> int:
    """K7's operator ghosts ``(n_ops >= 3, bs, bs, 2 g)``: their ``2 g``."""
    w = gops.shape[-1] if gops.dim() == 4 else 1
    if gops.dim() != 4 or gops.shape[0] < 3 or tuple(gops.shape[1:3]) != (bs, bs) or w % 2:
        raise ValueError(f"ghost operators of shape {tuple(gops.shape)}, expected (3 or 4, {bs}, {bs}, 2 g)")
    return w


def _check_ghosts(ghosts, bs: int, dev: torch.device, reach: int):
    """K7's ghosts ``(gops, gvec)``: ``gops (n_ops >= 3, bs, bs, 2g)`` (ML,
    MU, S^-1; a fourth stream is not read), ``gvec (2, bs, 2g)`` (x, b).
    ``g`` must cover the ``reach`` columns the sweeps (and the residual) see.
    Returns the pointers and ``g`` for the launch; none without ghosts."""
    if ghosts is None:
        return None, None, 0
    gops, gvec = ghosts
    _check_tensors((gops, gvec), bs, dev)
    w = _ghost_ops_width(gops, bs)
    if tuple(gvec.shape) != (2, bs, w):
        raise ValueError(f"ghost vectors of shape {tuple(gvec.shape)}, expected {(2, bs, w)}")
    if w // 2 < reach:
        raise ValueError(f"ghost width {w // 2} is below the {reach} columns the sweeps reach")
    return gops.data_ptr(), gvec.data_ptr(), w // 2


def _outputs(x, n_out: int, out, cols):
    """The output tensors and the columns ``(lo, hi)`` a launch writes: fresh
    tensors and every column, or, with ``cols``, the caller's ``out`` (one
    tensor, or ``(x_out, r_out)`` with the residual), written in place."""
    if cols is None:
        if out is not None:
            raise ValueError("out= goes with cols=")
        return tuple(torch.empty_like(x) for _ in range(n_out)), (0, x.shape[-1])
    if out is None:
        raise ValueError("cols= writes into out=; pass the output tensors")
    outs = out if isinstance(out, tuple) else (out,)
    lo, hi = cols
    if len(outs) != n_out or not 0 <= lo < hi <= x.shape[-1]:
        raise ValueError(f"cols={cols} with {len(outs)} outputs for {n_out}, {x.shape[-1]} columns")
    _check_tensors(outs, x.shape[0], x.device)
    for t in outs:
        if t.shape != x.shape:
            raise ValueError(f"output of shape {tuple(t.shape)}, expected {tuple(x.shape)}")
    return outs, (lo, hi)


def _sweeps(name, plain, ops, x, b, n_steps, residual, ghosts, out, cols, launch_args):
    """The shared wrapper of K1, K2, K5 and K7: checks, then the plain version
    on a CPU tensor or one launch on a CUDA one.  ``ops`` are ML, MU, S^-1
    (and A_D with the residual); ``launch_args(lib)`` gives the C entry point
    and its arguments after ``n``."""
    _check_sweeps(n_steps)
    bs, n, dev = _check(ops, (x, b))
    ghost_args = _check_ghosts(ghosts, bs, dev, n_steps + (1 if residual else 0))
    n_out = 2 if residual else 1
    outs, (lo, hi) = _outputs(x, n_out, out, cols)
    if dev.type == "cpu":
        res = plain()
        if cols is None:
            return res
        for t, r in zip(outs, res if residual else (res,)):
            t[:, lo:hi] = r[:, lo:hi]
        return out
    if n > 0:
        name = name if ghosts is None else name + "_ghost"
        fn, tail = launch_args(_lib())
        rc = _launch(
            dev, fn, bs, ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            ops[3].data_ptr() if residual else None, x.data_ptr(), b.data_ptr(), *ghost_args,
            outs[0].data_ptr(), outs[1].data_ptr() if residual else None, n, lo, hi, *tail,
        )
        _raise_on(rc, name)
        LAUNCHES[name] += 1
    if cols is not None:
        return out
    return outs if residual else outs[0]


def _damped(n_sweeps, alpha):
    return lambda lib: (lib.aggmg_multisweep, (n_sweeps, alpha))


def multisweep(
    ml, mu, s_inv, x, b, n_sweeps: int = 3, alpha: float = 2.0 / 3.0, ghosts=None, out=None, cols=None
):
    """K2: ``n_sweeps`` damped block-Jacobi sweeps in one pass (M-form).
    With ``ghosts`` K7 (see the module docstring); ``cols=(lo, hi)`` writes
    only those output columns, into ``out`` in place (the sharded path's
    edge strips)."""
    return _sweeps(
        "multisweep", lambda: multisweep_plain(ml, mu, s_inv, x, b, n_sweeps, alpha, ghosts),
        (ml, mu, s_inv), x, b, n_sweeps, False, ghosts, out, cols, _damped(n_sweeps, alpha),
    )


def multisweep_residual(
    ml, mu, s_inv, a_diag, x, b, n_sweeps: int = 3, alpha: float = 2.0 / 3.0, ghosts=None, out=None,
    cols=None,
):
    """K1: K2 plus the residual ``r = b - A x`` of the smoothed ``x``, from the
    same pass; returns ``(x, r)``.  ``ghosts``, ``out=(x_out, r_out)`` and
    ``cols`` as for :func:`multisweep`."""
    return _sweeps(
        "multisweep_residual",
        lambda: multisweep_residual_plain(ml, mu, s_inv, a_diag, x, b, n_sweeps, alpha, ghosts),
        (ml, mu, s_inv, a_diag), x, b, n_sweeps, True, ghosts, out, cols, _damped(n_sweeps, alpha),
    )


def _coef_rows(coef) -> list:
    rows = [(float(c_d), float(c_z)) for c_d, c_z in coef]
    _check_sweeps(len(rows))
    return rows


def _chebyshev(rows):
    """K5's coefficient table, passed to the kernel by value as host floats."""
    table = (ctypes.c_float * (2 * MAX_SWEEPS))(*[v for row in rows for v in row])
    return lambda lib: (lib.aggmg_chebyshev, (len(rows), ctypes.cast(table, ctypes.c_void_p)))


def chebyshev_multisweep(ml, mu, s_inv, x, b, coef, ghosts=None, out=None, cols=None):
    """K5: ``len(coef)`` Chebyshev steps over block-Jacobi in one pass
    (M-form); ``coef`` rows are ``(c_d, c_z)`` from :func:`chebyshev_coefficients`.
    ``ghosts``, ``out`` and ``cols`` as for :func:`multisweep`."""
    rows = _coef_rows(coef)
    return _sweeps(
        "chebyshev_multisweep", lambda: chebyshev_multisweep_plain(ml, mu, s_inv, x, b, rows, ghosts),
        (ml, mu, s_inv), x, b, len(rows), False, ghosts, out, cols, _chebyshev(rows),
    )


def chebyshev_multisweep_residual(ml, mu, s_inv, a_diag, x, b, coef, ghosts=None, out=None, cols=None):
    """K5 plus the residual ``r = b - A x`` of the smoothed ``x``, from the
    same pass; returns ``(x, r)``.  ``ghosts``, ``out`` and ``cols`` as for
    :func:`multisweep_residual`."""
    rows = _coef_rows(coef)
    return _sweeps(
        "chebyshev_multisweep_residual",
        lambda: chebyshev_multisweep_residual_plain(ml, mu, s_inv, a_diag, x, b, rows, ghosts),
        (ml, mu, s_inv, a_diag), x, b, len(rows), True, ghosts, out, cols, _chebyshev(rows),
    )


class EdgePlan:
    """One sharded level's edge pair: its operators bound once, its messages
    allocated once, so a smoothing costs one packing launch and one edge-pair
    launch with next to no host work between them.

    Built once per level (``parallel.distributed.attach_operator_ghosts``)
    from ML, MU, S^-1, A_D ``(bs, bs, n)`` and K7's operator ghosts ``gops
    (3, bs, bs, 2 g)``, which are checked here and never again (float32,
    contiguous, one device, shapes, a block size the kernels have).
    ``left`` / ``right`` say whether the shard has a ring neighbour on that
    side; for each it has, the plan owns a send message ``to_*`` and a
    receive message ``from_*``, both ``(2, bs, g)`` (x's then b's edge
    columns) on the operators' device.  A side without a neighbour has
    neither: the kernel gets a null pointer and takes those columns as the
    zero Dirichlet boundary.

    Per smoothing the caller runs :meth:`pack`, moves ``to_left`` /
    ``to_right`` into the neighbours' ``from_right`` / ``from_left`` (the
    ring exchange, ``parallel.halo.RingExchange``), launches the zero-ghost
    full-shard pass, and hands its output to :meth:`sweep_edges` or
    :meth:`chebyshev_edges`.  Those check only x, b and the outputs (dtype,
    device, shape, contiguity) and the step count against ``g``.

    On a CUDA device every method launches its kernel or raises; on the CPU
    it runs the plain versions.  The messages live across calls: the caller
    must not :meth:`pack` again before the exchange that reads ``to_*`` is
    done (``RingExchange.wait``)."""

    ring = None  # the level's RingExchange, set by parallel.sharded_kernels.edge_plan

    def __init__(self, ml, mu, s_inv, a_diag, gops, *, left: bool, right: bool):
        bs, n, dev = _check((ml, mu, s_inv, a_diag), ())
        _check_tensors((gops,), bs, dev)
        self.g = _ghost_ops_width(gops, bs) // 2
        if not 0 < self.g <= n:
            raise ValueError(f"{self.g} ghost columns a side for a shard of {n} columns")
        self.ops, self.gops = (ml, mu, s_inv, a_diag), gops
        self.bs, self.n, self.device = bs, n, dev

        def message(has_peer):
            return torch.zeros((2, bs, self.g), dtype=torch.float32, device=dev) if has_peer else None

        self.to_left, self.from_left = message(left), message(left)
        self.to_right, self.from_right = message(right), message(right)
        self._tables = {}  # Chebyshev coefficient rows -> the host table the launch passes by value
        if dev.type == "cuda":
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            self._lib = _lib()  # builds at setup, not inside the first smoothing
            self._op_ptrs = tuple(ptr(t) for t in (*self.ops[:3], gops, self.from_left, self.from_right))
            self._ad_ptr = a_diag.data_ptr()
            self._send_ptrs = (ptr(self.to_left), ptr(self.to_right))

    def bound_to(self, ml, mu, s_inv, a_diag, gops) -> bool:
        """Whether the plan was built from these very tensors."""
        return all(t is mine for t, mine in zip((ml, mu, s_inv, a_diag, gops), (*self.ops, self.gops)))

    def _check_vectors(self, tensors) -> None:
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"the block kernels take float32 only, got {t.dtype}")
            if t.device != self.device:
                raise ValueError(f"all inputs must be on one device ({self.device} and {t.device})")
            if t.shape != (self.bs, self.n):
                raise ValueError(f"vector of shape {tuple(t.shape)}, expected {(self.bs, self.n)}")
            if not t.is_contiguous():
                raise ValueError("the block kernels take contiguous tensors")

    def pack(self, x, b) -> None:
        """Fill ``to_left`` / ``to_right`` with the shard's edge columns of x
        and b: one launch; nothing where the shard has no neighbour."""
        self._check_vectors((x, b))
        if self.to_left is None and self.to_right is None:
            return
        if self.device.type == "cpu":
            for dst, src in zip((self.to_left, self.to_right),
                                pack_edges_plain(x, b, self.g, self.to_left is not None, self.to_right is not None)):
                if dst is not None:
                    dst.copy_(src)
            return
        rc = _launch(
            self.device, self._lib.aggmg_pack_edges, self.bs, x.data_ptr(), b.data_ptr(), *self._send_ptrs,
            self.g, self.n,
        )
        _raise_on(rc, "pack_edges")
        LAUNCHES["pack_edges"] += 1

    def _edges(self, name, fn, plain, x, b, out, n_steps: int, tail: tuple):
        """The shared body of the two edge-pair methods: checks, then
        ``plain(ops, ghosts)`` on a CPU tensor or one launch of ``fn`` (whose
        arguments after ``n_steps`` are ``tail``) on a CUDA one."""
        residual = isinstance(out, tuple)
        outs = out if residual else (out,)
        if len(outs) != (2 if residual else 1):
            raise ValueError(f"{len(outs)} outputs: x_out, or (x_out, r_out) with the residual")
        self._check_vectors((x, b, *outs))
        _check_sweeps(n_steps)
        s, reach = n_steps + 1, n_steps + (1 if residual else 0)
        if reach > self.g:
            raise ValueError(f"ghost width {self.g} is below the {reach} columns the sweeps reach")
        if self.n < 2 * s:
            raise ValueError(f"a shard of {self.n} columns is narrower than two {s}-column edges")
        if self.device.type == "cpu":
            res = plain(self.ops if residual else self.ops[:3], (self.gops, self.from_left, self.from_right))
            for i, t in enumerate(outs):
                t[:, :s] = res[2 * i]
                t[:, self.n - s :] = res[2 * i + 1]
            return out
        p = self._op_ptrs
        rc = _launch(
            self.device, fn, self.bs, p[0], p[1], p[2], self._ad_ptr if residual else None, x.data_ptr(),
            b.data_ptr(), p[3], p[4], p[5], self.g, outs[0].data_ptr(),
            outs[1].data_ptr() if residual else None, self.n, n_steps, *tail,
        )
        name += "_residual" if residual else ""
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        return out

    def sweep_edges(self, x, b, out, n_sweeps: int = 3, alpha: float = 2.0 / 3.0):
        """Recompute the ``s = n_sweeps + 1`` first and last columns of a
        zero-ghost K2 pass ``out`` (or, with ``out = (x_out, r_out)``, of a K1
        pass) with the neighbours' columns, in place: one launch.  The vector
        ghosts are ``from_left`` / ``from_right`` as the exchange left them.
        Needs ``n >= 2 s``.  Returns ``out``."""
        return self._edges(
            "edge_pair", self._lib.aggmg_edge_pair if self.device.type == "cuda" else None,
            lambda ops, ghosts: (multisweep_residual_edges_plain if len(ops) == 4 else multisweep_edges_plain)(
                *ops, x, b, *ghosts, n_sweeps, alpha),
            x, b, out, n_sweeps, (alpha,),
        )

    def chebyshev_edges(self, x, b, out, coef):
        """:meth:`sweep_edges` for a zero-ghost K5 pass: ``len(coef)``
        Chebyshev steps, ``coef`` rows ``(c_d, c_z)``."""
        try:
            cached = self._tables.get(coef)  # a tuple of float rows is its own key
        except TypeError:  # unhashable rows (a list, an array)
            cached = None
        if cached is None:
            rows = tuple((float(c_d), float(c_z)) for c_d, c_z in coef)
            _check_sweeps(len(rows))
            flat = (ctypes.c_float * (2 * MAX_SWEEPS))(*[v for row in rows for v in row])
            cached = self._tables[rows] = (rows, flat, ctypes.cast(flat, ctypes.c_void_p))
        rows, _, table = cached
        return self._edges(
            "chebyshev_edge_pair",
            self._lib.aggmg_edge_pair_chebyshev if self.device.type == "cuda" else None,
            lambda ops, ghosts: (chebyshev_multisweep_residual_edges_plain if len(ops) == 4
                                 else chebyshev_multisweep_edges_plain)(*ops, x, b, rows, *ghosts),
            x, b, out, len(rows), (table,),
        )

    def ghost_vectors(self) -> torch.Tensor:
        """K7's ``gvec (2, bs, 2 g)`` from the received messages (zeros at a
        ring end), for the whole-shard ghosted launch of a narrow shard."""
        zeros = torch.zeros((2, self.bs, self.g), dtype=torch.float32, device=self.device)
        return torch.cat(
            [zeros if self.from_left is None else self.from_left,
             zeros if self.from_right is None else self.from_right], dim=-1,
        )


def launch_floor() -> None:
    """Launch one empty kernel on the current stream, through the route every
    kernel here takes (ctypes into the built library): what a launch costs at
    the least.  The edge pair and the packing are measured against it."""
    _raise_on(_launch(torch.device("cuda", torch.cuda.current_device()), _lib().aggmg_empty), "empty")


def block_jacobi_sweep(a: BlockTridiag, s_inv, x, b, alpha: float = 2.0 / 3.0):
    """K8: one damped block-Jacobi sweep ``x + alpha S^-1 (b - A x)`` in one
    pass over the four operator streams (A-form: ``s_inv`` need not be the
    exact inverse of ``a.diag``)."""
    bs, n, dev = _check((a.diag, a.lower, a.upper, s_inv), (x, b))
    if dev.type == "cpu":
        return block_jacobi_sweep_plain(a, s_inv, x, b, alpha)
    x_out = torch.empty_like(x)
    if n == 0:
        return x_out
    rc = _launch(
        dev, _lib().aggmg_block_jacobi_sweep, bs, a.diag.data_ptr(), a.lower.data_ptr(), a.upper.data_ptr(),
        s_inv.data_ptr(), x.data_ptr(), b.data_ptr(), x_out.data_ptr(), n, alpha,
    )
    _raise_on(rc, "block_jacobi_sweep")
    LAUNCHES["block_jacobi_sweep"] += 1
    return x_out


def stream_kernel(ml, mu, s_inv, x, b):
    """K4: read the multisweep's operands once, write one vector (see
    :func:`stream_kernel_plain`); the achievable-bandwidth yardstick that K1,
    K2, K5 and K7 are priced against."""
    bs, n, dev = _check((ml, mu, s_inv), (x, b))
    if dev.type == "cpu":
        return stream_kernel_plain(ml, mu, s_inv, x, b)
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = _launch(
        dev, _lib().aggmg_stream, bs, ml.data_ptr(), mu.data_ptr(), s_inv.data_ptr(), x.data_ptr(),
        b.data_ptr(), out.data_ptr(), n,
    )
    _raise_on(rc, "stream_kernel")
    LAUNCHES["stream_kernel"] += 1
    return out


_GEMV_DTYPES = {torch.float32: 0, torch.float64: 1}


def _gemv(name: str, plain, blocks: torch.Tensor, v: torch.Tensor, shapes: tuple, sizes: tuple, out_shape: tuple,
          n: int, *args) -> torch.Tensor:
    """A block contraction: its operands checked (float32 or float64, one
    dtype and device, ``blocks`` and ``v`` of ``shapes``, on CUDA block
    ``sizes`` the kernels have), then ``plain(blocks, v)`` on the CPU, or on
    CUDA one launch of ``aggmg_<name>(f64, *sizes, blocks, its strides, v,
    its strides, out, *args)`` over ``n`` columns."""
    if v.dtype not in _GEMV_DTYPES or blocks.dtype != v.dtype:
        raise TypeError(f"the block contractions take float32 or float64 of one dtype, got {blocks.dtype} "
                        f"and {v.dtype}")
    if blocks.device != v.device:
        raise ValueError(f"all inputs must be on one device ({blocks.device} and {v.device})")
    if (tuple(blocks.shape), tuple(v.shape)) != shapes:
        raise ValueError(f"operands of shapes {tuple(blocks.shape)} and {tuple(v.shape)}, expected {shapes}")
    if v.device.type == "cpu":
        return plain(blocks, v)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if any(bs not in SUPPORTED_BLOCK_SIZES for bs in sizes):
        raise ValueError(f"block sizes {sizes} have no kernel (supported: {SUPPORTED_BLOCK_SIZES})")
    out = torch.empty(out_shape, dtype=v.dtype, device=v.device)
    if n > 0:
        rc = _launch(v.device, getattr(_lib(), "aggmg_" + name), _GEMV_DTYPES[v.dtype], *sizes, blocks.data_ptr(),
                     *blocks.stride(), v.data_ptr(), *v.stride(), out.data_ptr(), *args)
        _raise_on(rc, name)
        LAUNCHES[name] += 1
    return out


def bd_gemv(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[:, k] = blocks[:, :, k] @ x[:, k]`` (``(bs, bs, n)``, ``(bs, n)``,
    at any strides): on CUDA one launch of ``bd_gemv_kernel``, on the CPU
    :func:`bd_gemv_plain`, whose rounding the kernel has."""
    bs, n = blocks.shape[0], blocks.shape[-1]
    return _gemv("bd_gemv", bd_gemv_plain, blocks, x, ((bs, bs, n), (bs, n)), (bs,), (bs, n), n, n)


def bp_prolong_gemv(blocks: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """The block prolongation ``(bs_c, n_c) -> (bs_f, r n_c)``: fine column
    ``r c + j`` is ``blocks[j, :, :, c] @ xc[:, c]`` (``blocks`` ``(r, bs_f,
    bs_c, n_c)``, at any strides, an expanded r = 1 block too).  On CUDA one
    launch of ``bp_prolong_gemv_kernel``, which writes the fine columns in
    place of the einsum's permuted copy; on the CPU
    :func:`bp_prolong_gemv_plain`, whose rounding the kernel has."""
    r, bs_f, bs_c, n_c = blocks.shape
    return _gemv("bp_prolong_gemv", bp_prolong_gemv_plain, blocks, xc, (tuple(blocks.shape), (bs_c, n_c)),
                 (bs_f, bs_c), (bs_f, r * n_c), n_c, r, n_c)


def bp_restrict_gemv(blocks: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """The block restriction ``L^T rf``, ``(bs_f, r n_c) -> (bs_c, n_c)``:
    on CUDA one launch of ``bp_restrict_gemv_kernel`` (each thread reads its
    coarse column's r fine columns), on the CPU
    :func:`bp_restrict_gemv_plain`, whose rounding the kernel has."""
    r, bs_f, bs_c, n_c = blocks.shape
    return _gemv("bp_restrict_gemv", bp_restrict_gemv_plain, blocks, rf, (tuple(blocks.shape), (bs_f, r * n_c)),
                 (bs_f, bs_c), (bs_c, n_c), n_c, r, n_c)


def _ff_stencil(name, blocks, x_hi, x_lo, b_hi, b_lo, col0, n_total, ghost_left, ghost_right):
    if x_hi.dim() != 2:
        raise ValueError(f"vector of shape {tuple(x_hi.shape)}, expected (bs, n)")
    bs, n = x_hi.shape
    if blocks.dim() != 5 or tuple(blocks.shape[:4]) != (2, 3, bs, bs) or blocks.shape[-1] % 2 != 1:
        raise ValueError(
            f"packed stencil of shape {tuple(blocks.shape)}, expected (2, 3, {bs}, {bs}, 2 bw + 1)"
        )
    dev = x_hi.device
    ghosts = [t for t in (ghost_left, ghost_right) if t is not None]
    _check_tensors((blocks, x_hi, x_lo, b_hi, b_lo, *ghosts), bs, dev)
    for v in (x_lo, b_hi, b_lo):
        if v.shape != x_hi.shape:
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected {tuple(x_hi.shape)}")
    for t in ghosts:
        if tuple(t.shape) != (2, bs):
            raise ValueError(f"ghost column of shape {tuple(t.shape)}, expected (2, {bs}): hi, then lo")
    bw = (blocks.shape[-1] - 1) // 2
    if bw > 0 and n_total < 2 * bw + 2:
        raise ValueError(f"{n_total} columns do not hold the {bw}-column boundary windows")
    if col0 < 0 or col0 + n > n_total:
        raise ValueError(f"columns [{col0}, {col0 + n}) are not within the {n_total} of the array")
    if dev.type == "cpu":
        return ff_stencil_mid_defect_plain(blocks, x_hi, x_lo, b_hi, b_lo, col0, n_total, ghost_left, ghost_right)
    r_hi, r_lo = torch.empty_like(x_hi), torch.empty_like(x_lo)
    if n == 0:
        return r_hi, r_lo
    rc = _launch(
        dev, _lib().aggmg_ff_stencil_defect, bs, blocks.data_ptr(), bw, x_hi.data_ptr(), x_lo.data_ptr(),
        b_hi.data_ptr(), b_lo.data_ptr(), r_hi.data_ptr(), r_lo.data_ptr(), n, col0, n_total,
        None if ghost_left is None else ghost_left.data_ptr(),
        None if ghost_right is None else ghost_right.data_ptr(),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return r_hi, r_lo


def ff_stencil_mid_defect(blocks, x_hi, x_lo, b_hi, b_lo):
    """K6: the float-float stencil defect ``r = b - A x`` of
    :func:`ff_stencil_mid_defect_plain` (interior pass and boundary columns)
    in one launch; returns ``(r_hi, r_lo)``.  The kernel equals the plain
    version bit for bit."""
    return _ff_stencil("ff_stencil_mid_defect", blocks, x_hi, x_lo, b_hi, b_lo, 0, x_hi.shape[-1], None, None)


def ff_stencil_shard_defect(blocks, x_hi, x_lo, b_hi, b_lo, col0: int, n_total: int,
                            ghost_left=None, ghost_right=None):
    """K6s: K6 on one shard of an element-sharded vector, the columns
    ``[col0, col0 + n)`` of ``n_total``, with the neighbours' edge columns of
    x as ``ghost_left`` / ``ghost_right`` (``(2, bs)`` float32, hi then lo;
    None at a ring end reads zero); one launch, counted under its own name.
    Equal bit for bit to the plain version and to the same columns of K6 on
    the whole array."""
    return _ff_stencil("ff_stencil_shard_defect", blocks, x_hi, x_lo, b_hi, b_lo, col0, n_total,
                       ghost_left, ghost_right)


def ff_bt_defect(a, x_hi, x_lo, b_hi, b_lo, ghost_left=None, ghost_right=None):
    """K12: the float-float defect ``r = b - A x`` of the materialised
    block-tridiagonal operator ``a`` (``ops.df64.BlockTridiagFF``: its six
    ``(bs, bs, n)`` float32 streams) in one launch; ``x`` and ``b`` as
    ``(bs, n)`` hi / lo parts; every operand at any strides, ``r`` in
    ``b``'s layout (as the plain chain leaves it).  ``ghost_left`` /
    ``ghost_right`` are the neighbours' edge columns of x past the two ends
    (``(2, bs)`` contiguous, hi then lo; None reads zero).  Returns ``(r_hi,
    r_lo)``, equal bit for bit to :func:`ff_bt_defect_plain`, which a CPU
    tensor runs."""
    if x_hi.dim() != 2:
        raise ValueError(f"vector of shape {tuple(x_hi.shape)}, expected (bs, n)")
    bs, n = x_hi.shape
    dev = x_hi.device
    streams = (a.hi.diag, a.hi.lower, a.hi.upper, a.lo.diag, a.lo.lower, a.lo.upper)
    vecs = (x_hi, x_lo, b_hi, b_lo)
    ghosts = [t for t in (ghost_left, ghost_right) if t is not None]
    _check_tensors(ghosts, bs, dev)
    _check_tensors((*streams, *vecs), bs, dev, contiguous=False)
    for m in streams:
        if tuple(m.shape) != (bs, bs, n):
            raise ValueError(f"operator stream of shape {tuple(m.shape)}, expected {(bs, bs, n)}")
    for v in vecs[1:]:
        if v.shape != x_hi.shape:
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected {tuple(x_hi.shape)}")
    for t in ghosts:
        if tuple(t.shape) != (2, bs):
            raise ValueError(f"ghost column of shape {tuple(t.shape)}, expected (2, {bs}): hi, then lo")
    if dev.type == "cpu":
        return ff_bt_defect_plain(a, x_hi, x_lo, b_hi, b_lo, ghost_left, ghost_right)
    r_hi, r_lo = torch.empty_like(b_hi), torch.empty_like(b_lo)
    if n == 0:
        return r_hi, r_lo
    arrays = (*streams, *vecs, r_hi, r_lo)
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in arrays))
    strides = (ctypes.c_longlong * 30)(*(st for t in arrays for st in t.stride()))
    rc = _launch(
        dev, _lib().aggmg_ff_bt_defect, bs, ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        n, None if ghost_left is None else ghost_left.data_ptr(),
        None if ghost_right is None else ghost_right.data_ptr(),
    )
    _raise_on(rc, "ff_bt_defect")
    LAUNCHES["ff_bt_defect"] += 1
    return r_hi, r_lo


def ff_cg_defect(band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, halo_left=None, halo_right=None):
    """K13: the float-float defect ``r = b - A x`` of the CG band ``(band_hi,
    band_lo)`` (``ops.df64.CgBandFF``'s two ``(2p + 1, n)`` float32 parts)
    in one launch; ``x`` and ``b`` as ``(n,)`` hi / lo parts; every operand
    at any strides, ``r`` in ``b``'s layout.  ``halo_left`` /
    ``halo_right`` are the p nodes past x's two ends (each a ``(hi, lo)``
    pair of ``(p,)`` tensors: a shard's neighbours' nodes; None reads zero).
    Any order p launches.  Returns ``(r_hi, r_lo)``, equal bit for bit to
    :func:`ff_cg_defect_plain`, which a CPU tensor runs."""
    if band_hi.dim() != 2 or band_hi.shape[0] % 2 != 1:
        raise ValueError(f"band of shape {tuple(band_hi.shape)}, expected (2p + 1, n)")
    rows, n = band_hi.shape
    p = rows // 2
    dev = x_hi.device
    halo = [t for h in (halo_left, halo_right) if h is not None for t in h]
    _check_tensors((band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, *halo), None, dev, contiguous=False)
    if band_lo.shape != band_hi.shape:
        raise ValueError(f"band parts of shapes {tuple(band_hi.shape)} and {tuple(band_lo.shape)}")
    for v in (x_hi, x_lo, b_hi, b_lo):
        if tuple(v.shape) != (n,):
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected ({n},)")
    for h in (halo_left, halo_right):
        if h is not None and (len(h) != 2 or any(tuple(t.shape) != (p,) for t in h)):
            raise ValueError(f"a halo side is a (hi, lo) pair of ({p},) tensors")
    if dev.type == "cpu":
        return ff_cg_defect_plain(band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, halo_left, halo_right)
    r_hi, r_lo = torch.empty_like(b_hi), torch.empty_like(b_lo)
    if n == 0:
        return r_hi, r_lo
    sides = [(None, None) if h is None else tuple(h) for h in (halo_left, halo_right)]
    arrays = (band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, r_hi, r_lo)
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in arrays),
                                  *(None if t is None else t.data_ptr() for side in sides for t in side))
    strides = (ctypes.c_longlong * 14)(*(st for t in arrays for st in t.stride()),
                                       *(0 if t is None else t.stride(0) for side in sides for t in side))
    rc = _launch(dev, _lib().aggmg_ff_cg_defect, p, ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(strides, ctypes.c_void_p), n)
    _raise_on(rc, "ff_cg_defect")
    LAUNCHES["ff_cg_defect"] += 1
    return r_hi, r_lo


def ff_cheb_update(s_inv, r_hi, u_hi, u_lo, d=None, *, theta=None, coef=None, keep_d=True):
    """K14: one step of the true cycle's Chebyshev smoothing on a
    block-Jacobi level, after the step's float-float defect: ``z = S^-1
    r_hi``, ``d = z / theta`` on the first step (``d`` None), else ``d = c_d d
    + c_z z`` (``coef = (c_d, c_z)``), then ``u = ff_add(u, (d, 0))``.
    ``s_inv`` is ``(bs, bs, n)``, the vectors ``(bs, n)``, every operand at
    any strides; the scalars are host floats (the level's
    :func:`chebyshev_theta` and :func:`chebyshev_coefficients` row).  On CUDA
    one launch, which writes fresh outputs (d not on the last step, where
    ``keep_d`` is False); on the CPU :func:`ff_cheb_update_plain`.  Returns
    ``(u_hi, u_lo, d)``, equal bit for bit to the plain version."""
    if r_hi.dim() != 2:
        raise ValueError(f"vector of shape {tuple(r_hi.shape)}, expected (bs, n)")
    bs, n = r_hi.shape
    dev = r_hi.device
    if d is None and theta is None:
        raise ValueError("the first step (d None) divides by theta")
    if d is not None and (coef is None or len(coef) != 2):
        raise ValueError("a later step takes coef = (c_d, c_z)")
    vecs = (r_hi, u_hi, u_lo) + (() if d is None else (d,))
    _check_tensors((s_inv, *vecs), bs, dev, contiguous=False)
    if tuple(s_inv.shape) != (bs, bs, n):
        raise ValueError(f"S^-1 of shape {tuple(s_inv.shape)}, expected {(bs, bs, n)}")
    for v in vecs[1:]:
        if v.shape != r_hi.shape:
            raise ValueError(f"vector of shape {tuple(v.shape)}, expected {tuple(r_hi.shape)}")
    if dev.type == "cpu":
        return ff_cheb_update_plain(s_inv, r_hi, u_hi, u_lo, d, theta=theta, coef=coef, keep_d=keep_d)
    o_hi, o_lo = torch.empty_like(u_hi), torch.empty_like(u_lo)
    d_out = torch.empty_like(u_hi) if keep_d else None
    if n == 0:
        return o_hi, o_lo, d_out
    c_d, c_z = (0.0, 0.0) if d is None else coef
    vectors = (r_hi, d, u_hi, u_lo, d_out, o_hi, o_lo)
    ptrs = (ctypes.c_void_p * 8)(s_inv.data_ptr(), *(None if t is None else t.data_ptr() for t in vectors))
    strides = (ctypes.c_longlong * 17)(*s_inv.stride(),
                                       *(st for t in vectors for st in ((0, 0) if t is None else t.stride())))
    rc = _launch(dev, _lib().aggmg_ff_cheb_update, bs, ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(strides, ctypes.c_void_p), n, 0.0 if theta is None else float(theta), float(c_d),
                 float(c_z))
    _raise_on(rc, "ff_cheb_update")
    LAUNCHES["ff_cheb_update"] += 1
    return o_hi, o_lo, d_out
