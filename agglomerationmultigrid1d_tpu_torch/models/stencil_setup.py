"""Stencil-inflated hierarchy setup: O(1)-per-level host work at any size.

On a uniform mesh every operator of these hierarchies is *translation
invariant away from the domain boundary*: the volume terms depend only on
the (constant) jacobian, the flux and penalty couplings only on c_dir and the
element width, and each Galerkin projection of a constant-interior operator
through a constant-interior transfer is again constant-interior.  On CG
levels the node-axis arrays (bands, Jacobi diagonals, Schwarz
multiplicities, the seam's lumped mass) are periodic with the level's order
p instead.

So the hierarchy is built ONCE on the host, in float64, at a small *stencil
size* ``n0 = n / z`` (the same element width ``h = L / n``, c_dir and
coarsening plan, so every block value equals the full-size build's away from
the boundary); per-level stencils are extracted (``bw`` boundary columns each
side and one interior column, or one period of p nodes) and **inflated** to
full size on the target device as broadcasts and concatenations.  The only
O(n) work, the right-hand side, is computed on the target device in float64
(:func:`_uniform_dg_b`, :func:`_uniform_cg_b`).

Level sizes scale uniformly by ``z``, so the real coarsest level has
``z * n0_coarsest`` blocks and is solved by block cyclic reduction
(``ops.coarse_solve``).  Chebyshev bounds come from the stencil-size
hierarchy (50 power steps, safety 1.1), as in the JAX package.

The counterpart of ``agglomerationmultigrid1d_tpu/models/stencil_setup.py``,
for DG-topped and CG-topped chains.  Ragged agglomerates and penta-diagonal
(mixed-switch) levels are position dependent and refused.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..mesh.topology import BoundaryCondition, Mesh1D
from ..ops.block_tridiag import BlockTridiag
from ..ops.cg_operator import CgOperator
from ..ops.transfer_ops import BlockProlong, CgProlong, RaggedBlockProlong, SeamProlong
from ..smoothers.smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    JacobiSmoother,
    SchwarzSmoother,
)
from ..utils.config import HierarchySpec
from ..utils.precision import hierarchy_astype, tree_to
from ..utils.profiling import span
from .hierarchy import BlockLevel, CgLevel, Hierarchy

# stencil extraction width, in elements (blocks).  Boundary influence never
# exceeds 2 blocks: the fine Schur product A = C - D M^-1 G reaches blocks
# 0..1, and every r >= 2 Galerkin projection maps a boundary-affected width w
# to ceil((w + 1) / r) <= w.
_BW = 4


class _Stencil(NamedTuple):
    left: np.ndarray  # (..., bw), or (..., bw * p + 1) on node axes
    mid: np.ndarray  # (..., 1), or (..., p): one period
    right: np.ndarray  # (..., bw), or (..., bw * p)


def _check_constant(arr: np.ndarray, mid: np.ndarray, what: str, rtol) -> None:
    """The interior columns must all equal the extracted middle.

    float64 inputs carry only the ~1e-16-relative jacobian noise of
    ``np.diff`` on a uniform mesh (rtol 1e-11); float32 inputs also jitter by
    one ulp where a float64 value sits near a rounding edge (rtol 2.4e-7).
    ``rtol=None`` skips the check: the float-float ``lo`` tails jitter by
    exactly the hi part's allowed ulp flip."""
    if rtol is None:
        return
    if rtol == "auto":
        rtol = 2.4e-7 if arr.dtype == np.float32 else 1e-11
    tol = rtol * max(float(np.abs(arr).max()), 1e-300)
    err = float(np.abs(arr - mid).max())
    if err > tol:
        raise ValueError(
            f"{what}: interior is not translation invariant (max deviation "
            f"{err:.3e} vs tol {tol:.3e}); stencil inflation requires a "
            "uniform mesh with uniform partitions"
        )


def _numpy(arr) -> np.ndarray:
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _extract_el(arr, bw: int, what: str, rtol="auto") -> _Stencil:
    """Element-axis stencil: ``arr[..., k]`` constant for bw <= k < n - bw."""
    a = _numpy(arr)
    n = a.shape[-1]
    if n < 2 * bw + 2:
        raise ValueError(f"{what}: need >= {2 * bw + 2} columns, got {n}")
    mid = a[..., n // 2 : n // 2 + 1]
    _check_constant(a[..., bw : n - bw], mid, what, rtol)
    return _Stencil(a[..., :bw].copy(), mid.copy(), a[..., n - bw :].copy())


def _extract_nodes(arr, p: int, bw: int, what: str, rtol="auto") -> _Stencil:
    """Node-axis stencil (length ``p * n_el + 1``): periodic with period p
    away from the first and last bw elements."""
    a = _numpy(arr)
    n_el = (a.shape[-1] - 1) // p
    if a.shape[-1] != p * n_el + 1:
        raise ValueError(f"{what}: length {a.shape[-1]} is not p*n_el+1 for p={p}")
    if n_el < 2 * bw + 2:
        raise ValueError(f"{what}: need >= {2 * bw + 2} elements, got {n_el}")
    mid = a[..., bw * p + 1 : (bw + 1) * p + 1]
    interior = a[..., bw * p + 1 : (n_el - bw) * p + 1]
    k = interior.shape[-1] // p
    tiled = np.broadcast_to(mid[..., None, :], mid.shape[:-1] + (k, p)).reshape(mid.shape[:-1] + (k * p,))
    _check_constant(interior, tiled, what, rtol)
    return _Stencil(a[..., : bw * p + 1].copy(), mid.copy(), a[..., a.shape[-1] - bw * p :].copy())


def _inflate_el(st: _Stencil, n_big: int, device, lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Columns ``[lo, hi)`` (default all) of ``[left | mid * (n_big - 2 bw) |
    right]``, formed on ``device`` without the others."""
    return _inflate_range(st, n_big, lambda m0, m1, mid: mid.expand(*mid.shape[:-1], m1 - m0), device, lo, hi)


def _inflate_nodes(st: _Stencil, n_el_big: int, p: int, bw: int, device, lo: int = 0,
                   hi: int | None = None) -> torch.Tensor:
    """Nodes ``[lo, hi)`` (default all) of the node-axis inflation: the
    ``bw p + 1`` left nodes, the period-``p`` interior, the ``bw p`` right
    nodes."""

    def tile(m0, m1, mid):
        phase = (m0 - (bw * p + 1)) % p  # where [m0, m1) starts in a period
        reps = -(-(phase + m1 - m0) // p)
        tiled = mid[..., None, :].expand(*mid.shape[:-1], reps, p).reshape(*mid.shape[:-1], reps * p)
        return tiled[..., phase : phase + m1 - m0]

    return _inflate_range(st, n_el_big * p + 1, tile, device, lo, hi)


def _inflate_range(st: _Stencil, n_big: int, interior, device, lo: int, hi: int | None) -> torch.Tensor:
    """``[lo, hi)`` of ``[left | interior | right]`` along the last axis;
    ``interior(m0, m1, mid)`` forms the interior's columns ``[m0, m1)``."""
    hi = n_big if hi is None else hi
    left, mid, right = (torch.from_numpy(a).to(device) for a in st)
    bwl, mid_end = left.shape[-1], n_big - right.shape[-1]
    parts = []
    if lo < bwl:
        parts.append(left[..., lo : min(hi, bwl)])
    m0, m1 = max(lo, bwl), min(hi, mid_end)
    if m1 > m0:
        parts.append(interior(m0, m1, mid))
    if hi > mid_end:
        parts.append(right[..., max(lo, mid_end) - mid_end : hi - mid_end])
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Hierarchy planner: walk the containers, collect stencils and a rebuild closure
# ---------------------------------------------------------------------------


class _Plan:
    """Collects stencils while walking the small hierarchy; :meth:`inflate`
    makes the full-size tensors, in collection order, which the rebuild
    closures index.

    With a ``group`` (``parallel.multihost.SolverGroup``) a leaf registered
    while :attr:`sharded` is set inflates to the rank's part only: its
    columns of an element axis (``multihost.local_range``), its nodes of a
    node axis (``multihost.node_range``); the caller sets :attr:`sharded`
    per level (``parallel.multihost.build_sharded_xl_problem``)."""

    def __init__(self, z: int, bw: int, group=None):
        self.z = z
        self.bw = bw
        self.group = group
        self.sharded = False
        self.stencils: list = []  # (_Stencil, spec, (lo, hi)): ("el", n_big) | ("node", n_el_big, p)

    def _range(self, n: int, p: int | None = None) -> tuple:
        from ..parallel.multihost import local_range, node_range

        if not self.sharded:
            return 0, (n if p is None else n * p + 1)
        return local_range(n, self.group) if p is None else node_range(n, p, self.group)

    def el(self, arr, what: str, rtol="auto") -> int:
        """Register an element-axis leaf; returns its slot index."""
        n_big = arr.shape[-1] * self.z
        self.stencils.append((_extract_el(arr, self.bw, what, rtol), ("el", n_big), self._range(n_big)))
        return len(self.stencils) - 1

    def node(self, arr, p: int, what: str, rtol="auto") -> int:
        """Register a node-axis leaf of period ``p``; returns its slot index."""
        n_el_big = (arr.shape[-1] - 1) // p * self.z
        self.stencils.append(
            (_extract_nodes(arr, p, self.bw, what, rtol), ("node", n_el_big, p), self._range(n_el_big, p))
        )
        return len(self.stencils) - 1

    def inflate(self, device) -> tuple:
        return tuple(
            _inflate_el(st, spec[1], device, *rng) if spec[0] == "el"
            else _inflate_nodes(st, spec[1], spec[2], self.bw, device, *rng)
            for st, spec, rng in self.stencils
        )


def _is_empty(t) -> bool:
    return isinstance(t, torch.Tensor) and t.numel() == 0


def _plan_bt(plan: _Plan, a: BlockTridiag, what: str, device, rtol="auto"):
    # slim fine levels carry empty off-diagonals (the smoother's M-form
    # streams hold their action); empties pass through
    def one(t, name):
        return None if _is_empty(t) else plan.el(t, f"{what}.{name}", rtol)

    i, j, k = one(a.lower, "lower"), one(a.diag, "diag"), one(a.upper, "upper")
    e_low = a.lower.to(device) if i is None else None
    e_up = a.upper.to(device) if k is None else None
    return lambda out: BlockTridiag(
        lower=e_low if i is None else out[i], diag=out[j], upper=e_up if k is None else out[k]
    )


def _plan_smoother(plan: _Plan, s, level, what: str, device):
    if isinstance(s, ChebyshevSmoother):
        base_fn = _plan_smoother(plan, s.base, level, what + ".base", device)
        lam_lo, lam_hi = s.lam_lo.to(device), s.lam_hi.to(device)
        return lambda out: ChebyshevSmoother(
            base=base_fn(out), lam_lo=lam_lo, lam_hi=lam_hi, coef=s.coef, theta=s.theta
        )
    if isinstance(s, JacobiSmoother):
        if isinstance(level, CgLevel):
            i = plan.node(s.inv_diag, level.a.p, what + ".inv_diag")
        else:
            i = plan.el(s.inv_diag, what + ".inv_diag")
        return lambda out: JacobiSmoother(inv_diag=out[i])
    if isinstance(s, BlockJacobiSmoother):
        i = plan.el(s.inv, what + ".inv")
        j = None if s.ml is None else plan.el(s.ml, what + ".ml")
        k = None if s.mu is None else plan.el(s.mu, what + ".mu")
        return lambda out: BlockJacobiSmoother(
            inv=out[i], ml=None if j is None else out[j], mu=None if k is None else out[k]
        )
    if isinstance(s, SchwarzSmoother):
        # the multiplicity is node-axis with the windows' own p
        i = plan.el(s.inv_windows, what + ".inv_windows")
        j = None if s.mult_inv is None else plan.node(s.mult_inv, s.p, what + ".mult_inv")
        return lambda out: SchwarzSmoother(inv_windows=out[i], mult_inv=None if j is None else out[j])
    raise TypeError(f"stencil inflation: unsupported smoother {type(s)}")


def _plan_level(plan: _Plan, lv, k: int, device):
    what = f"level[{k}]"
    if isinstance(lv, CgLevel):
        i = plan.el(lv.a.windows, what + ".windows")
        j = plan.node(lv.a.band, lv.a.p, what + ".band")
        s_fn = _plan_smoother(plan, lv.smoother, lv, what + ".smoother", device)
        return lambda out: CgLevel(a=CgOperator(windows=out[i], band=out[j]), smoother=s_fn(out))
    if not isinstance(lv.a, BlockTridiag):
        raise TypeError(
            "stencil inflation supports block-tridiagonal levels only (mixed-switch "
            "pentadiagonal operators are not translation invariant at the flipped vertices)"
        )
    if not all(_is_empty(t) for t in (lv.g.diag, lv.d.diag, lv.c.diag)):
        raise ValueError(
            "strip the hierarchy before inflation (strip_hierarchy): the "
            "construction-only G/D/C operators are not part of the solve path"
        )
    a_fn = _plan_bt(plan, lv.a, what + ".a", device)
    g, d, c, m = (tree_to(t, device) for t in (lv.g, lv.d, lv.c, lv.mass_inv))
    s_fn = _plan_smoother(plan, lv.smoother, lv, what + ".smoother", device)
    return lambda out: BlockLevel(a=a_fn(out), g=g, d=d, c=c, mass_inv=m, smoother=s_fn(out))


def _plan_transfer(plan: _Plan, t, k: int, device, cols: bool = False, nodes: bool = False):
    """``cols``: inflate the rank's coarse columns only; ``nodes``: a seam's
    lumped mass at the rank's nodes of its CG level only."""
    what = f"transfer[{k}]"
    if isinstance(t, CgProlong):
        t = tree_to(t, device)
        return lambda out: t
    plan.sharded = cols
    if isinstance(t, BlockProlong):
        i = plan.el(t.blocks, what + ".blocks")
        return lambda out: BlockProlong(blocks=out[i])
    if isinstance(t, SeamProlong):
        if t.offsets is not None:
            raise ValueError("stencil inflation requires uniform seam partitions")
        # the lumped mass is node-axis with the CG level's p, not the coarse level's
        i = plan.el(t.n_win, what + ".n_win")
        plan.sharded = nodes
        j = plan.node(t.inv_lump, t.w_cg - 1, what + ".inv_lump")
        return lambda out: SeamProlong(n_win=out[i], inv_lump=out[j])
    if isinstance(t, RaggedBlockProlong):
        raise ValueError(
            "stencil inflation requires uniform partitions (RaggedBlockProlong "
            "transfers are position dependent); use the host build path"
        )
    raise TypeError(type(t))


def _inflate_bt_host(a: BlockTridiag, z: int, bw: int, what: str) -> BlockTridiag:
    """Full-size BlockTridiag on the host (for the coarse factorization: the
    coarsest level is small, ``z * n0_coarsest`` blocks)."""

    def one(t, name):
        return _inflate_el(_extract_el(t, bw, f"{what}.{name}"), t.shape[-1] * z, "cpu")

    return BlockTridiag(lower=one(a.lower, "lower"), diag=one(a.diag, "diag"), upper=one(a.upper, "upper"))


def _coarse_factor(a_small: BlockTridiag, z: int, bw: int, what: str, device):
    """The float64 factorization of the inflated coarsest operator, on ``device``."""
    from .hierarchy import _coarse_lu

    a_big = _inflate_bt_host(a_small, z, bw, what)
    lv = BlockLevel(a=a_big, g=None, d=None, c=None, mass_inv=None, smoother=None)
    return tree_to(_coarse_lu(lv), device)


def inflate_hierarchy(
    h_small: Hierarchy, h_small_f64: Hierarchy, z: int, *, bw: int = _BW, device="cuda", shard=None
) -> Hierarchy:
    """Inflate a stencil-size hierarchy to ``z``-times-larger level sizes.

    ``h_small`` is the stripped (optionally float32 / Chebyshev-wrapped)
    solve-path hierarchy whose tensors are inflated on ``device``;
    ``h_small_f64`` supplies the float64 coarsest operator for the full-size
    coarse factorization (pass ``h_small`` itself for an all-float64
    inflation).  The coarsest level must be block-tridiagonal: its full-size
    operator is factorized on the host (cyclic reduction above
    ``hierarchy.DENSE_COARSE_MAX`` DoF), then cast to ``h_small``'s dtype.

    ``shard = (group, flags)`` inflates only the rank's part of every level
    ``k`` with ``flags[k]`` (``parallel.multihost.build_sharded_xl_problem``),
    as ``parallel.distributed.shard_hierarchy`` would cut the whole level:
    a block transfer by its coarse level's flag, a seam by its CG level's.
    A transfer onto a sharded level whose agglomerates straddle the ranks (a
    coarse count the world does not divide: that level is whole) inflates at
    the coarse level's width, a seam's lumped mass at the rank's nodes, and
    is cut by ``parallel.transfers.shard_transfer``.  The result has no
    layout yet."""
    from ..parallel.distributed import level_size
    from ..parallel.transfers import shard_transfer

    device = torch.device(device)
    group, flags = shard if shard is not None else (None, (False,) * h_small.n_levels)
    plan = _Plan(z, bw, group)
    level_fns, transfer_fns = [], []
    for k, lv in enumerate(h_small.levels):
        plan.sharded = flags[k]
        level_fns.append(_plan_level(plan, lv, k, device))
    for k, t in enumerate(h_small.transfers):
        n_f, n_c = (level_size(lv) * z for lv in h_small.levels[k : k + 2])
        if flags[k] and not isinstance(t, CgProlong) and n_c % group.world:
            fn = _plan_transfer(plan, t, k, device, nodes=True)
            transfer_fns.append(lambda out, fn=fn, n_f=n_f, n_c=n_c: shard_transfer(fn(out), n_f, n_c, False, group))
        else:
            cols = flags[k] if isinstance(t, SeamProlong) else flags[k + 1]
            transfer_fns.append(_plan_transfer(plan, t, k, device, cols=cols, nodes=flags[k]))
    out = plan.inflate(device)
    levels = tuple(fn(out) for fn in level_fns)
    transfers = tuple(fn(out) for fn in transfer_fns)

    coarse_lv = h_small_f64.levels[-1]
    if not (isinstance(coarse_lv, BlockLevel) and isinstance(coarse_lv.a, BlockTridiag)):
        raise TypeError(
            "stencil inflation needs a block-tridiagonal coarsest level (add "
            "agglomeration levels; a CG coarsest level would inflate past the "
            "dense-solve cap)"
        )
    coarse = _coarse_factor(coarse_lv.a, z, bw, "coarse.a", "cpu")
    dtype = levels[0].a.band.dtype if isinstance(levels[0], CgLevel) else levels[0].a.diag.dtype
    coarse = tree_to(hierarchy_astype(coarse, dtype), device)
    return Hierarchy(levels=levels, transfers=transfers, coarse=coarse)


# ---------------------------------------------------------------------------
# Full XL problem builder (stencil build -> inflate -> rhs)
# ---------------------------------------------------------------------------


def _stencil_mesh(n0: int, h: float) -> Mesh1D:
    """A uniform n0-element mesh with EXACTLY the full problem's element
    width (domain [0, n0 h]): operators depend on h, c_dir and the boundary
    kinds only, so every interior value matches the full-size build."""
    return Mesh1D(vertex_x=np.arange(n0 + 1, dtype=np.float64) * h)


def default_stencil_factor(spec: HierarchySpec, n: int, bw: int = _BW) -> int:
    """Largest power-of-two ``z`` keeping every stencil level >= 2 bw + 2
    blocks (the extraction minimum)."""
    sizes = [n] * (len(spec.cg_orders) + len(spec.dg_orders))
    m = n
    for i in range(spec.n_agg_levels):
        m //= spec.first_agg_factor if i == 0 else spec.agg_factor
        sizes.append(m)
    smallest = min(sizes)
    z = 1
    while smallest % (2 * z) == 0 and smallest // (2 * z) >= 2 * bw + 2 and n % (2 * z) == 0:
        z *= 2
    return z


class FFOps(NamedTuple):
    """The value-accurate operator bundle of the TRUE-precision cycle
    (``solvers.v_cycle_true``): per-level float-float operators, per-transfer
    lo tails (``blocks64 - blocks32`` rounded to float32, so a transfer
    applies as ``T_hi r_hi + (T_hi r_lo + T_lo r_hi)``), and the float64
    coarse factorization.

    Once ``eps_f32 * kappa_elem(A) > 1`` (the 1e8-DoF c_dir = 1000 n north
    star sits at ~6) every float32-VALUED operator application in the
    correction cycle injects error the V-cycle amplifies; with float-float
    values throughout it contracts like float64 multigrid."""

    a_ffs: tuple  # per-level float-float operators (a_ffs[0] may be a BTFFStencil)
    t_los: tuple  # per-transfer lo parts (None where a transfer has none)
    coarse64: object  # float64 coarse factorization


def build_xl_problem(
    spec: HierarchySpec,
    n: int,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    *,
    z: int | None = None,
    bw: int = _BW,
    dtype: torch.dtype = torch.float32,
    chebyshev: bool = True,
    slim_fine: bool = False,
    ff_levels: bool = False,
    device="cuda",
    domain: tuple[float, float] = (0.0, 1.0),
    timings: dict | None = None,
):
    """Build the float32 solve-path hierarchy, the float-float fine operator
    and the rhs of a uniform-mesh problem at ANY size, with O(n0) host work.
    The chain may be DG-topped or CG-topped (CG levels with Jacobi or Schwarz
    smoothing, a CG -> DG or CG -> agglomerated seam); its coarsest level
    must be block-tridiagonal.

    Returns ``(h_low, a_ff, b_ff, norm_b)``, as the JAX package's
    ``build_xl_problem``:

    * ``a_ff`` is a :class:`~..ops.df64.BlockTridiagFF` on a DG fine level,
      a :class:`~..ops.df64.CgBandFF` on a CG one: the fine operator of
      ``solvers._mixed_loop_ff``;
    * ``slim_fine=True`` (DG-topped chains only) drops the fine level's
      off-diagonals (the M-form smoother streams carry their action) and
      returns ``a_ff`` as a
      :class:`~..ops.df64.BTFFStencil`, whose defect contracts with the
      stencil blocks (kernel K6 on the card);
    * ``ff_levels=True`` returns an :class:`FFOps` in the ``a_ff`` slot: the
      inputs of ``solvers.multigrid_true``.

    The three setup phases are spans ``aggmg.setup.<phase>``
    (``utils.profiling.span``); ``timings``, a dict, receives their seconds,
    the device drained at each end: ``"host_stencil"`` (the float64
    stencil-size build, the float32 cast and the Chebyshev bounds),
    ``"inflate"`` (the full-size tensors and coarse factorizations on
    ``device``) and ``"rhs"`` (the float64 rhs on ``device``, its norm and
    its float-float split)."""
    from ..ops.df64 import ff_split

    device = torch.device(device)
    with span("aggmg.setup.host_stencil", timings):
        prob0, h64, a_ff_small, h_low0, z, h, xin, func, bc = _stencil_problem(
            spec, n, func, bc, z=z, bw=bw, dtype=dtype, chebyshev=chebyshev, slim_fine=slim_fine, domain=domain
        )

    # 2) inflate the solve hierarchy and the float-float operators on the device
    with span("aggmg.setup.inflate", timings):
        h_low = inflate_hierarchy(h_low0, h64, z, bw=bw, device=device)
        if slim_fine:
            a_ff = _stencil_ff_fine(a_ff_small, n, bw, device)
        else:
            a_ff = _inflate_ff_fine(a_ff_small, h_low.levels[0], z, bw, device)
        if ff_levels:
            a_ffs = (a_ff,) + _inflate_ff_tail(h64, h_low, z, bw, device)
            t_los = _inflate_transfer_los(h64, z, bw, device)
            # the float64 coarse factorization of the progressive cycles
            coarse64 = _coarse_factor(h64.levels[-1].a, z, bw, "coarse64.a", device)
            a_ff = FFOps(a_ffs=a_ffs, t_los=t_los, coarse64=coarse64)

    # 3) the O(n) rhs, in float64 on the device, split to float-float
    with span("aggmg.setup.rhs", timings):
        if spec.cg_orders:
            b = _uniform_cg_b(prob0, n, h, xin, func, bc, device)
        else:
            b = _uniform_dg_b(prob0, n, h, xin, func, bw, device)
        norm_b = float(torch.linalg.vector_norm(b))
        b_ff = ff_split(b)
        del b
    return h_low, a_ff, b_ff, norm_b


class _StencilProblem(NamedTuple):
    prob0: object  # the float64 problem at n0 = n / z elements of the full problem's width
    h64: Hierarchy  # its stripped hierarchy
    a_ff_small: object  # its fine operator split to float-float
    h_low0: Hierarchy  # the solve-path hierarchy at n0: cast, M-form streams, Chebyshev bounds, slim
    z: int
    h: float  # the element width
    xin: float
    func: Callable
    bc: BoundaryCondition


def _stencil_problem(spec, n, func, bc, *, z, bw, dtype, chebyshev, slim_fine, domain, min_z=2) -> _StencilProblem:
    """Step 1 of the stencil build, on the host: the float64 stencil problem
    at ``n0 = n / z`` elements of the REAL width ``h`` (its rhs is discarded,
    apart from the boundary patches) and the solve-path hierarchy made from
    it.  Every rank of a sharded build runs it (cheaper than sending it).
    ``min_z``: the least stencil factor taken (the sharded build takes
    ``z = 1``, the whole problem as its own stencil, as the JAX package's
    does; the whole build does not, as the JAX package's does not)."""
    from .hierarchy import chebyshev_hierarchy, prepare_fast_smoothers, strip_hierarchy
    from .problems import build_problem, default_model_problem

    if z is None:
        z = default_stencil_factor(spec, n, bw)
    if z < min_z or n % z:
        raise ValueError(f"stencil factor z={z} must be >= {min_z} and divide n={n}")
    n0 = n // z
    xin, xout = domain
    h = (xout - xin) / n

    func_, u_ex, ux_ex = default_model_problem()
    func = func or func_
    if bc is None:
        bc = BoundaryCondition(("neu", ux_ex(xin)), ("dir", u_ex(xout)))

    prob0 = build_problem(spec, n0, func, bc, mesh=_stencil_mesh(n0, h), device="cpu")
    h64 = strip_hierarchy(prob0.hierarchy)
    a_ff_small = _ff_split_fine(h64.levels[0])
    h_low0 = hierarchy_astype(h64, dtype)
    if dtype == torch.float32:
        # the float32 fine operator IS the float-float split's hi part
        h_low0 = _share_fine_hi(h_low0, a_ff_small)
        h_low0 = prepare_fast_smoothers(h_low0)
    if chebyshev:
        # lambda_max from the stencil-size spectrum, converged, with a safety
        # margin for its residual size dependence (< 4% between n0 and n)
        h_low0 = chebyshev_hierarchy(h_low0, power_iters=50, safety=1.1)
    if slim_fine:
        if not isinstance(h_low0.levels[0], BlockLevel) or dtype != torch.float32:
            raise ValueError("slim_fine requires a float32 DG-topped chain")
        lv0 = h_low0.levels[0]
        e = torch.zeros((0, 0, 0), dtype=dtype)
        lv0 = lv0._replace(a=BlockTridiag(lower=e, diag=lv0.a.diag, upper=e))
        h_low0 = h_low0._replace(levels=(lv0,) + h_low0.levels[1:])
    return _StencilProblem(prob0, h64, a_ff_small, h_low0, z, h, xin, func, bc)


def _ff_split_fine(fine64):
    from ..ops.df64 import bt_split, cg_band_split

    if isinstance(fine64, CgLevel):
        return cg_band_split(fine64.a.band)
    return bt_split(fine64.a)


def _share_fine_hi(h_low: Hierarchy, a_ff_small) -> Hierarchy:
    """Point the float32 hierarchy's fine operator at the float-float split's
    hi part (the same values; sharing halves the fine level's residency)."""
    from ..ops.df64 import CgBandFF

    lv0 = h_low.levels[0]
    if isinstance(a_ff_small, CgBandFF):
        lv0 = lv0._replace(a=CgOperator(windows=lv0.a.windows, band=a_ff_small.hi))
    else:
        lv0 = lv0._replace(a=a_ff_small.hi)
    return h_low._replace(levels=(lv0,) + h_low.levels[1:])


def _stencil_ff_fine(a_ff_small, n: int, bw: int, device):
    """The float-float fine operator as pure stencils (slim mode): no
    ``(bs, bs, n)`` stream is materialized."""
    from ..ops.df64 import BlockTridiagFF, BTFFStencil

    if not isinstance(a_ff_small, BlockTridiagFF):
        raise ValueError("slim_fine requires a block-tridiagonal fine operator")

    def parts(bt: BlockTridiag, rtol):
        sts = {k: _extract_el(getattr(bt, k), bw, f"a_ff.{k}", rtol) for k in ("lower", "diag", "upper")}

        def mk(i):
            return BlockTridiag(**{k: torch.from_numpy(sts[k][i]).to(device) for k in sts})

        return mk(0), mk(1), mk(2)

    hi_l, hi_m, hi_r = parts(a_ff_small.hi, "auto")
    lo_l, lo_m, lo_r = parts(a_ff_small.lo, None)
    return BTFFStencil(
        hi_left=hi_l, hi_mid=hi_m, hi_right=hi_r, lo_left=lo_l, lo_mid=lo_m, lo_right=lo_r, n=n
    )


def _inflate_ff_tail(h64: Hierarchy, h_low: Hierarchy, z: int, bw: int, device, shard=None) -> tuple:
    """Per-level float-float operators for levels 1..end: hi shares the
    inflated float32 hierarchy's tensors (the float32 cast equals the split's
    hi exactly), lo inflates from the stencil-size float64 split (with
    ``shard``, as :func:`inflate_hierarchy`'s: the rank's part of a sharded
    level)."""
    from ..ops.df64 import BlockTridiagFF, CgBandFF, bt_split, cg_band_split

    group, flags = shard if shard is not None else (None, (False,) * len(h64.levels))
    plan = _Plan(z, bw, group)
    builders = []
    for k in range(1, len(h64.levels)):
        plan.sharded = flags[k]
        lv64, a = h64.levels[k], h_low.levels[k].a
        if isinstance(lv64, CgLevel):
            i = plan.node(cg_band_split(lv64.a.band).lo, lv64.a.p, f"a_ffs[{k}].lo", rtol=None)
            builders.append(lambda out, a=a, i=i: CgBandFF(hi=a.band, lo=out[i]))
        else:
            lo_fn = _plan_bt(plan, bt_split(lv64.a).lo, f"a_ffs[{k}].lo", device, rtol=None)
            builders.append(lambda out, a=a, lo_fn=lo_fn: BlockTridiagFF(hi=a, lo=lo_fn(out)))
    out = plan.inflate(device)
    return tuple(fn(out) for fn in builders)


def _inflate_transfer_los(h64: Hierarchy, z: int, bw: int, device) -> tuple:
    """Per-transfer lo tails ``round32(blocks64 - round32(blocks64))`` of the
    block transfers; None for CG and seam transfers (the true cycle applies
    them at float32 value accuracy)."""
    plan = _Plan(z, bw)
    idxs = []
    for k, t64 in enumerate(h64.transfers):
        if not isinstance(t64, BlockProlong):
            idxs.append(None)
            continue
        b64 = t64.blocks.to(torch.float64)
        lo = (b64 - b64.to(torch.float32).to(torch.float64)).to(torch.float32)
        idxs.append(plan.el(lo, f"t_lo[{k}]", rtol=None))
    out = plan.inflate(device)
    return tuple(None if i is None else BlockProlong(blocks=out[i]) for i in idxs)


def _inflate_ff_fine(a_ff_small, fine_low, z: int, bw: int, device, group=None, sharded: bool = False):
    """The inflated float-float fine operator; hi re-uses the low hierarchy's
    inflated fine operator (the same values); with ``sharded``, the rank's
    part of it."""
    from ..ops.df64 import BlockTridiagFF, CgBandFF

    plan = _Plan(z, bw, group)
    plan.sharded = sharded
    if isinstance(a_ff_small, CgBandFF):
        # node-axis, with p from the band's bandwidth
        i = plan.node(a_ff_small.lo, a_ff_small.hi.shape[0] // 2, "a_ff.lo", rtol=None)
        return CgBandFF(hi=fine_low.a.band, lo=plan.inflate(device)[i])
    lo_fn = _plan_bt(plan, a_ff_small.lo, "a_ff.lo", device, rtol=None)
    return BlockTridiagFF(hi=fine_low.a, lo=lo_fn(plan.inflate(device)))


def _uniform_dg_b(prob0, n: int, h: float, xin: float, func, bw: int, device, lo: int = 0,
                  hi: int | None = None) -> torch.Tensor:
    """Full-size DG rhs ``b = f - D M^-1 r`` in float64 on ``device``, its
    columns ``[lo, hi)`` (default all, a shard's otherwise): the volume load
    is the only position-dependent part; every boundary contribution is an
    additive, f-independent patch on the outermost elements, taken from the
    stencil problem (``dg_flux_rhs`` and the ``- D M^-1 r`` lift only add)."""
    from ..assembly.dg_assembly import dg_load, dg_load_vector

    hi = n if hi is None else hi
    dg0 = prob0.meshes[0]
    ref = dg0.ref
    f64 = dict(dtype=torch.float64, device=device)
    jac = torch.full((hi - lo,), h / 2.0, **f64)
    centers = xin + (torch.arange(lo, hi, **f64) + 0.5) * h
    load = dg_load(
        jac, centers, torch.tensor(ref.quad_nodes, **f64),
        torch.tensor(ref.quad_weights[:, None] * ref.basis_at_quad, **f64), func,
    )
    del jac, centers
    delta = prob0.b.cpu() - dg_load_vector(dg0, func)
    n0 = delta.shape[1]
    k = min(bw, n0 // 2)
    # global column c of either patch is delta's column c (left) or c - n + n0 (right)
    for g0, g1, d0 in ((0, k, 0), (n - k, n, n0 - n)):
        c0, c1 = max(g0, lo), min(g1, hi)
        if c1 > c0:
            load[:, c0 - lo : c1 - lo] += delta[:, c0 + d0 : c1 + d0].to(device)
    return load


def _uniform_cg_b(prob0, n: int, h: float, xin: float, func, bc: BoundaryCondition, device, lo: int = 0,
                  hi: int | None = None) -> torch.Tensor:
    """Full-size CG rhs in float64 on ``device``, its nodes ``[lo, hi)``
    (default all, a shard's otherwise): the volume load of the elements
    that touch them scattered to the nodes (each node takes at most two
    contributions, so ``index_add_`` is exact in any order), the Neumann
    terms, and the Dirichlet lift re-applied from the stencil problem's raw
    boundary windows (``f[dir] = g`` overwrites, so the lift is re-run, not
    patched)."""
    from ..assembly.cg_assembly import _raw_stiffness_windows
    from ..ops.cg_operator import cg_element_nodes

    cg0 = prob0.meshes[0]
    ref = cg0.ref
    p, w = cg0.p, cg0.p + 1
    n_nodes = n * p + 1
    hi = n_nodes if hi is None else hi
    f64 = dict(dtype=torch.float64, device=device)
    basis_pos = torch.tensor(np.ascontiguousarray(ref.basis_at_quad[:, ref.pos_to_slot]), **f64)  # (n_q, w)
    k0, k1 = max(0, -(-(lo - p) // p)), min(n, -(-hi // p))  # the elements whose nodes meet [lo, hi)
    centers = xin + (torch.arange(k0, k1, **f64) + 0.5) * h
    xq = centers[:, None] + (h / 2.0) * torch.tensor(ref.quad_nodes, **f64)[None, :]  # (m, n_q)
    del centers
    fe = (h / 2.0) * torch.einsum("l,la,kl->ak", torch.tensor(ref.quad_weights, **f64), basis_pos, func(xq))
    del xq
    f = torch.zeros((hi - lo,), **f64)
    idx = cg_element_nodes(p, k1 - k0, device) + (k0 * p - lo)
    keep = (idx >= 0) & (idx < hi - lo)
    f.index_add_(0, idx[keep], fe[keep])
    del fe

    def at(node: int):
        return node - lo if lo <= node < hi else None

    first, last = at(0), at(n_nodes - 1)
    if bc.neu_left and first is not None:
        f[first] -= bc.left[1]
    if bc.neu_right and last is not None:
        f[last] += bc.right[1]
    raw0 = _raw_stiffness_windows(cg0).to(device)
    for on, g, col, j0 in ((bc.dir_left, bc.left[1], raw0[:, 0, 0], 0),
                           (bc.dir_right, bc.right[1], raw0[:, w - 1, -1], n_nodes - w)):
        if not on:
            continue
        c0, c1 = max(j0, lo), min(j0 + w, hi)
        if c1 > c0:
            f[c0 - lo : c1 - lo] -= col[c0 - j0 : c1 - j0] * g
        node = at(0 if j0 == 0 else n_nodes - 1)
        if node is not None:
            f[node] = g
    return f
