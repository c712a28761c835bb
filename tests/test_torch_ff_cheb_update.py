"""Kernel K14 (``ff_cheb_update_kernel``): one step of the true cycle's
Chebyshev smoothing on a block-Jacobi level, ``z = S^-1 r_hi``, ``d = z /
theta`` or ``d = c_d d + c_z z``, ``u = ff_add(u, (d, 0))``.

On the CPU (these count everywhere):

* ``ff_cheb_update_plain`` equals the chain it replaces bit for bit (signed
  zeros included): one step against the chain's own operations on 0-d
  tensors, and whole smoothings against ``models.solvers._chebyshev`` with
  ``_smooth_true``'s ``ff_add`` update, the block-Jacobi apply rounded as K9
  rounds it; at every block size of ``SUPPORTED_BLOCK_SIZES``, odd column
  counts, the first, a middle and the last step, on contiguous and
  column-major vectors with -0 and subnormal lo parts;
* the level's host floats (``theta``, the recurrence table) equal the 0-d
  recurrence of ``_chebyshev`` bit for bit on every level of a small
  ``build_xl_problem(slim_fine=True, ff_levels=True)``;
* ``_chebyshev_k14`` (the card's path) equals the plain chain through a
  true smoothing and a whole ``multigrid_true``, and the CPU path launches
  nothing;
* the wrapper refuses what the kernel does not take.

On the card (marker ``cuda``; skipped without one): the kernel against its
plain version bit for bit at every block size, step and layout; a block
size without an instance raises; a true smoothing launches the defect and
K14 and no K9; a small ``multigrid_true`` through K14 gives the plain
chain's residual history and x bit for bit, with 6 K14 launches a cycle on
each Chebyshev block-Jacobi level and none on the flagship path's CG
levels.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_ff_cheb_update.py
"""

import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu_torch.models import solvers
from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.smoothers import smoother as smoother_mod
from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother

SIZES = bk.SUPPORTED_BLOCK_SIZES
STEPS = ("first", "middle", "last")
LAYOUTS = ("contiguous", "n_major")
INTERVAL = (0.3387, 1.4225)  # lam_lo, lam_hi of a level (float32 values)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def k9_rounding(monkeypatch):
    """The block-Jacobi apply rounded as the card's K9 rounds it (its plain
    version in place of the CPU's einsum), as the chain runs on the card."""
    monkeypatch.setattr(smoother_mod, "bd_matvec", lambda bd, x: bk.bd_gemv_plain(bd.blocks, x))


def _wide(rng, shape):
    """float32 values over 2^-20..2^20 with 5 % +0.0 and 5 % -0.0 entries."""
    v = (rng.standard_normal(shape) * np.exp2(rng.integers(-20, 21, shape))).astype(np.float32)
    u = rng.random(shape)
    v[u < 0.05] = 0.0
    v[(u >= 0.05) & (u < 0.1)] = -0.0
    return v


def _tails(rng, hi):
    """lo parts of ``hi``: ~2^-25 of it, 10 % -0.0, 10 % +0.0 and 10 %
    subnormal (either sign)."""
    lo = (hi * rng.standard_normal(hi.shape) * 2.0**-25).astype(np.float32)
    u = rng.random(hi.shape)
    lo[u < 0.1] = -0.0
    lo[(u >= 0.1) & (u < 0.2)] = 0.0
    sub = (u >= 0.2) & (u < 0.3)
    lo[sub] = (rng.integers(1, 2**23, sub.sum()) * np.where(rng.random(sub.sum()) < 0.5, -1, 1)).astype(np.float32) \
        * np.float32(2.0**-149)
    return lo


def _laid_out(t: torch.Tensor, layout: str) -> torch.Tensor:
    """contiguous, or n-major: a CG-topped chain's agglomerated-level vectors."""
    return t.contiguous() if layout == "contiguous" else t.movedim(-1, 0).contiguous().movedim(0, -1)


def _inputs(seed, bs, n, device="cpu", layout="contiguous", degree=3):
    """``(s_inv, rs, u_hi, u_lo, d)``: S^-1 (bs, bs, n), ``degree`` defect hi
    parts, an iterate with awkward tails and a previous d."""
    rng = np.random.default_rng(seed)

    def t(a):
        return _laid_out(torch.from_numpy(a).to(device), layout)

    s_inv = torch.from_numpy(_wide(rng, (bs, bs, n))).to(device)
    u_hi = _wide(rng, (bs, n))
    return (s_inv, [t(_wide(rng, (bs, n))) for _ in range(degree)], t(u_hi), t(_tails(rng, u_hi)),
            t(_wide(rng, (bs, n))))


def _smoother(s_inv, device="cpu"):
    """A float32 Chebyshev level over block Jacobi, with its host table."""
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import _with_chebyshev_table

    lam = [torch.tensor(v, dtype=torch.float32, device=device) for v in INTERVAL]
    return _with_chebyshev_table(ChebyshevSmoother(base=BlockJacobiSmoother(inv=s_inv), lam_lo=lam[0], lam_hi=lam[1]))


def _recurrence(s, steps):
    """``_chebyshev``'s scalars on 0-d tensors: theta, then ``(c_d, c_z)`` of
    steps 1 .. steps - 1."""
    theta = 0.5 * (s.lam_hi + s.lam_lo)
    delta = 0.5 * (s.lam_hi - s.lam_lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    rows = []
    for _ in range(1, steps):
        rho_new = 1.0 / (2.0 * sigma - rho)
        rows.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, rows


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(got, want) -> bool:
    """Equal bit for bit (so +0.0 and -0.0 differ); None matches None."""
    return all((g is None and w is None) or (g is not None and w is not None and torch.equal(_bits(g), _bits(w)))
               for g, w in zip(got, want))


# (d given, keep_d, coef row) of the first, a middle (step 1) and the last (step 2 of 3) step
STEP_ARGS = {"first": (False, True, 0), "middle": (True, True, 1), "last": (True, False, 2)}


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("bs", SIZES)
def test_plain_step_equals_the_chain(bs, n, step, layout, k9_rounding):
    """One step against ``_chebyshev``'s own operations: ``apply_smoother``
    (alpha 1), the 0-d recurrence, ``ff_add(u, FF(d, zeros_like(d)))``."""
    s_inv, rs, u_hi, u_lo, d_prev = _inputs(bs * 1000 + n, bs, n, layout=layout)
    s = _smoother(s_inv)
    with_d, keep_d, row = STEP_ARGS[step]
    theta, rows = _recurrence(s, 3)
    z = smoother_mod.apply_smoother(s.base, rs[0])
    d = (rows[row - 1][0] * d_prev + rows[row - 1][1] * z) if with_d else z / theta
    u = tdf.ff_add(tdf.FF(u_hi, u_lo), tdf.FF(d, torch.zeros_like(d)))
    want = (u.hi, u.lo, d if keep_d else None)
    bk.reset_launch_counts()
    args = (s_inv, rs[0], u_hi, u_lo, d_prev if with_d else None)
    kw = dict(theta=s.theta, coef=s.coef[row], keep_d=keep_d)
    assert _same(bk.ff_cheb_update_plain(*args, **kw), want)
    assert _same(bk.ff_cheb_update(*args, **kw), want)  # the wrapper's CPU path
    assert bk.LAUNCHES["ff_cheb_update"] == 0


@pytest.mark.parametrize("degree", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("bs", SIZES)
def test_plain_steps_equal_the_chebyshev_smoothing(bs, n, degree, k9_rounding):
    """``degree`` plain steps against ``solvers._chebyshev`` with
    ``_smooth_true``'s update, the step's defect given."""
    s_inv, rs, u_hi, u_lo, _ = _inputs(bs * 7 + n + degree, bs, n, degree=degree)
    s = _smoother(s_inv)
    it = iter(rs)
    want = solvers._chebyshev(s, degree, tdf.FF(u_hi, u_lo), lambda u: next(it),
                              lambda u, d: tdf.ff_add(u, tdf.FF(d, torch.zeros_like(d))))
    d = None
    for step in range(degree):
        u_hi, u_lo, d = bk.ff_cheb_update_plain(s_inv, rs[step], u_hi, u_lo, d, theta=s.theta, coef=s.coef[step],
                                                keep_d=step < degree - 1)
    assert d is None
    assert _same((u_hi, u_lo), want)


def _xl_problem(n=4096):
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n)
    return build_xl_problem(spec, n, z=8, slim_fine=True, ff_levels=True, device="cpu")


def _cheb_block_levels(h):
    return [k for k, lv in enumerate(h.levels[:-1])
            if isinstance(lv.smoother, ChebyshevSmoother) and isinstance(lv.smoother.base, BlockJacobiSmoother)]


def test_host_coefficients_equal_the_0d_recurrence():
    """``theta`` and rows 1.. of every Chebyshev level's table, host floats
    made once at set-up, equal ``_chebyshev``'s 0-d recurrence bit for bit."""
    h, _, _, _ = _xl_problem()
    levels = _cheb_block_levels(h)
    assert len(levels) == len(h.levels) - 1
    for k in levels:
        s = h.levels[k].smoother
        theta, rows = _recurrence(s, bk.MAX_SWEEPS)
        assert isinstance(s.theta, float) and len(s.coef) == bk.MAX_SWEEPS
        assert _same([torch.tensor(s.theta, dtype=torch.float32)], [theta]), k
        for (c_d, c_z), (t_d, t_z) in zip(s.coef[1:], rows):
            assert _same([torch.tensor([c_d, c_z], dtype=torch.float32)], [torch.stack([t_d, t_z])]), k


def test_true_smoothing_through_the_card_path_equals_the_chain(k9_rounding):
    """``_chebyshev_k14`` (what the card runs, its wrapper here on the plain
    version) against ``_smooth_true``'s CPU chain, on every Chebyshev level of
    the small north star, pre-smoothing from zero and from a non-zero u."""
    h, ffops, b_ff, _ = _xl_problem()
    rng = np.random.default_rng(5)
    for k in _cheb_block_levels(h):
        lv, a_ff = h.levels[k], ffops.a_ffs[k]
        shape = (lv.a.block_size, lv.a.n_blocks)
        rhs = tdf.FF(*(torch.from_numpy(_wide(rng, shape)) for _ in range(2)))
        u_hi = _wide(rng, shape)
        for u in (tdf.FF(torch.zeros(shape), torch.zeros(shape)),
                  tdf.FF(torch.from_numpy(u_hi), torch.from_numpy(_tails(rng, u_hi)))):
            bk.reset_launch_counts()
            want = solvers._smooth_true(lv, a_ff, u, rhs, 3, 2.0 / 3.0)
            assert bk.LAUNCHES["ff_cheb_update"] == 0  # the CPU keeps the chain
            got = solvers._chebyshev_k14(lv.smoother, 3, u, lambda v: tdf.ff_defect(a_ff, v, rhs).hi)
            assert _same(got, want), k


def test_multigrid_true_through_the_card_path_equals_the_chain(monkeypatch, k9_rounding):
    """A whole ``multigrid_true`` with ``_smooth_true`` sending every
    Chebyshev block-Jacobi level to ``_chebyshev_k14`` (as the card does)
    gives the chain's residual history and x bit for bit."""
    h, ffops, b_ff, norm_b = _xl_problem()
    chain = solvers.multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    own = solvers._smooth_true

    def card_path(level, a_ff_k, u_ff, rhs_ff, n_sweeps, alpha, k=None):
        s = level.smoother
        if isinstance(s, ChebyshevSmoother) and isinstance(s.base, BlockJacobiSmoother):
            return solvers._chebyshev_k14(s, n_sweeps, u_ff, lambda u: tdf.ff_defect(a_ff_k, u, rhs_ff).hi)
        return own(level, a_ff_k, u_ff, rhs_ff, n_sweeps, alpha, k)

    monkeypatch.setattr(solvers, "_smooth_true", card_path)
    got = solvers.multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    it = chain.iterations
    assert it == 6 and got.iterations == it
    assert torch.equal(got.res_history[:it], chain.res_history[:it])
    assert torch.equal(got.x, chain.x)


def test_card_path_refuses_a_level_without_its_table():
    s_inv, rs, u_hi, u_lo, _ = _inputs(3, 2, 9)
    s = _smoother(s_inv)
    u = tdf.FF(u_hi, u_lo)
    for bad, degree in ((s._replace(theta=None), 3), (s._replace(coef=None), 3), (s, bk.MAX_SWEEPS + 1)):
        with pytest.raises(ValueError, match="recurrence table"):
            solvers._chebyshev_k14(bad, degree, u, lambda v: rs[0])


def _bad(case):
    s_inv, rs, u_hi, u_lo, d = _inputs(0, 2, 16)
    kw = dict(theta=1.25, coef=(0.5, 0.25))
    if case == "vector":
        u_lo = u_lo[:, :15]
    elif case == "s_inv":
        s_inv = s_inv[:, :, :15]
    elif case == "d":
        d = d[:1]
    elif case == "dtype":
        u_hi = u_hi.double()
    elif case == "not_a_matrix":
        rs[0] = rs[0].reshape(-1)
    elif case == "first_without_theta":
        d, kw = None, dict(coef=(0.5, 0.25))
    elif case == "later_without_coef":
        kw = dict(theta=1.25)
    return (s_inv, rs[0], u_hi, u_lo, d), kw


@pytest.mark.parametrize("case,error", [
    ("vector", ValueError), ("s_inv", ValueError), ("d", ValueError), ("dtype", TypeError),
    ("not_a_matrix", ValueError), ("first_without_theta", ValueError), ("later_without_coef", ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    args, kw = _bad(case)
    with pytest.raises(error):
        bk.ff_cheb_update(*args, **kw)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100003])
@pytest.mark.parametrize("bs", SIZES)
def test_cuda_k14_equals_plain(cuda, bs, n):
    """Every step and vector layout; one launch each, bit for bit."""
    calls = 0
    bk.reset_launch_counts()
    for layout in LAYOUTS:
        s_inv, rs, u_hi, u_lo, d_prev = _inputs(bs * 7919 + n, bs, n, cuda, layout)
        s = _smoother(s_inv, cuda)
        for step in STEPS:
            with_d, keep_d, row = STEP_ARGS[step]
            args = (s_inv, rs[row], u_hi, u_lo, d_prev if with_d else None)
            kw = dict(theta=s.theta, coef=s.coef[row], keep_d=keep_d)
            got, want = bk.ff_cheb_update(*args, **kw), bk.ff_cheb_update_plain(*args, **kw)
            torch.cuda.synchronize()
            calls += 1
            assert _same(got, want), (layout, step)
    assert bk.LAUNCHES["ff_cheb_update"] == calls


@pytest.mark.cuda
def test_cuda_k14_refuses_a_block_size_without_an_instance(cuda):
    s_inv, rs, u_hi, u_lo, _ = _inputs(6, 6, 300, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        bk.ff_cheb_update(s_inv, rs[0], u_hi, u_lo, theta=1.0)


def _card_problem(chain, device):
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    if chain == "dg":
        n = 131072
        spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, first_agg_factor=4,
                             agg_factor=4, c_dir=1000.0 * n)
        return build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device=device)
    n = 16384
    spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n)
    return build_xl_problem(spec, n, ff_levels=True, device=device)


@pytest.mark.cuda
def test_cuda_true_smoothing_launches_k12_and_k14_and_no_k9(cuda):
    """A degree-3 true smoothing on an agglomerated level launches three K12
    and three K14 and no other hand-written kernel: K9's apply is inside
    K14.  (That nothing else runs is ``tools/trace_phases.py``'s to show: a
    second CUDA profiling session in one pytest process has been seen to
    record no kernel on the card, so no test here opens one beside K12's.)"""
    h, ffops, _, _ = _card_problem("dg", cuda)
    lv, a_ff = h.levels[1], ffops.a_ffs[1]
    shape = (lv.a.block_size, lv.a.n_blocks)
    g = torch.Generator(device=cuda).manual_seed(1)
    rhs = tdf.FF(torch.randn(shape, generator=g, device=cuda), 1e-8 * torch.randn(shape, generator=g, device=cuda))
    u = tdf.FF(torch.randn(shape, generator=g, device=cuda), torch.zeros(shape, device=cuda))
    bk.reset_launch_counts()
    solvers._smooth_true(lv, a_ff, u, rhs, 3, 2.0 / 3.0)
    torch.cuda.synchronize()
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {"ff_bt_defect": 3, "ff_cheb_update": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["dg", "cg"])
def test_cuda_multigrid_true_through_k14_equals_the_plain_chain(cuda, monkeypatch, chain):
    """The north star's chain cut to 262,144 DoF (``dg``) and the CG-topped
    flagship's at 131,073 DoF (``cg``: CG p = 8, 4, 2, 1, whose Jacobi /
    Schwarz Chebyshev levels keep the plain chain, then agglomerated levels
    whose vectors the seam transfer leaves column-major): K14 launches 6
    times a cycle on each Chebyshev block-Jacobi level, and none on the CG
    levels; the residual history and x equal those of the plain chain (the
    path before K14) and of K14's plain version, to the last bit."""
    h, ffops, b_ff, norm_b = _card_problem(chain, cuda)
    levels = _cheb_block_levels(h)
    assert len(levels) >= 3
    bk.reset_launch_counts()
    kern = solvers.multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    it = kern.iterations
    assert it > 0 and bk.LAUNCHES["ff_cheb_update"] == 6 * len(levels) * it
    if chain == "cg":  # the CG levels' smoothing launches none
        cg = next(k for k, lv in enumerate(h.levels) if k not in levels)
        rhs = tdf.FF(b_ff.hi, b_ff.lo)
        bk.reset_launch_counts()
        solvers._smooth_true(h.levels[cg], ffops.a_ffs[cg], tdf.FF(b_ff.hi * 0, b_ff.lo * 0), rhs, 3, 2.0 / 3.0)
        assert cg == 0 and bk.LAUNCHES["ff_cheb_update"] == 0
    monkeypatch.setattr(bk, "ff_cheb_update", bk.ff_cheb_update_plain)
    plain = solvers.multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    monkeypatch.setattr(solvers, "_chebyshev_k14", lambda s, degree, u, residual: solvers._chebyshev(
        s, degree, u, residual, lambda v, d: tdf.ff_add(v, tdf.FF(d, torch.zeros_like(d)))))
    bk.reset_launch_counts()
    before = solvers.multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    assert bk.LAUNCHES["ff_cheb_update"] == 0
    for other in (plain, before):
        assert other.iterations == it
        assert torch.equal(kern.res_history[:it], other.res_history[:it])  # NaN beyond the cycles run
        assert torch.equal(kern.x, other.x)
