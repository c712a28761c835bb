"""The torch port's V-cycle and drivers against the JAX package's, on the CPU.

* float64 ``v_cycle`` and ``multigrid`` on one JAX-built hierarchy handed to
  both packages (``utils.convert.hierarchy_from_numpy``);
* float64 ``multigrid`` on the CG-topped flagship, each package building
  its own problem: equal iteration counts and histories, and h-independent
  counts;
* ``multigrid_mixed`` end to end (each package builds its own problem)
  against JAX's ``multigrid_mixed(use_pallas=False)``, with and without
  Chebyshev smoothing.  JAX's CPU branch runs A-form sweeps and a
  float-float defect, the port M-form sweeps (K1/K2/K5's plain versions)
  and a float64 defect, so their float32 rounding differs: outer steps may
  differ by 1 and inner cycles by 2;
* importing the port does not import JAX.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.models.hierarchy import chebyshev_hierarchy as jchebyshev_hierarchy
from agglomerationmultigrid1d_tpu_torch.models import (
    chebyshev_hierarchy,
    make_low_precision_hierarchy,
    mg_preconditioner,
    multigrid,
    multigrid_mixed,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
    v_cycle,
)
from agglomerationmultigrid1d_tpu_torch.models import solvers as tsolvers
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import bt_matvec
from agglomerationmultigrid1d_tpu_torch.smoothers import ChebyshevSmoother
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

SLICE_SMALL = dict(n=64, max_p=3, n_dg=2, n_agg=3)


@functools.lru_cache(maxsize=None)
def _jax_problem(n, max_p, n_dg, n_agg=0):
    return jproblems.poisson_dg_hierarchy(n=n, max_p=max_p, n_dg=n_dg, n_agg=n_agg)


def _converted(**kw):
    jprob = _jax_problem(**kw)
    h = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy), device="cpu")
    return jprob, h, torch.tensor(np.asarray(jprob.b))


def test_v_cycle_matches_jax():
    jprob, h, b = _converted(**SLICE_SMALL)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(tuple(b.shape))
    want = np.asarray(jsolvers.v_cycle(jprob.hierarchy, jnp.asarray(x0), jprob.b))
    got = v_cycle(h, torch.from_numpy(x0), b).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    pre = mg_preconditioner(h, b)
    np.testing.assert_array_equal(pre.numpy(), v_cycle(h, torch.zeros_like(b), b).numpy())


@pytest.mark.parametrize("maxiter,tol", [(80, 1e-10), (3, 1e-16)])
def test_multigrid_matches_jax(maxiter, tol):
    jprob, h, b = _converted(**SLICE_SMALL)
    jres = jsolvers.multigrid(jprob.hierarchy, jnp.zeros_like(jprob.b), jprob.b, maxiter, tol)
    res = multigrid(h, torch.zeros_like(b), b, maxiter, tol)
    it = int(jres.iterations)
    assert res.iterations == it
    # rtol 1e-9, down to the float64 rounding floor: the two packages' histories
    # differ by a constant ~1e-12 absolute (about eps * ||b|| for the residual)
    # while they fall seven decades, so the floor is 1e-12 of the first entry
    for got, want in ((res.res_history, jres.res_history), (res.err_history, jres.err_history)):
        want = np.asarray(want)[:it]
        np.testing.assert_allclose(got.numpy()[:it], want, rtol=1e-9, atol=1e-12 * want[0])
        assert np.isnan(got.numpy()[it:]).all()


def _mixed_pair(kw):
    jprob = _jax_problem(**kw)
    jh32 = jsolvers.make_low_precision_hierarchy(jprob.hierarchy)
    jres = jsolvers.multigrid_mixed(
        jprob.hierarchy, jh32, jnp.zeros_like(jprob.b), jprob.b, 80, 1e-10, use_pallas=False
    )
    prob = poisson_dg_hierarchy(**kw, device="cpu")
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(prob.b), prob.b, 80, 1e-10)
    return prob, res, jres


@pytest.mark.parametrize(
    "kw", [dict(n=256, max_p=4, n_dg=3), dict(n=4096, max_p=3, n_dg=2, n_agg=5)],
    ids=["dg4", "dg3-agg5"],
)
def test_multigrid_mixed_matches_jax(kw):
    prob, res, jres = _mixed_pair(kw)
    b = prob.b
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(bt_matvec(prob.hierarchy.levels[0].a, res.x) - b)) / nb
    assert rel < 1e-10
    assert float(res.res_history[res.iterations - 1]) / nb < 1e-10
    j_it = int(jres.iterations)
    assert np.asarray(jres.res_history)[j_it - 1] / nb < 1e-10
    assert abs(res.iterations - j_it) <= 1, (res.iterations, j_it)
    assert abs(res.inner_cycles - int(jres.inner_cycles)) <= 2, (
        res.inner_cycles, int(jres.inner_cycles),
    )
    assert res.x.dtype == torch.float64 and tuple(res.x.shape) == tuple(b.shape)


def test_multigrid_mixed_raises_where_progressive_would_take_over(monkeypatch):
    """Three rejected steps in a row end the guarded loop above tol; with
    iterations left the solve no longer raises there (as it did before the
    progressive cycles were ported) but continues with progressive-precision
    cycles, as the JAX package does, and converges."""
    prob = poisson_dg_hierarchy(n=32, max_p=1, n_dg=1, n_agg=2, device="cpu")
    h32 = make_low_precision_hierarchy(prob.hierarchy)

    def useless_inner(h_low, r, inner_tol, max_cycles, **kw):
        return torch.zeros_like(r), 1, 1

    monkeypatch.setattr(tsolvers, "_mixed_inner_solve", useless_inner)
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(prob.b), prob.b, 80, 1e-10)
    nb = float(torch.linalg.vector_norm(prob.b))
    # the three rejected guarded steps made no progress; the cycles after them did
    np.testing.assert_allclose(res.res_history[:3].numpy(), nb, rtol=1e-15)
    assert res.iterations > 3 and float(res.res_history[res.iterations - 1]) < 1e-10 * nb
    assert float(torch.linalg.vector_norm(bt_matvec(prob.hierarchy.levels[0].a, res.x) - prob.b)) < 1e-10 * nb


def test_multigrid_mixed_runs_out_of_iterations_quietly():
    """Spending ``maxiter`` (outer steps or inner cycles, whichever runs out
    first, as in the JAX package) is a normal end, as for ``multigrid``."""
    prob = poisson_dg_hierarchy(n=256, max_p=4, n_dg=3, device="cpu")
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(prob.b), prob.b, 4, 1e-30)
    assert max(res.iterations, res.inner_cycles) >= 4
    it = res.iterations
    assert np.isfinite(res.res_history.numpy()[:it]).all()
    assert np.isnan(res.res_history.numpy()[it:]).all()


@functools.lru_cache(maxsize=None)
def _flagship_pair(n):
    """Both packages' f64 solves of the flagship, and how far rounding alone
    moves the port's error history: the same solve with b moved by one ulp
    in random directions."""
    jprob = jproblems.poisson_full_hierarchy(n=n)
    jres = jsolvers.multigrid(jprob.hierarchy, jnp.zeros_like(jprob.b), jprob.b, 100, 1e-10)
    prob = poisson_full_hierarchy(n=n, device="cpu")
    b = prob.b
    res = multigrid(prob.hierarchy, torch.zeros_like(b), b, 100, 1e-10)
    signs = torch.from_numpy(np.random.default_rng(n).choice([-1.0, 1.0], size=tuple(b.shape)))
    b_ulp = b + signs * torch.finfo(b.dtype).eps * b.abs()
    moved = multigrid(prob.hierarchy, torch.zeros_like(b), b_ulp, res.iterations, 0.0)
    it = res.iterations
    err_floor = float(np.abs(moved.err_history.numpy()[:it] - res.err_history.numpy()[:it]).max())
    return res, jres, err_floor


@pytest.mark.parametrize("n", [32, 64, 128])
def test_flagship_multigrid_matches_jax(n):
    """f64 V-cycles on the CG-topped flagship (full_heirarchy_test.jl), error
    history against the banded direct solve of the CG fine operator."""
    res, jres, err_floor = _flagship_pair(n)
    it = int(jres.iterations)
    assert res.iterations == it
    # rtol 1e-9 above the float64 rounding floor.  For the residual the floor
    # is 1e-12 of its first entry, as for the DG-topped chain above.  The p = 8
    # CG operator is far worse conditioned than the DG one, and its iterates
    # move by up to cond(A) eps: there the floor is 1e-12 of the first error
    # plus 4x what a one-ulp change of b moves the port's own error history
    # (measured: the two packages differ by 0.5-0.8x that move)
    for got, want, floor in (
        (res.res_history, jres.res_history, 0.0),
        (res.err_history, jres.err_history, 4.0 * err_floor),
    ):
        want = np.asarray(want)[:it]
        np.testing.assert_allclose(got.numpy()[:it], want, rtol=1e-9, atol=1e-12 * want[0] + floor)
        assert np.isnan(got.numpy()[it:]).all()
    assert res.x.shape == (8 * n + 1,)


def test_flagship_h_independence():
    """Iteration counts do not grow with n (``tests/test_hierarchy.py:71-78``)."""
    counts = [_flagship_pair(n)[0].iterations for n in (32, 64, 128)]
    assert max(counts) - min(counts) <= 2, counts


def _mixed_counts(port_fn, jax_fn, kw, cheb):
    jprob = jax_fn(**kw)
    jh = jchebyshev_hierarchy(jprob.hierarchy) if cheb else jprob.hierarchy
    jres = jsolvers.multigrid_mixed(
        jh, jsolvers.make_low_precision_hierarchy(jh), jnp.zeros_like(jprob.b), jprob.b, 80,
        1e-10, use_pallas=False,
    )
    prob = port_fn(**kw, device="cpu")
    h = chebyshev_hierarchy(prob.hierarchy) if cheb else prob.hierarchy
    res = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(prob.b), prob.b, 80, 1e-10)
    return prob, res, jres


def _check_mixed(prob, res, jres, one_sided=False):
    b = prob.b
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(tsolvers.level_matvec(prob.hierarchy.levels[0], res.x) - b)) / nb
    assert rel < 1e-10
    j_it, j_cyc = int(jres.iterations), int(jres.inner_cycles)
    assert np.asarray(jres.res_history)[j_it - 1] / nb < 1e-10
    d_it, d_cyc = res.iterations - j_it, res.inner_cycles - j_cyc
    if one_sided:
        d_it, d_cyc = max(d_it, 0), max(d_cyc, 0)
    assert abs(d_it) <= 1 and abs(d_cyc) <= 2, ((res.iterations, res.inner_cycles), (j_it, j_cyc))
    assert res.x.dtype == torch.float64 and tuple(res.x.shape) == tuple(b.shape)


@pytest.mark.parametrize("cheb", [False, True], ids=["full64", "full64-cheb"])
def test_multigrid_mixed_flagship_matches_jax(cheb):
    """The mixed solve on the CG-topped flagship: a CG fine level, so the
    float64 defect is ``cg_matvec``; Chebyshev on every smoothed level."""
    _check_mixed(*_mixed_counts(poisson_full_hierarchy, jproblems.poisson_full_hierarchy, dict(n=64), cheb))


def test_multigrid_mixed_chebyshev_matches_jax(monkeypatch):
    """Chebyshev mixed solve on the DG-topped chain.  The port's float32 block
    levels run K5 in M-form (``z = (c - x) - (ML x_- + MU x_+)``), as the JAX
    package's Pallas kernel does on the TPU; JAX's CPU branch runs the A-form
    recurrence ``z = S^-1 (b - A x)``, whose float32 ``b - A x`` cancels under
    the 1000 n penalty.  So the port may take fewer steps than JAX here (9 / 16
    against 11 / 18), never more; with K5 swapped for the A-form recurrence it
    reproduces JAX's counts to 1 step and 2 cycles."""
    kw = dict(n=4096, max_p=3, n_dg=2, n_agg=5)
    _check_mixed(*_mixed_counts(poisson_dg_hierarchy, jproblems.poisson_dg_hierarchy, kw, True), one_sided=True)
    on_kernels = tsolvers._on_kernels
    monkeypatch.setattr(
        tsolvers, "_on_kernels",
        lambda level, u: on_kernels(level, u) and not isinstance(level.smoother, ChebyshevSmoother),
    )
    _check_mixed(*_mixed_counts(poisson_dg_hierarchy, jproblems.poisson_dg_hierarchy, kw, True))


def test_import_does_not_load_jax():
    code = (
        "import sys; import agglomerationmultigrid1d_tpu_torch.models, "
        "agglomerationmultigrid1d_tpu_torch.ops.kernels, "
        "agglomerationmultigrid1d_tpu_torch.utils.convert; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
