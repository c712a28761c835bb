"""The torch port's V-cycle and drivers against the JAX package's, on the CPU.

* float64 ``v_cycle`` and ``multigrid`` on one JAX-built hierarchy handed to
  both packages (``utils.convert.hierarchy_from_numpy``);
* ``multigrid_mixed`` end to end (each package builds its own problem)
  against JAX's ``multigrid_mixed(use_pallas=False)``.  JAX's CPU branch runs
  A-form sweeps and a float-float defect, the port M-form sweeps and a
  float64 defect, so their float32 rounding differs: outer steps may differ
  by 1 and inner cycles by 2;
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
from agglomerationmultigrid1d_tpu_torch.models import (
    make_low_precision_hierarchy,
    mg_preconditioner,
    multigrid,
    multigrid_mixed,
    poisson_dg_hierarchy,
    v_cycle,
)
from agglomerationmultigrid1d_tpu_torch.models import solvers as tsolvers
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import bt_matvec
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

SLICE_SMALL = dict(n=64, max_p=3, n_dg=2, n_agg=3)


@functools.lru_cache(maxsize=None)
def _jax_problem(n, max_p, n_dg, n_agg=0):
    return jproblems.poisson_dg_hierarchy(n=n, max_p=max_p, n_dg=n_dg, n_agg=n_agg)


def _converted(**kw):
    jprob = _jax_problem(**kw)
    h = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy))
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
    prob = poisson_dg_hierarchy(**kw)
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
    iterations left the JAX package would continue with progressive cycles,
    which the port does not have: it must raise, not return."""
    prob = poisson_dg_hierarchy(n=32, max_p=1, n_dg=1, n_agg=2)
    h32 = make_low_precision_hierarchy(prob.hierarchy)

    def useless_inner(h_low, r, inner_tol, max_cycles, **kw):
        return torch.zeros_like(r), 1, 1

    monkeypatch.setattr(tsolvers, "_mixed_inner_solve", useless_inner)
    with pytest.raises(NotImplementedError, match="item 12"):
        multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(prob.b), prob.b, 80, 1e-10)


def test_multigrid_mixed_runs_out_of_iterations_quietly():
    """Spending ``maxiter`` (outer steps or inner cycles, whichever runs out
    first, as in the JAX package) is a normal end, as for ``multigrid``."""
    prob = poisson_dg_hierarchy(n=256, max_p=4, n_dg=3)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(prob.b), prob.b, 4, 1e-30)
    assert max(res.iterations, res.inner_cycles) >= 4
    it = res.iterations
    assert np.isfinite(res.res_history.numpy()[:it]).all()
    assert np.isnan(res.res_history.numpy()[it:]).all()


def test_import_does_not_load_jax():
    code = (
        "import sys; import agglomerationmultigrid1d_tpu_torch.models, "
        "agglomerationmultigrid1d_tpu_torch.ops.kernels, "
        "agglomerationmultigrid1d_tpu_torch.utils.convert; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
