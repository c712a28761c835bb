"""The torch port's progressive-precision cycles against the JAX package's,
on the CPU.

* ``multigrid_progressive`` on ``poisson_full_hierarchy(n=256)`` and
  ``poisson_dg_hierarchy(n=256, max_p=4, n_dg=3)`` (as
  ``tests/test_df64.py:116-143``): iteration counts within 1 of JAX's
  (``use_pallas=False``) and at most the float64 count + 2;
* ``multigrid_mixed``'s continuation: where the guarded refinement stops
  above tol, both packages hand over to ``_progressive_loop``.  With c_dir
  raised until the float32 inner cycle stalls (n=1024, c_dir=1e10) both take
  the branch and converge; their counts differ there (port 23 / 29, JAX
  14 / 17, pinned), since the float32 coarse solve is no contraction at that
  conditioning and rounding decides where the iterates first dip below tol.
  With that solve taken in float64 the port's continuation lowers the defect
  every cycle (ROADMAP queue 3).  With the inner solve made useless in both
  packages, the handover is forced at the same point and the counts agree
  within 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agglomerationmultigrid1d_tpu.models.solvers as jsolvers
import agglomerationmultigrid1d_tpu_torch.models.solvers as tsolvers
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu_torch.models import (
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    multigrid_progressive,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)

CONFIGS = {
    "full-256": (poisson_full_hierarchy, jproblems.poisson_full_hierarchy, dict(n=256)),
    "dg4-256": (poisson_dg_hierarchy, jproblems.poisson_dg_hierarchy, dict(n=256, max_p=4, n_dg=3)),
}


def _norm(b) -> float:
    return float(torch.linalg.vector_norm(b))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_multigrid_progressive_matches_jax(name):
    port, jax_fn, kw = CONFIGS[name]
    prob, jprob = port(**kw, device="cpu"), jax_fn(**kw)
    b = prob.b
    res = multigrid_progressive(prob.hierarchy, make_low_precision_hierarchy(prob.hierarchy),
                                torch.zeros_like(b), b, 60, 1e-10)
    jres = jsolvers.multigrid_progressive(
        jprob.hierarchy, jsolvers.make_low_precision_hierarchy(jprob.hierarchy),
        jnp.zeros_like(jprob.b), jprob.b, 60, 1e-10, use_pallas=False,
    )
    r64 = multigrid(prob.hierarchy, torch.zeros_like(b), b, 60, 1e-10, compute_error=False)
    it, j_it = res.iterations, int(jres.iterations)
    assert abs(it - j_it) <= 1, (it, j_it)
    assert it <= r64.iterations + 2, (it, r64.iterations)
    hist = res.res_history.numpy()
    assert hist[it - 1] < 1e-10 * _norm(b) and np.isnan(hist[it:]).all()
    assert res.x.dtype == torch.float64 and tuple(res.x.shape) == tuple(b.shape)
    assert res.inner_cycles == it


def _spy(monkeypatch, module, calls):
    orig = module._progressive_loop

    def spy(*args, **kw):
        calls.append(kw["maxiter"])
        return orig(*args, **kw)

    monkeypatch.setattr(module, "_progressive_loop", spy)


def _mixed_both(kw, maxiter):
    prob, jprob = poisson_dg_hierarchy(**kw, device="cpu"), jproblems.poisson_dg_hierarchy(**kw)
    res = multigrid_mixed(prob.hierarchy, make_low_precision_hierarchy(prob.hierarchy),
                          torch.zeros_like(prob.b), prob.b, maxiter, 1e-10)
    jres = jsolvers.multigrid_mixed(
        jprob.hierarchy, jsolvers.make_low_precision_hierarchy(jprob.hierarchy),
        jnp.zeros_like(jprob.b), jprob.b, maxiter, 1e-10, use_pallas=False,
    )
    nb = _norm(prob.b)
    for r, it in ((res, res.iterations), (jres, int(jres.iterations))):
        hist = np.asarray(r.res_history)
        assert hist[it - 1] < 1e-10 * nb and np.isnan(hist[it:]).all()
    return res, jres


def test_mixed_hands_over_where_the_float32_cycle_stalls(monkeypatch):
    """c_dir raised until the float32 inner V-cycle stalls: both packages'
    guarded loops stop above tol and continue with progressive cycles."""
    calls_t, calls_j = [], []
    _spy(monkeypatch, tsolvers, calls_t)
    _spy(monkeypatch, jsolvers, calls_j)
    res, jres = _mixed_both(dict(n=1024, max_p=1, n_dg=1, n_agg=3, c_dir=1e10), 60)
    assert len(calls_t) == 1 and len(calls_j) == 1, (calls_t, calls_j)
    # the counts observed on the CPU (ROADMAP queue 3), pinned so drift shows
    assert (res.iterations, res.inner_cycles) == (23, 29)
    assert (int(jres.iterations), int(jres.inner_cycles)) == (14, 17)


def test_mixed_handover_contracts_with_a_float64_coarse_solve(monkeypatch):
    """Why the counts above part: at c_dir=1e10 the progressive cycle's
    float32 coarse solve (the explicit inverse applied in float32) is no
    contraction, and the progressive iterates random-walk in both packages.
    With that one solve taken from the float64 factorization, the port's
    continuation lowers the defect every cycle and needs no more cycles than
    JAX's (3), and fewer steps in all."""
    kw = dict(n=1024, max_p=1, n_dg=1, n_agg=3, c_dir=1e10)
    prob = poisson_dg_hierarchy(**kw, device="cpu")
    steps = []
    loop = tsolvers._progressive_loop

    def spy(*args, **kw):
        out = loop(*args, **kw)
        steps.append(out[1])
        return out

    monkeypatch.setattr(tsolvers, "_progressive_loop", spy)
    monkeypatch.setattr(tsolvers, "_coarse_ff", lambda h, a, r: tsolvers._true_coarse_solve(prob.hierarchy.coarse, r))
    res = multigrid_mixed(prob.hierarchy, make_low_precision_hierarchy(prob.hierarchy),
                          torch.zeros_like(prob.b), prob.b, 60, 1e-10)
    hist = res.res_history.numpy()[: res.iterations] / _norm(prob.b)
    assert len(steps) == 1 and steps[0] > 0 and hist[-1] < 1e-10
    cont = hist[res.iterations - steps[0] - 1 :]  # the handover point, then each progressive cycle
    assert (cont[1:] < cont[:-1]).all(), cont
    assert steps[0] <= 3 and res.iterations < 14, (steps, res.iterations)  # plain: 15 and 23


def test_mixed_forced_handover_matches_jax(monkeypatch):
    """The inner solve returns a zero correction in both packages, so three
    rejected steps end the guarded loop at the same point; the progressive
    continuation then takes as many cycles as JAX's, within 1."""
    calls_t, calls_j = [], []
    _spy(monkeypatch, tsolvers, calls_t)
    _spy(monkeypatch, jsolvers, calls_j)
    monkeypatch.setattr(tsolvers, "_mixed_inner_solve", lambda h, r, *a, **k: (torch.zeros_like(r), 1, 1))
    monkeypatch.setattr(jsolvers, "_mixed_inner_solve",
                        lambda h, r, *a, **k: (jnp.zeros_like(r), jnp.asarray(1), jnp.asarray(1)))
    # maxiter 61 is a static argument of JAX's jitted loop: a fresh trace, so it
    # sees the patched inner solve whatever this process compiled before
    res, jres = _mixed_both(dict(n=256, max_p=4, n_dg=3), 61)
    assert len(calls_t) == 1 and len(calls_j) == 1
    assert abs(res.iterations - int(jres.iterations)) <= 1, (res.iterations, int(jres.iterations))
    assert abs(res.inner_cycles - int(jres.inner_cycles)) <= 1
