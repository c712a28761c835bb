"""The torch port's Chebyshev smoothing against the JAX package's, on the CPU:

* the float32 recurrence table (``chebyshev_coefficients``) to 1 ulp;
* per-level lambda_max estimates of ``chebyshev_hierarchy`` to 1e-12
  relative (float64 power iteration in both packages);
* K5's plain version against the Pallas kernel in interpret mode, at shapes
  where the Pallas body runs (n >= 2 tile, n % tile == 0), to the tolerances
  of ``tests/test_pallas.py``: 2e-5 of max|x| for x, 2e-4 of max|b| for r;
* the K5 wrappers' CPU path and input checks;
* ``_smooth_cheb`` in float64 to 1e-12 normwise, on a CG and a block level;
* Chebyshev V-cycles beat damped ones on both hierarchy families, with the
  JAX package's iteration counts.

The CUDA kernel itself is tested in ``test_torch_cuda.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.models.hierarchy import chebyshev_hierarchy as jcheb
from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops.block_tridiag import block_mul as jblock_mul
from agglomerationmultigrid1d_tpu.ops.pallas import chebyshev_coefficients as jcoef
from agglomerationmultigrid1d_tpu.ops.pallas import pallas_chebyshev_multisweep
from agglomerationmultigrid1d_tpu_torch.models import (
    chebyshev_hierarchy,
    make_low_precision_hierarchy,
    multigrid,
    poisson_cg_hierarchy,
    poisson_dg_cg_hierarchy,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.models import solvers as tsolvers
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.smoothers import ChebyshevSmoother
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

CONFIGS = {
    "full-32": (poisson_full_hierarchy, jproblems.poisson_full_hierarchy, dict(n=32)),
    "cg-64": (poisson_cg_hierarchy, jproblems.poisson_cg_hierarchy, dict(n=64)),
    "dg_cg-64": (poisson_dg_cg_hierarchy, jproblems.poisson_dg_cg_hierarchy, dict(n=64)),
    "dg3-agg3": (poisson_dg_hierarchy, jproblems.poisson_dg_hierarchy, dict(n=64, max_p=3, n_dg=2, n_agg=3)),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port problem, its Chebyshev hierarchy, JAX problem, JAX Chebyshev hierarchy)."""
    port, jax_fn, kw = CONFIGS[name]
    prob, jprob = port(**kw, device="cpu"), jax_fn(**kw)
    return prob, chebyshev_hierarchy(prob.hierarchy), jprob, jcheb(jprob.hierarchy)


@pytest.mark.parametrize("lo,hi", [(0.3, 1.2), (0.2625, 1.05), (1e-3, 2.0), (0.5, 0.5000001)])
def test_coefficients_match_jax_to_one_ulp(lo, hi):
    got = bk.chebyshev_coefficients(lo, hi, bk.MAX_SWEEPS)
    want = np.asarray(jcoef(jnp.float32(lo), jnp.float32(hi), bk.MAX_SWEEPS))
    assert got.dtype == np.float32 and got.shape == (bk.MAX_SWEEPS, 2)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(bk.chebyshev_coefficients(lo, hi, 3), got[:3])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lambda_and_float32_table_match_jax(name):
    """lambda per level to 1e-12 relative in float64, and the float32 table
    of the cast hierarchy against JAX's coefficients of its float32 lambdas
    to 1 ulp."""
    _, h, _, jh = _pair(name)
    h32 = make_low_precision_hierarchy(h)
    jh32 = jsolvers.make_low_precision_hierarchy(jh)
    for k, (lv, jlv) in enumerate(zip(h.levels[:-1], jh.levels[:-1])):
        s, js = lv.smoother, jlv.smoother
        assert isinstance(s, ChebyshevSmoother) and s.lam_hi.dtype == torch.float64
        for got, want in ((s.lam_hi, js.lam_hi), (s.lam_lo, js.lam_lo)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-12, err_msg=f"level {k}")
        s32, js32 = h32.levels[k].smoother, jh32.levels[k].smoother
        want = np.asarray(jcoef(js32.lam_lo, js32.lam_hi, bk.MAX_SWEEPS))
        np.testing.assert_array_max_ulp(np.asarray(s32.coef, np.float32), want, maxulp=1)
    assert not isinstance(h.levels[-1].smoother, ChebyshevSmoother)  # the coarsest never smooths


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: arrays from JAX are read-only


def _k5_inputs(bs, n, seed):
    """n >= 2 * tile, so the Pallas call runs its real kernel body.  ML and MU
    are formed once (by the JAX package) and handed to both sides; S^-1 is the
    exact inverse of A_D, as the M-form needs."""
    rng = np.random.default_rng(seed)
    l, u = rng.standard_normal((bs, bs, n)), rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 5 * np.eye(bs)[:, :, None]
    l, d, u = (m.astype(np.float32) for m in (l, d, u))
    sinv = np.ascontiguousarray(np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0).astype(np.float32))
    x = rng.standard_normal((bs, n)).astype(np.float32)
    b = rng.standard_normal((bs, n)).astype(np.float32)
    ml = np.asarray(jblock_mul(jnp.asarray(sinv), jnp.asarray(l)))
    mu = np.asarray(jblock_mul(jnp.asarray(sinv), jnp.asarray(u)))
    return l, d, u, sinv, ml, mu, x, b


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("emit_residual", [False, True])
def test_chebyshev_plain_matches_pallas(bs, emit_residual):
    l, d, u, sinv, ml, mu, x, b = _k5_inputs(bs, 16384, seed=bs)
    coef = jcoef(jnp.float32(0.3), jnp.float32(1.2), 3)
    ref = pallas_chebyshev_multisweep(
        JBlockTridiag(*map(jnp.asarray, (l, d, u))), jnp.asarray(sinv), jnp.asarray(x),
        jnp.asarray(b), coef, 3, interpret=True, emit_residual=emit_residual,
        ml=jnp.asarray(ml), mu=jnp.asarray(mu),
    )
    coef = np.asarray(coef)
    if emit_residual:
        out_x, out_r = bk.chebyshev_multisweep_residual_plain(
            _t(ml), _t(mu), _t(sinv), _t(d), _t(x), _t(b), coef
        )
        ref_x, ref_r = map(np.asarray, ref)
        np.testing.assert_allclose(out_r.numpy(), ref_r, rtol=0, atol=2e-4 * np.abs(b).max())
    else:
        out_x = bk.chebyshev_multisweep_plain(_t(ml), _t(mu), _t(sinv), _t(x), _t(b), coef)
        ref_x = np.asarray(ref)
    np.testing.assert_allclose(out_x.numpy(), ref_x, rtol=0, atol=2e-5 * np.abs(ref_x).max())


def test_chebyshev_plain_is_the_a_form_recurrence():
    """M-form equals ``z = S^-1 (b - A x); d = c_d d + c_z z; x += d`` in float64."""
    l, d, u, sinv, *_ = _k5_inputs(3, 300, seed=7)
    l, d, u = (_t(m).double() for m in (l, d, u))
    sinv = torch.linalg.inv(d.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    a = BlockTridiag(l, d, u)
    rng = np.random.default_rng(8)
    x0, b = _t(rng.standard_normal((3, 300))), _t(rng.standard_normal((3, 300)))
    coef = bk.chebyshev_coefficients(0.2, 1.1, 4).astype(np.float64)
    x, dd = x0, torch.zeros_like(x0)
    for c_d, c_z in coef:
        z = torch.einsum("ijn,jn->in", sinv, b - bk.bt_matvec_plain(a, x))
        dd = c_d * dd + c_z * z
        x = x + dd
    ml, mu = block_mul(sinv, l), block_mul(sinv, u)
    out, r = bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, d, x0, b, coef)
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r.numpy(), (b - bk.bt_matvec_plain(a, x)).numpy(), rtol=0, atol=1e-11)


def test_chebyshev_wrappers_on_cpu_equal_plain_and_check_input():
    l, d, u, sinv, ml, mu, x, b = map(_t, _k5_inputs(2, 1000, seed=3))
    coef = bk.chebyshev_coefficients(0.3, 1.2, 3)
    bk.reset_launch_counts()
    assert torch.equal(
        bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef),
        bk.chebyshev_multisweep_plain(ml, mu, sinv, x, b, coef),
    )
    for got, want in zip(
        bk.chebyshev_multisweep_residual(ml, mu, sinv, d, x, b, coef),
        bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, d, x, b, coef),
    ):
        assert torch.equal(got, want)
    assert all(v == 0 for v in bk.LAUNCHES.values())  # plain runs launch nothing
    with pytest.raises(ValueError):  # more steps than the kernel's table holds
        bk.chebyshev_multisweep(ml, mu, sinv, x, b, bk.chebyshev_coefficients(0.3, 1.2, bk.MAX_SWEEPS + 1))
    with pytest.raises(TypeError):
        bk.chebyshev_multisweep_residual(ml, mu, sinv, d, x.double(), b, coef)


@pytest.mark.parametrize("level", [0, 4])
@pytest.mark.parametrize("emit_residual", [False, True])
def test_smooth_cheb_float64_matches_jax(level, emit_residual):
    """One JAX Chebyshev hierarchy handed to both packages; level 0 is the
    flagship's CG p=8 level (Jacobi base), level 4 its first agglomerated
    level (block-Jacobi base)."""
    _, _, jprob, jh = _pair("full-32")
    h = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jh), device="cpu")
    jlv, lv = jh.levels[level], h.levels[level]
    rng = np.random.default_rng(level)
    shape = tuple(np.asarray(jprob.b).shape) if level == 0 else (2, 8)
    u, rhs = rng.standard_normal(shape), rng.standard_normal(shape)
    want = jsolvers._smooth_cheb(jlv, jnp.asarray(u), jnp.asarray(rhs), 3, False, emit_residual=emit_residual)
    got = tsolvers._smooth_cheb(lv, torch.from_numpy(u), torch.from_numpy(rhs), 3, emit_residual=emit_residual)
    for g, w in zip(got if emit_residual else (got,), want if emit_residual else (want,)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-12 * np.linalg.norm(w)


@pytest.mark.parametrize("family", ["dg", "full"])
def test_chebyshev_cuts_cycle_count_with_jax_counts(family):
    """Chebyshev V-cycles converge in fewer cycles than damped ones
    (``tests/test_smoothers.py:120-146``), and in as many as JAX's."""
    if family == "dg":
        kw = dict(n=256, max_p=3, n_dg=2, n_agg=4)
        prob, jprob = poisson_dg_hierarchy(**kw, device="cpu"), jproblems.poisson_dg_hierarchy(**kw)
    else:
        prob, jprob = poisson_full_hierarchy(n=256, device="cpu"), jproblems.poisson_full_hierarchy(n=256)
    b = prob.b
    r0 = multigrid(prob.hierarchy, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
    rc = multigrid(chebyshev_hierarchy(prob.hierarchy), torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
    jrc = jsolvers.multigrid(
        jcheb(jprob.hierarchy), jnp.zeros_like(jprob.b), jprob.b, 100, 1e-10, compute_error=False
    )
    nb = float(torch.linalg.vector_norm(b))
    assert float(rc.res_history[rc.iterations - 1]) < 1e-10 * nb
    assert rc.iterations < r0.iterations, (rc.iterations, r0.iterations)
    assert rc.iterations == int(jrc.iterations)
