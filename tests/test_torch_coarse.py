"""The torch port's block-cyclic-reduction coarse solve against the JAX
package's, on the CPU: ``make_bt_coarse_solver`` + ``coarse_solve`` on the same
operators (bs = 1, 2, 4; odd and even block counts, as
``tests/test_coarse.py:36``) to 1e-12 relative, and against a dense solve;
and the hierarchy's choice of cyclic reduction above ``DENSE_COARSE_MAX``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops.coarse_solve import coarse_solve as jcoarse_solve
from agglomerationmultigrid1d_tpu.ops.coarse_solve import make_bt_coarse_solver as jmake
from agglomerationmultigrid1d_tpu_torch.models import poisson_dg_hierarchy
from agglomerationmultigrid1d_tpu_torch.models.hierarchy import DENSE_COARSE_MAX
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, bt_to_dense
from agglomerationmultigrid1d_tpu_torch.ops.coarse_solve import (
    BTCoarseSolver,
    CoarseSolver,
    coarse_solve,
    make_bt_coarse_solver,
)
from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype


def _operator(rng, bs, n):
    """A random block-diagonally dominant block-tridiagonal operator (as
    ``tests/test_coarse.py`` builds them), float64 numpy."""
    lower = rng.standard_normal((bs, bs, n))
    upper = rng.standard_normal((bs, bs, n))
    diag = rng.standard_normal((bs, bs, n)) + 4.0 * bs * np.eye(bs)[:, :, None]
    lower[:, :, 0] = 0.0
    upper[:, :, -1] = 0.0
    return lower, diag, upper


@pytest.mark.parametrize("bs", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_bcr_matches_jax_and_dense(rng, bs, n):
    l, d, u = _operator(rng, bs, n)
    t_a = BlockTridiag(*map(torch.from_numpy, (l, d, u)))
    solver = make_bt_coarse_solver(t_a)
    j_solver = jmake(JBlockTridiag(*map(jnp.asarray, (l, d, u))))
    b = rng.standard_normal(bs * n)
    got = coarse_solve(solver, torch.from_numpy(b)).numpy()
    want = np.asarray(jcoarse_solve(j_solver, jnp.asarray(b)))
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    dense = np.linalg.solve(bt_to_dense(t_a).numpy(), b)
    assert np.linalg.norm(got - dense) <= 1e-12 * np.linalg.norm(dense)
    # the factors equal JAX's
    for ours, theirs in ((solver.f, j_solver.f), (solver.dinv_odd, j_solver.dinv_odd)):
        assert len(ours) == len(theirs)
        for x, y in zip(ours, theirs):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-13, atol=1e-13)


def test_bcr_ignores_unused_corner_blocks(rng):
    """``lower[..., 0]`` and ``upper[..., -1]`` lie outside the operator."""
    l, d, u = _operator(rng, 2, 33)
    l2, u2 = l.copy(), u.copy()
    l2[:, :, 0] = 5.0
    u2[:, :, -1] = -3.0
    b = torch.from_numpy(rng.standard_normal(66))
    x1 = coarse_solve(make_bt_coarse_solver(BlockTridiag(*map(torch.from_numpy, (l, d, u)))), b)
    x2 = coarse_solve(make_bt_coarse_solver(BlockTridiag(*map(torch.from_numpy, (l2, d, u2)))), b)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-14, atol=1e-14)


def test_hierarchy_uses_bcr_above_dense_max():
    """A coarsest level above ``DENSE_COARSE_MAX`` DoF gets cyclic reduction
    (the port raised ``NotImplementedError`` there before); below, the dense
    inverse.  A float32 cast keeps the factorization's type."""
    big = poisson_dg_hierarchy(n=2048, max_p=1, n_dg=1, device="cpu")
    assert big.hierarchy.levels[-1].a.n_dof > DENSE_COARSE_MAX
    c = big.hierarchy.coarse
    assert isinstance(c, BTCoarseSolver) and c.n == 4096
    a = big.hierarchy.levels[-1].a
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(c.n))
    x = coarse_solve(c, b)
    # backward error: the c_dir = 1000 n penalty makes the operator
    # ill-conditioned, so the forward error of any float64 solve is larger
    a_dense = bt_to_dense(a).numpy()
    scale = np.linalg.norm(a_dense) * np.linalg.norm(x.numpy())
    assert np.linalg.norm(a_dense @ x.numpy() - b.numpy()) <= 1e-14 * scale
    c32 = hierarchy_astype(c, torch.float32)
    assert isinstance(c32, BTCoarseSolver) and c32.root_inv.dtype == torch.float32
    x32 = coarse_solve(c32, b.float()).double().numpy()
    assert np.linalg.norm(a_dense @ x32 - b.numpy()) <= 1e-5 * scale
    small = poisson_dg_hierarchy(n=64, max_p=1, n_dg=1, device="cpu")
    assert isinstance(small.hierarchy.coarse, CoarseSolver)
