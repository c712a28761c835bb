"""The torch port's float64 block operators and transfers against the JAX
package's, on the same random inputs (made with numpy), to 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.ops import block_tridiag as jbt
from agglomerationmultigrid1d_tpu.ops.coarse_solve import _dense_solve as jdense_solve
from agglomerationmultigrid1d_tpu.ops.coarse_solve import make_coarse_solver as jmake_coarse_solver
from agglomerationmultigrid1d_tpu.ops import transfer_ops as jto
from agglomerationmultigrid1d_tpu.ops.block_diag import BlockDiag as JBlockDiag
from agglomerationmultigrid1d_tpu.ops.shifts import shift as jshift
from agglomerationmultigrid1d_tpu_torch.ops import block_tridiag as tbt
from agglomerationmultigrid1d_tpu_torch.ops.coarse_solve import coarse_solve, make_coarse_solver
from agglomerationmultigrid1d_tpu_torch.ops import transfer_ops as tto
from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag, bd_matvec
from agglomerationmultigrid1d_tpu_torch.ops.shifts import shift

RTOL = 1e-12


def _close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def _pair_bt(rng, bs, n):
    l, d, u = (rng.standard_normal((bs, bs, n)) for _ in range(3))
    return tbt.BlockTridiag(*map(torch.from_numpy, (l, d, u))), jbt.BlockTridiag(
        *map(jnp.asarray, (l, d, u))
    )


def _pair(rng, *shape):
    a = rng.standard_normal(shape)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("d", [-2, -1, 0, 1, 3])
def test_shift(rng, d):
    t, j = _pair(rng, 3, 2, 17)
    np.testing.assert_array_equal(shift(t, d).numpy(), np.asarray(jshift(j, d)))


@pytest.mark.parametrize("bs", [1, 2, 4, 9])
def test_block_mul_and_bt_matvec(rng, bs):
    (ta, ja), (tb, jb) = _pair(rng, bs, bs, 50), _pair(rng, bs, bs, 50)
    _close(tbt.block_mul(ta, tb), jbt.block_mul(ja, jb))
    top, jop = _pair_bt(rng, bs, 50)
    tx, jx = _pair(rng, bs, 50)
    _close(tbt.bt_matvec(top, tx), jbt.bt_matvec(jop, jx))
    _close(bd_matvec(BlockDiag(ta), tx), jnp.einsum("ijn,jn->in", ja, jx))


@pytest.mark.parametrize("bs", [2, 4])
def test_block_tridiag_products(rng, bs):
    (ta, ja), (tb, jb) = _pair_bt(rng, bs, 40), _pair_bt(rng, bs, 40)
    tm, jm = _pair(rng, bs, bs, 40)
    _close(tbt.bt_mul_bt(ta, tb), jbt.bt_mul_bt(ja, jb))
    _close(tbt.bd_mul_bt(BlockDiag(tm), ta), jbt.bd_mul_bt(JBlockDiag(jm), ja))
    _close(tbt.bt_mul_bd(ta, BlockDiag(tm)), jbt.bt_mul_bd(ja, JBlockDiag(jm)))
    _close(tbt.bt_sub(ta, tb), jbt.bt_sub(ja, jb))
    np.testing.assert_array_equal(tbt.bt_to_dense(ta).numpy(), np.asarray(jbt.bt_to_dense(ja)))


@pytest.mark.parametrize("r,bs_f,bs_c", [(1, 4, 2), (2, 2, 2), (4, 2, 2), (4, 4, 2)])
def test_block_prolong_restrict_galerkin(rng, r, bs_f, bs_c):
    nc = 24
    tl, jl = _pair(rng, r, bs_f, bs_c, nc)
    txc, jxc = _pair(rng, bs_c, nc)
    trf, jrf = _pair(rng, bs_f, r * nc)
    tp, jp = tto.BlockProlong(tl), jto.BlockProlong(jl)
    _close(tto.bp_prolong(tp, txc), jto.bp_prolong(jp, jxc))
    _close(tto.bp_restrict(tp, trf), jto.bp_restrict(jp, jrf))
    tx, jx = _pair_bt(rng, bs_f, r * nc)
    _close(tto.bp_galerkin(tp, tx), jto.bp_galerkin(jp, jx))


def test_block_prolong_constant(rng):
    te, je = _pair(rng, 4, 2)
    tp, jp = tto.block_prolong_constant(te, 9), jto.block_prolong_constant(je, 9)
    np.testing.assert_array_equal(tp.blocks.numpy(), np.asarray(jp.blocks))


def test_coarse_solve(rng):
    n = 40
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    tf = make_coarse_solver(torch.from_numpy(a))
    jf = jmake_coarse_solver(jnp.asarray(a))
    np.testing.assert_array_equal(tf.a_inv.numpy(), np.asarray(jf.a_inv))
    _close(coarse_solve(tf, torch.from_numpy(b)), jdense_solve(jf, jnp.asarray(b)))
