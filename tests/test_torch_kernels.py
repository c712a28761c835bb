"""The torch port's block kernels K1-K3 on the CPU: their plain versions
against the JAX package's Pallas kernels (interpret mode), and the wrappers'
CPU path and input checks.  The CUDA kernels themselves are tested in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops.block_tridiag import block_mul as jblock_mul
from agglomerationmultigrid1d_tpu.ops.pallas import (
    pallas_block_jacobi_multisweep,
    pallas_block_jacobi_multisweep_residual,
    pallas_bt_matvec,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk


def _random_ops(rng, bs, n):
    """Block-tridiagonal (lower, diag, upper) as float32 numpy, diagonally
    dominant, with S^-1 the exact inverse of the diagonal blocks."""
    l = rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u = rng.standard_normal((bs, bs, n))
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 5 * np.eye(bs)[:, :, None]
    l, d, u = (m.astype(np.float32) for m in (l, d, u))
    sinv = np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0).astype(np.float32)
    return l, d, u, np.ascontiguousarray(sinv)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: arrays from JAX are read-only


@pytest.mark.parametrize("bs,n", [(2, 512), (4, 1024), (9, 640)])
def test_bt_matvec_plain_matches_pallas(rng, bs, n):
    l, d, u, _ = _random_ops(rng, bs, n)
    x = rng.standard_normal((bs, n)).astype(np.float32)
    ref = pallas_bt_matvec(JBlockTridiag(*map(jnp.asarray, (l, d, u))), jnp.asarray(x), interpret=True)
    out = bk.bt_matvec_plain(BlockTridiag(_t(l), _t(d), _t(u)), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def _multisweep_inputs(rng, bs=4, n=16384):
    """n >= 2 * tile, so the Pallas call runs its real kernel body.  ML and MU
    are formed once (by the JAX package) and handed to both sides."""
    l, d, u, sinv = _random_ops(rng, bs, n)
    x = rng.standard_normal((bs, n)).astype(np.float32)
    b = rng.standard_normal((bs, n)).astype(np.float32)
    ml = np.asarray(jblock_mul(jnp.asarray(sinv), jnp.asarray(l)))
    mu = np.asarray(jblock_mul(jnp.asarray(sinv), jnp.asarray(u)))
    return l, d, u, sinv, ml, mu, x, b


def test_multisweep_plain_matches_pallas(rng):
    l, d, u, sinv, ml, mu, x, b = _multisweep_inputs(rng)
    a = JBlockTridiag(*map(jnp.asarray, (l, d, u)))
    ref = pallas_block_jacobi_multisweep(
        a, jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b), n_sweeps=3, interpret=True,
        ml=jnp.asarray(ml), mu=jnp.asarray(mu),
    )
    out = bk.multisweep_plain(_t(ml), _t(mu), _t(sinv), _t(x), _t(b), n_sweeps=3)
    ref = np.asarray(ref)
    # same operation order in float32; a few ulps of max|x| apart
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_multisweep_residual_plain_matches_pallas(rng):
    l, d, u, sinv, ml, mu, x, b = _multisweep_inputs(rng)
    a = JBlockTridiag(*map(jnp.asarray, (l, d, u)))
    ref_x, ref_r = pallas_block_jacobi_multisweep_residual(
        a, jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b), n_sweeps=3, interpret=True,
        ml=jnp.asarray(ml), mu=jnp.asarray(mu),
    )
    out_x, out_r = bk.multisweep_residual_plain(
        _t(ml), _t(mu), _t(sinv), _t(d), _t(x), _t(b), n_sweeps=3
    )
    ref_x, ref_r = np.asarray(ref_x), np.asarray(ref_r)
    np.testing.assert_allclose(out_x.numpy(), ref_x, rtol=0, atol=2e-6 * np.abs(ref_x).max())
    np.testing.assert_allclose(out_r.numpy(), ref_r, rtol=0, atol=2e-5 * np.abs(b).max())


def test_multisweep_plain_is_damped_block_jacobi(rng):
    """M-form equals the A-form sweep ``x + alpha S^-1 (b - A x)`` it replaces."""
    bs, n = 3, 300
    l, d, u, sinv, *_ = _random_ops(rng, bs, n)
    l, d, u, sinv = (m.astype(np.float64) for m in (l, d, u, sinv))
    sinv = np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0).copy()
    a = BlockTridiag(_t(l), _t(d), _t(u))
    x0, b = _t(rng.standard_normal((bs, n))), _t(rng.standard_normal((bs, n)))
    ml, mu = block_mul(_t(sinv), a.lower), block_mul(_t(sinv), a.upper)
    x = x0
    for _ in range(3):
        x = x + (2.0 / 3.0) * torch.einsum("ijn,jn->in", _t(sinv), b - bk.bt_matvec_plain(a, x))
    out, r = bk.multisweep_residual_plain(ml, mu, _t(sinv), a.diag, x0, b, n_sweeps=3)
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r.numpy(), (b - bk.bt_matvec_plain(a, x)).numpy(), rtol=0, atol=1e-11)


def _torch_inputs(rng, bs=4, n=1000):
    l, d, u, sinv, ml, mu, x, b = _multisweep_inputs(rng, bs, n)
    return tuple(_t(m) for m in (l, d, u, sinv, ml, mu, x, b))


def test_wrappers_on_cpu_equal_plain(rng):
    l, d, u, sinv, ml, mu, x, b = _torch_inputs(rng)
    a = BlockTridiag(l, d, u)
    bk.reset_launch_counts()
    assert torch.equal(bk.fused_bt_matvec(a, x), bk.bt_matvec_plain(a, x))
    assert torch.equal(bk.multisweep(ml, mu, sinv, x, b), bk.multisweep_plain(ml, mu, sinv, x, b))
    for got, want in zip(
        bk.multisweep_residual(ml, mu, sinv, d, x, b),
        bk.multisweep_residual_plain(ml, mu, sinv, d, x, b),
    ):
        assert torch.equal(got, want)
    assert all(v == 0 for v in bk.LAUNCHES.values())  # plain runs launch nothing


@pytest.mark.parametrize("bad", ["float64", "shape", "noncontiguous", "sweeps"])
def test_wrappers_reject_bad_input(rng, bad):
    l, d, u, sinv, ml, mu, x, b = _torch_inputs(rng, 2, 64)
    n_sweeps = 3
    if bad == "float64":
        x = x.double()
    elif bad == "shape":
        b = b[:, :-1]
    elif bad == "noncontiguous":
        x = x.T.contiguous().T
    else:
        n_sweeps = bk.MAX_SWEEPS + 1
    err = TypeError if bad == "float64" else ValueError
    with pytest.raises(err):
        bk.multisweep_residual(ml, mu, sinv, d, x, b, n_sweeps=n_sweeps)
    if bad != "sweeps":
        with pytest.raises(err):
            bk.multisweep(ml, mu, sinv, x, b)
    if bad in ("float64", "noncontiguous"):
        with pytest.raises(err):
            bk.fused_bt_matvec(BlockTridiag(l, d, u), x)
