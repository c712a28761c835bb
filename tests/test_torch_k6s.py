"""Kernel K6s, K6 on one shard of an element-sharded vector
(``ops.kernels.block_kernels.ff_stencil_shard_defect``), on the CPU through
its plain version, and the sharded float-float stencil defect
(``ops.df64.ff_bt_defect_stencil(..., col0=)``).

* Four shards of unequal widths, none a multiple of the stencil's bw = 4
  (one narrower than bw, inside the left boundary columns; one that holds
  all the right boundary columns), each with its global column offset and
  its neighbours' edge columns of x as ghosts (none at the ring ends),
  stitched: equal to the whole array's defect bit for bit, hi and lo, at
  bs = 2 and 4;
* a ghost of zeros equals a missing one (a ring end), exactly;
* the whole-array call (no offset, no ghosts) of the interior pass alone
  equals the JAX package's fenced ``_ff_mid_defect`` with 0 elements
  different (G9), and the whole defect its ``ff_bt_defect_stencil`` to
  1e-11 of max|r| in hi + lo;
* the wrapper on CPU tensors launches nothing and checks its arguments.

The CUDA kernel is held to this plain version in ``test_torch_cuda.py``
(marked ``cuda``) and in ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops import df64 as jdf
from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

WIDTHS = (3, 250, 500, 248)  # four shards of n = 1001 columns
BW = 4


def _split(a):
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _stencil(rng, bs, n, bw=BW):
    """A random float-float stencil operator (hi ~ 1e3, lo ~ 1e-4) in both packages."""
    split = {(side, k): _split(rng.standard_normal((bs, bs, bw if side != "mid" else 1)) * 1e3)
             for side in ("left", "mid", "right") for k in ("lower", "diag", "upper")}

    def make(bt_cls, conv):
        return {pre + side: bt_cls(**{k: conv(split[(side, k)][h]) for k in ("lower", "diag", "upper")})
                for h, pre in ((0, "hi_"), (1, "lo_")) for side in ("left", "mid", "right")}

    return (tdf.BTFFStencil(**make(BlockTridiag, lambda a: torch.from_numpy(a.copy())), n=n),
            jdf.BTFFStencil(**make(JBlockTridiag, jnp.asarray), n=n))


def _ff(rng, shape, scale=1.0):
    hi, lo = _split(scale * rng.standard_normal(shape))
    return tdf.FF(torch.from_numpy(hi), torch.from_numpy(lo))


def _shards(x: tdf.FF, b: tdf.FF, widths):
    """Per shard: (col0, x, b, ghost_left, ghost_right), ghosts cut from the
    neighbours' edge columns ((2, bs): hi, then lo), None at the ring ends."""
    n = x.hi.shape[-1]
    out, c0 = [], 0
    for w in widths:
        c1 = c0 + w

        def cut(v, lo, hi):
            return tdf.FF(v.hi[:, lo:hi].contiguous(), v.lo[:, lo:hi].contiguous())

        def ghost(c):
            return torch.stack([x.hi[:, c], x.lo[:, c]]).contiguous() if 0 <= c < n else None

        out.append((c0, cut(x, c0, c1), cut(b, c0, c1), ghost(c0 - 1), ghost(c1)))
        c0 = c1
    return out


@pytest.mark.parametrize("bs", [2, 4])
def test_four_stitched_shards_equal_the_whole_array(rng, bs):
    n = sum(WIDTHS)
    st, _ = _stencil(rng, bs, n)
    x, b = _ff(rng, (bs, n)), _ff(rng, (bs, n), 1e3)
    whole = bk.ff_stencil_mid_defect_plain(st.blocks, x.hi, x.lo, b.hi, b.lo)
    parts = [bk.ff_stencil_shard_defect(st.blocks, xs.hi, xs.lo, bs_.hi, bs_.lo, c0, n, gl, gr)
             for c0, xs, bs_, gl, gr in _shards(x, b, WIDTHS)]
    for k in range(2):
        np.testing.assert_array_equal(torch.cat([p[k] for p in parts], dim=1).numpy(), whole[k].numpy())
    # the solvers' route: the stencil operator's defect at a shard's offset
    c0, xs, bs_, gl, gr = _shards(x, b, WIDTHS)[2]
    got = tdf.ff_bt_defect_stencil(st, xs, bs_, c0, gl, gr)
    np.testing.assert_array_equal(got.hi.numpy(), whole[0][:, c0 : c0 + WIDTHS[2]].numpy())
    np.testing.assert_array_equal(got.lo.numpy(), whole[1][:, c0 : c0 + WIDTHS[2]].numpy())


def test_zero_ghosts_equal_a_ring_end(rng):
    n = 64
    st, _ = _stencil(rng, 2, n)
    x, b = _ff(rng, (2, 30)), _ff(rng, (2, 30), 1e3)
    zero = torch.zeros((2, 2))
    for c0 in (0, 17, 34):
        a = bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, c0, n, None, None)
        z = bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, c0, n, zero, zero)
        for k in range(2):
            np.testing.assert_array_equal(a[k].numpy(), z[k].numpy())


@pytest.mark.parametrize("bs,n", [(2, 16384), (4, 4096)])
def test_whole_array_call_matches_jax(rng, bs, n):
    """The interior pass alone (the packed mid column, bw = 0) against JAX's
    fenced ``_ff_mid_defect``: 0 elements differ; the whole defect (with the
    boundary columns) against JAX's ``ff_bt_defect_stencil`` in value."""
    t_st, j_st = _stencil(rng, bs, n)
    x, b = _ff(rng, (bs, n)), _ff(rng, (bs, n), 1e3)
    jx, jb = jdf.FF(jnp.asarray(x.hi.numpy()), jnp.asarray(x.lo.numpy())), jdf.FF(jnp.asarray(b.hi.numpy()),
                                                                              jnp.asarray(b.lo.numpy()))
    mid = t_st.blocks[..., BW : BW + 1].contiguous()
    got = bk.ff_stencil_mid_defect_plain(mid, x.hi, x.lo, b.hi, b.lo)
    want = jdf._ff_mid_defect(j_st, jx, jb, n)
    assert int(np.sum((got[0].numpy() != np.asarray(want.hi)) | (got[1].numpy() != np.asarray(want.lo)))) == 0
    got = tdf.ff_bt_defect_stencil(t_st, x, b)
    want = jdf.ff_bt_defect_stencil(j_st, jx, jb)
    v_got = got.hi.numpy().astype(np.float64) + got.lo.numpy()
    v_want = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
    np.testing.assert_allclose(v_got, v_want, rtol=0, atol=1e-11 * np.abs(v_want).max())


def test_k6s_wrapper_on_cpu_and_input_checks(rng):
    n = 64
    st, _ = _stencil(rng, 2, n)
    x, b = _ff(rng, (2, 32)), _ff(rng, (2, 32), 1e3)
    g = torch.zeros((2, 2))
    bk.reset_launch_counts()
    bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, 32, n, g, None)
    assert bk.LAUNCHES["ff_stencil_shard_defect"] == 0  # plain runs launch nothing
    with pytest.raises(ValueError, match="not within"):  # past the array's end
        bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, 33, n, g, None)
    with pytest.raises(ValueError, match="ghost column"):
        bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, 0, n, torch.zeros((2, 3)), None)
    with pytest.raises(TypeError):
        bk.ff_stencil_shard_defect(st.blocks, x.hi, x.lo, b.hi, b.lo, 0, n, g.double(), None)
    with pytest.raises(ValueError, match="boundary windows"):
        bk.ff_stencil_shard_defect(st.blocks, x.hi[:, :4].contiguous(), x.lo[:, :4].contiguous(),
                                   b.hi[:, :4].contiguous(), b.lo[:, :4].contiguous(), 0, 8, None, None)
