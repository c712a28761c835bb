"""The torch port's float-float arithmetic (``ops/df64.py``) and kernel K6's
plain version against the JAX package's, on the CPU.

* ``ff_split``, ``ff_join``, ``ff_add`` and ``ff_mul`` equal JAX's bit for
  bit on random float64 input, with JAX called eagerly, op by op (each op
  rounds once in both);
* ``ff_bt_defect`` and ``ff_cg_defect`` on random operators equal JAX's in
  hi + lo value to ``1e-11 max|v|``, the bar JAX holds between its own
  variants (``tests/test_pallas.py:219-221``, ``tests/test_df64.py:186-191``);
  the count of elements that differ in hi or lo is reported;
* ``f64_bt_defect_stencil`` equals JAX's to 1e-15 relative (normwise);
* K6's plain version ``ff_stencil_mid_defect_plain`` against
  ``pallas_ff_stencil_mid_defect(..., interpret=True)`` and against
  ``df64._ff_mid_defect`` (bs=2, n=16,384 as the JAX test; bs=4 at a size the
  Pallas wrapper accepts), and the whole ``ff_bt_defect_stencil`` with its
  boundary splice, to ``1e-11 max|v|``;
* K12's plain version ``ff_bt_defect_plain`` against JAX's defect, on the whole
  array and on shards with their neighbours' edge columns as ghosts;
* the K6 wrapper's CPU path and its input checks.

The CUDA kernels themselves are tested in ``test_torch_cuda.py`` and, K12, in
``test_torch_ff_bt_defect.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops import df64 as jdf
from agglomerationmultigrid1d_tpu.ops.pallas import pallas_ff_stencil_mid_defect
from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

VALUE_TOL = 1e-11  # of max|v|, hi + lo value


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: arrays from JAX are read-only


def _split_np(a):
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _value(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _compare(got: tdf.FF, want: jdf.FF, what: str) -> int:
    """hi + lo value to VALUE_TOL of max|v|; returns the count of elements
    whose hi or lo differ (reported, not held)."""
    v_got, v_want = _value(got.hi.numpy(), got.lo.numpy()), _value(want.hi, want.lo)
    np.testing.assert_allclose(v_got, v_want, rtol=0, atol=VALUE_TOL * np.abs(v_want).max(), err_msg=what)
    n_diff = int(np.sum((got.hi.numpy() != np.asarray(want.hi)) | (got.lo.numpy() != np.asarray(want.lo))))
    print(f"{what}: {n_diff} of {v_want.size} elements differ in hi or lo")
    return n_diff


def _ff_pair(rng, shape, scale=1.0):
    hi, lo = _split_np(scale * rng.standard_normal(shape))
    return tdf.FF(_t(hi), _t(lo)), jdf.FF(jnp.asarray(hi), jnp.asarray(lo))


def _bit_equal(got: tdf.FF, want: jdf.FF) -> None:
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))


@pytest.mark.parametrize("scale", [1.0, 1e-8, 1e8])
def test_primitives_bit_exact(rng, scale):
    """Normal float32 range throughout (XLA on the CPU flushes subnormals to
    zero, torch does not; the solver never comes near them)."""
    a = scale * rng.standard_normal(4096) * np.exp(rng.uniform(-10, 10, 4096))
    b = scale * rng.standard_normal(4096)
    ta, ja = tdf.ff_split(_t(a)), jdf.ff_split(jnp.asarray(a))
    tb, jb = tdf.ff_split(_t(b)), jdf.ff_split(jnp.asarray(b))
    _bit_equal(ta, ja)
    np.testing.assert_array_equal(tdf.ff_join(ta).numpy(), np.asarray(jdf.ff_join(ja)))
    _bit_equal(tdf.ff_add(ta, tb), jdf.ff_add(ja, jb))
    _bit_equal(tdf.ff_mul(ta, tb), jdf.ff_mul(ja, jb))
    _bit_equal(tdf.ff_neg(ta), jdf.ff_neg(ja))
    # the split is exact and the product is float64-accurate
    np.testing.assert_array_equal(tdf.ff_join(ta).numpy(), a.astype(np.float32).astype(np.float64)
                                  + (a - a.astype(np.float32).astype(np.float64)).astype(np.float32))
    prod = tdf.ff_join(tdf.ff_mul(ta, tb)).numpy()
    exact = tdf.ff_join(ta).numpy() * tdf.ff_join(tb).numpy()
    if scale == 1.0:
        assert np.abs(prod - exact).max() <= 2.0**-44 * np.abs(exact).max()


def _random_bt(rng, bs, n, scale=1.0):
    parts = {k: rng.standard_normal((bs, bs, n)) * scale for k in ("lower", "diag", "upper")}
    split = {k: _split_np(v) for k, v in parts.items()}
    t = tdf.BlockTridiagFF(*(BlockTridiag(**{k: _t(split[k][h]) for k in parts}) for h in (0, 1)))
    j = jdf.BlockTridiagFF(*(JBlockTridiag(**{k: jnp.asarray(split[k][h]) for k in parts}) for h in (0, 1)))
    return t, j


@pytest.mark.parametrize("bs,n", [(1, 777), (2, 4096), (4, 1000)])
def test_ff_bt_defect_matches_jax(rng, bs, n):
    ta, ja = _random_bt(rng, bs, n, scale=1e3)
    tx, jx = _ff_pair(rng, (bs, n))
    tb, jb = _ff_pair(rng, (bs, n), 1e3)
    _compare(tdf.ff_bt_defect(ta, tx, tb), jdf.ff_bt_defect(ja, jx, jb), f"ff_bt_defect bs={bs} n={n}")
    _compare(tdf.ff_bt_matvec(ta, tx), jdf.ff_bt_matvec(ja, jx), f"ff_bt_matvec bs={bs} n={n}")
    _compare(tdf.ff_defect(ta, tx, tb), jdf.ff_defect(ja, jx, jb), "ff_defect dispatch")


@pytest.mark.parametrize("cols", ["whole", "first", "middle", "last"])
@pytest.mark.parametrize("bs", [1, 2, 4])
def test_k12_plain_matches_jax(rng, bs, cols):
    """K12's plain version ``ff_bt_defect_plain`` against JAX's defect of the
    whole array: on the whole array without ghosts, and on a shard's columns
    with its neighbours' edge columns of x as ghosts (what
    ``parallel.halo.edge_columns`` gives a rank; None at a ring end), equal
    bit for bit to the same columns of the whole array's defect."""
    n = 1000
    ta, ja = _random_bt(rng, bs, n, scale=1e3)
    tx, jx = _ff_pair(rng, (bs, n))
    tb, jb = _ff_pair(rng, (bs, n), 1e3)
    c0, c1 = {"whole": (0, n), "first": (0, 250), "middle": (250, 601), "last": (601, n)}[cols]
    part = tdf.BlockTridiagFF(*(BlockTridiag(*(t[..., c0:c1] for t in bt)) for bt in ta))
    gl = None if c0 == 0 else torch.stack([tx.hi[:, c0 - 1], tx.lo[:, c0 - 1]])
    gr = None if c1 == n else torch.stack([tx.hi[:, c1], tx.lo[:, c1]])
    got = tdf.FF(*bk.ff_bt_defect_plain(part, *(t[:, c0:c1].contiguous() for t in (*tx, *tb)), gl, gr))
    want = jdf.ff_bt_defect(ja, jx, jb)
    _compare(got, jdf.FF(want.hi[:, c0:c1], want.lo[:, c0:c1]), f"K12 plain bs={bs} columns [{c0}, {c1})")
    whole = tdf.ff_bt_defect(ta, tx, tb)
    assert torch.equal(got.hi, whole.hi[:, c0:c1]) and torch.equal(got.lo, whole.lo[:, c0:c1])


@pytest.mark.parametrize("p", [1, 4])
def test_ff_cg_defect_matches_jax(rng, p):
    n_nodes = 64 * p + 1
    band = rng.standard_normal((2 * p + 1, n_nodes)) * 1e4
    ta, ja = tdf.cg_band_split(_t(band)), jdf.cg_band_split(jnp.asarray(band))
    np.testing.assert_array_equal(ta.hi.numpy(), np.asarray(ja.hi))
    tx, jx = _ff_pair(rng, (n_nodes,))
    tb, jb = _ff_pair(rng, (n_nodes,), 1e4)
    _compare(tdf.ff_cg_defect(ta, tx, tb), jdf.ff_cg_defect(ja, jx, jb), f"ff_cg_defect p={p}")
    _compare(tdf.ff_defect(ta, tx, tb), jdf.ff_defect(ja, jx, jb), "ff_defect dispatch")


def _stencil_pair(rng, bs, n, bw=4):
    """A random float-float stencil operator (hi ~ 1e3, lo ~ 1e-4) in both packages."""
    raw = {(side, k): rng.standard_normal((bs, bs, bw if side != "mid" else 1)) * 1e3
           for side in ("left", "mid", "right") for k in ("lower", "diag", "upper")}
    split = {key: _split_np(v) for key, v in raw.items()}

    def make(bt_cls, conv):
        fields = {}
        for h, pre in ((0, "hi_"), (1, "lo_")):
            for side in ("left", "mid", "right"):
                fields[pre + side] = bt_cls(**{k: conv(split[(side, k)][h]) for k in ("lower", "diag", "upper")})
        return fields

    t = tdf.BTFFStencil(**make(BlockTridiag, _t), n=n)
    j = jdf.BTFFStencil(**make(JBlockTridiag, jnp.asarray), n=n)
    return t, j


@pytest.mark.parametrize("bs,n", [(2, 16384), (4, 4096)])
def test_k6_plain_matches_pallas_and_xla(rng, bs, n):
    """The interior pass alone (the packed mid column, bw = 0) against the
    Pallas body in interpret mode (n >= 2 tile, so its real body runs) and
    against the XLA formulation ``df64._ff_mid_defect``."""
    t_st, j_st = _stencil_pair(rng, bs, n)
    tx, jx = _ff_pair(rng, (bs, n))
    tb, jb = _ff_pair(rng, (bs, n), 1e3)
    mid = t_st.blocks[..., t_st.bw : t_st.bw + 1].contiguous()
    got = tdf.FF(*bk.ff_stencil_mid_defect_plain(mid, tx.hi, tx.lo, tb.hi, tb.lo))
    ref = pallas_ff_stencil_mid_defect(j_st.hi_mid, j_st.lo_mid, jx, jb, interpret=True)
    assert ref is not None, "the Pallas wrapper refused the shape"
    _compare(got, ref, f"K6 plain vs Pallas interpret bs={bs} n={n}")
    _compare(got, jdf._ff_mid_defect(j_st, jx, jb, n), f"K6 plain vs _ff_mid_defect bs={bs} n={n}")


@pytest.mark.parametrize("bs,n", [(2, 16384), (4, 4096), (2, 10)])
def test_ff_bt_defect_stencil_matches_jax(rng, bs, n):
    """The whole stencil defect, interior pass and boundary splice, through
    the K6 wrapper's CPU path; and its equality with the defect of the
    materialized operator."""
    t_st, j_st = _stencil_pair(rng, bs, n)
    tx, jx = _ff_pair(rng, (bs, n))
    tb, jb = _ff_pair(rng, (bs, n), 1e3)
    got = tdf.ff_bt_defect_stencil(t_st, tx, tb)
    _compare(got, jdf.ff_bt_defect_stencil(j_st, jx, jb), f"ff_bt_defect_stencil bs={bs} n={n}")
    assert torch.equal(tdf.ff_defect(t_st, tx, tb).hi, got.hi)
    # the stencil is the materialized operator: per-column blocks
    full = tdf.BlockTridiagFF(*(
        tdf._bt_concat([getattr(t_st, h + "_left"), tdf._bt_broadcast(getattr(t_st, h + "_mid"), n - 2 * t_st.bw),
                        getattr(t_st, h + "_right")]) for h in ("hi", "lo")
    ))
    want = tdf.ff_bt_defect(full, tx, tb)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_f64_bt_defect_stencil_matches_jax(rng):
    bs, n = 2, 4096
    t_st, j_st = _stencil_pair(rng, bs, n)
    tx, jx = _ff_pair(rng, (bs, n))
    tb, jb = _ff_pair(rng, (bs, n), 1e3)
    got, want = tdf.f64_bt_defect_stencil(t_st, tx, tb), jdf.f64_bt_defect_stencil(j_st, jx, jb)
    v_got, v_want = _value(got.hi.numpy(), got.lo.numpy()), _value(want.hi, want.lo)
    assert np.linalg.norm(v_got - v_want) <= 1e-15 * np.linalg.norm(v_want)
    # and it is the float64 defect of the joined operator
    x64, b64 = tdf.ff_join(tx).numpy(), tdf.ff_join(tb).numpy()
    blocks = {k: np.concatenate([_value(getattr(getattr(t_st, "hi_" + s), k).numpy(),
                                        getattr(getattr(t_st, "lo_" + s), k).numpy())
                                 if s != "mid" else np.repeat(_value(getattr(t_st.hi_mid, k).numpy(),
                                                                     getattr(t_st.lo_mid, k).numpy()), n - 8, -1)
                                 for s in ("left", "mid", "right")], -1) for k in ("lower", "diag", "upper")}
    xm = np.pad(x64, ((0, 0), (1, 0)))[:, :-1]
    xp = np.pad(x64, ((0, 0), (0, 1)))[:, 1:]
    ref = b64 - (np.einsum("ijn,jn->in", blocks["diag"], x64) + np.einsum("ijn,jn->in", blocks["lower"], xm)
                 + np.einsum("ijn,jn->in", blocks["upper"], xp))
    assert np.linalg.norm(v_got - ref) <= 1e-14 * np.linalg.norm(ref)


def test_ff_norm_and_stencil_blocks(rng):
    tx, jx = _ff_pair(rng, (2, 100))
    np.testing.assert_allclose(float(tdf.ff_norm(tx)), float(jdf.ff_norm(jx)), rtol=1e-15)
    t_st, _ = _stencil_pair(rng, 3, 64, bw=2)
    blk = t_st.blocks
    assert tuple(blk.shape) == (2, 3, 3, 3, 5) and blk.is_contiguous() and blk.dtype == torch.float32
    # axis 1 is diag, lower, upper; the trailing axis left, mid, right
    assert torch.equal(blk[0, 0, :, :, 2], t_st.hi_mid.diag[:, :, 0])
    assert torch.equal(blk[1, 1, :, :, :2], t_st.lo_left.lower)
    assert torch.equal(blk[0, 2, :, :, 3:], t_st.hi_right.upper)


def test_k6_wrapper_on_cpu_and_input_checks(rng):
    t_st, _ = _stencil_pair(rng, 2, 256)
    tx, _ = _ff_pair(rng, (2, 256))
    tb, _ = _ff_pair(rng, (2, 256))
    bk.reset_launch_counts()
    got = bk.ff_stencil_mid_defect(t_st.blocks, tx.hi, tx.lo, tb.hi, tb.lo)
    want = bk.ff_stencil_mid_defect_plain(t_st.blocks, tx.hi, tx.lo, tb.hi, tb.lo)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bk.LAUNCHES["ff_stencil_mid_defect"] == 0  # plain runs launch nothing
    with pytest.raises(TypeError):
        bk.ff_stencil_mid_defect(t_st.blocks, tx.hi.double(), tx.lo, tb.hi, tb.lo)
    with pytest.raises(ValueError):  # a vector of another shape
        bk.ff_stencil_mid_defect(t_st.blocks, tx.hi, tx.lo[:, :-1], tb.hi, tb.lo)
    with pytest.raises(ValueError):  # non-contiguous
        bk.ff_stencil_mid_defect(t_st.blocks, tx.hi.T.contiguous().T, tx.lo, tb.hi, tb.lo)
    with pytest.raises(ValueError):  # not a packed stencil
        bk.ff_stencil_mid_defect(t_st.blocks[0], tx.hi, tx.lo, tb.hi, tb.lo)
    with pytest.raises(ValueError):  # too few columns for the boundary windows
        bk.ff_stencil_mid_defect(t_st.blocks, tx.hi[:, :8].contiguous(), tx.lo[:, :8].contiguous(),
                                 tb.hi[:, :8].contiguous(), tb.lo[:, :8].contiguous())


def test_jax_stencil_with_numpy_leaves_carries_across(rng):
    """``utils.convert`` reads a JAX stencil operator by field name; the
    converted operator's defect equals the original's."""
    from agglomerationmultigrid1d_tpu_torch.utils import convert

    _, j_st = _stencil_pair(rng, 2, 512)
    t_st = convert._ff_operator(jax.tree_util.tree_map(np.asarray, j_st), "cpu")
    tx, jx = _ff_pair(rng, (2, 512))
    tb, jb = _ff_pair(rng, (2, 512), 1e3)
    _compare(tdf.ff_bt_defect_stencil(t_st, tx, tb), jdf.ff_bt_defect_stencil(j_st, jx, jb), "converted stencil")
