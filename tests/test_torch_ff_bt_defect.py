"""Kernel K12 (``ff_bt_defect_kernel``): the float-float defect ``r = b - A x``
of a materialised block-tridiagonal operator (``ops.df64.BlockTridiagFF``).

On the CPU (these count everywhere):

* ``ff_bt_defect_plain`` equals ``ops.df64.ff_bt_defect`` (the CPU path) and
  an independent chain of ``ff_mul`` / ``ff_neg`` / ``ff_add`` in the
  kernel's order, bit for bit (signed zeros included), at every block size
  of ``SUPPORTED_BLOCK_SIZES``, with and without ghost columns, on
  contiguous and strided operator streams and vectors with wide exponents
  and zero and signed-zero entries; the CPU path launches nothing;
* four stitched shards, each with its neighbours' edge columns as ghosts,
  equal the whole array;
* the wrapper refuses what the kernel does not take.

On the card (marker ``cuda``; skipped without one): the kernel against its
plain version bit for bit at every block size and at column counts around
its 256-thread block, with every operator layout and ghost form; four
stitched shards against the whole launch; ``ff_defect`` on a
``BlockTridiagFF`` is one K12 launch and no other kernel; a block size
without an instance raises; and a small ``multigrid_true`` gives the same
residual history through K12 as through the plain chain.  The JAX package's
defect is compared in ``tests/test_torch_df64.py``.  This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_ff_bt_defect.py
"""

import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

SIZES = bk.SUPPORTED_BLOCK_SIZES
LAYOUTS = ("contiguous", "n_major", "every_other")
GHOSTS = ("none", "both", "left")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    return torch.device("cuda")


def _wide(rng, shape):
    """float64 values over 2^-20..2^20 with 5 % +0.0 and 5 % -0.0 entries."""
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-20, 21, shape))
    u = rng.random(shape)
    v[u < 0.05] = 0.0
    v[(u >= 0.05) & (u < 0.1)] = -0.0
    return v


def _pair(v, device):
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    lo[v == 0] = v[v == 0]  # a signed zero's tail keeps its sign
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _laid_out(t: torch.Tensor, layout: str) -> torch.Tensor:
    """``t`` (an operator stream (bs, bs, n) or a vector (bs, n)) laid out
    as asked: contiguous, n-major (a permuted (n, ...) tensor: a CG-topped
    chain's vectors after the seam transfer), or every other column of a
    tensor twice as wide."""
    if layout == "contiguous":
        return t.contiguous()
    if layout == "n_major":
        return t.movedim(-1, 0).contiguous().movedim(0, -1)
    wide = torch.zeros(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype, device=t.device)
    wide[..., ::2] = t
    return wide[..., ::2]


def _problem(seed, bs, n, device="cpu", layout="contiguous"):
    """A random float-float operator and x, b pairs, ``(a, x_hi, x_lo, b_hi,
    b_lo)``, every array in ``layout``."""
    rng = np.random.default_rng(seed)
    parts = {k: _pair(_wide(rng, (bs, bs, n)), device) for k in ("lower", "diag", "upper")}
    a = tdf.BlockTridiagFF(*(BlockTridiag(**{k: _laid_out(v[h], layout) for k, v in parts.items()}) for h in (0, 1)))
    vecs = (*_pair(_wide(rng, (bs, n)), device), *_pair(_wide(rng, (bs, n)), device))
    return (a, *(_laid_out(v, layout) for v in vecs))


def _ghosts(seed, bs, which, device="cpu"):
    """``(ghost_left, ghost_right)``, each (2, bs) or None, per ``which``."""
    rng = np.random.default_rng(seed + 1)

    def one():
        return torch.stack(_pair(_wide(rng, (bs,)), device))

    return {"none": (None, None), "both": (one(), one()), "left": (one(), None)}[which]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(got, want) -> bool:
    """hi and lo equal bit for bit (so +0.0 and -0.0 differ)."""
    return all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def _chain(a, x_hi, x_lo, b_hi, b_lo, ghost_left, ghost_right):
    """The kernel's order from the float-float primitives: acc = b; for diag
    on x, lower on x_{k-1}, upper on x_{k+1}, and block column j ascending,
    acc = ff_add(acc, ff_neg(ff_mul(A[:, j], v[j])))."""
    def neighbour(t, g, side):
        edge = torch.zeros_like(t[:, :1]) if g is None else g[:, None]
        return torch.cat([edge, t[:, :-1]], 1) if side < 0 else torch.cat([t[:, 1:], edge], 1)

    gl, gr = ((None, None) if g is None else (g[0], g[1]) for g in (ghost_left, ghost_right))
    vs = {"diag": (x_hi, x_lo), "lower": (neighbour(x_hi, gl[0], -1), neighbour(x_lo, gl[1], -1)),
          "upper": (neighbour(x_hi, gr[0], 1), neighbour(x_lo, gr[1], 1))}
    acc = tdf.FF(b_hi, b_lo)
    for k in ("diag", "lower", "upper"):
        m_hi, m_lo = getattr(a.hi, k), getattr(a.lo, k)
        v_hi, v_lo = vs[k]
        for j in range(m_hi.shape[1]):
            t = tdf.ff_mul(tdf.FF(m_hi[:, j], m_lo[:, j]), tdf.FF(v_hi[j : j + 1], v_lo[j : j + 1]))
            acc = tdf.ff_add(acc, tdf.ff_neg(t))
    return acc.hi, acc.lo


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "n_major"])
@pytest.mark.parametrize("ghosts", ["none", "both"])
@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("bs", SIZES)
def test_plain_equals_df64_and_the_primitive_chain(bs, n, ghosts, layout):
    a, *v = _problem(bs * 1000 + n, bs, n, layout=layout)
    gl, gr = _ghosts(bs, bs, ghosts)
    bk.reset_launch_counts()
    plain = bk.ff_bt_defect_plain(a, *v, gl, gr)
    via_df64 = tdf.ff_bt_defect(a, tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3]), gl, gr)
    assert _same(plain, _chain(a, *v, gl, gr))
    assert _same(plain, via_df64)
    assert _same(plain, bk.ff_bt_defect(a, *v, gl, gr))  # the wrapper's CPU path
    if ghosts == "none":
        assert _same(plain, tdf.ff_defect(a, tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3])))
    assert bk.LAUNCHES["ff_bt_defect"] == 0


def _stitched(defect, a, x_hi, x_lo, b_hi, b_lo, cuts):
    """The defect of each shard ``[c0, c1)`` with its neighbours' edge
    columns of x as ghosts (None at the two ends), concatenated."""
    outs = []
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        cols = slice(c0, c1)
        part = tdf.BlockTridiagFF(*(BlockTridiag(*(t[..., cols] for t in bt)) for bt in a))
        gl = None if c0 == 0 else torch.stack([x_hi[:, c0 - 1], x_lo[:, c0 - 1]])
        gr = None if c1 == x_hi.shape[1] else torch.stack([x_hi[:, c1], x_lo[:, c1]])
        outs.append(defect(part, *(t[:, cols].contiguous() for t in (x_hi, x_lo, b_hi, b_lo)), gl, gr))
    return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(2))


@pytest.mark.parametrize("bs", SIZES)
def test_four_stitched_shards_equal_the_whole_array(bs):
    n = 1000
    a, *v = _problem(bs, bs, n)
    whole = bk.ff_bt_defect_plain(a, *v)
    assert _same(_stitched(bk.ff_bt_defect_plain, a, *v, [0, 1, 333, 700, n]), whole)


def _bad(case):
    a, x_hi, x_lo, b_hi, b_lo = _problem(0, 2, 16)
    if case == "vector":
        x_lo = x_lo[:, :15]
    elif case == "stream":
        a = a._replace(lo=a.lo._replace(upper=torch.zeros(2, 2, 17)))
    elif case == "empty_off_diagonal":  # a slim level's operator: no materialised lower stream
        a = a._replace(hi=a.hi._replace(lower=torch.zeros(2, 2, 0)))
    elif case == "ghost":
        return (a, x_hi, x_lo, b_hi, b_lo, torch.zeros(2), None)
    elif case == "dtype":
        b_hi = b_hi.double()
    elif case == "strided_ghost":
        return (a, x_hi, x_lo, b_hi, b_lo, torch.zeros(2, 2).T, None)
    elif case == "not_a_matrix":
        x_hi = x_hi.reshape(-1)
    return (a, x_hi, x_lo, b_hi, b_lo, None, None)


@pytest.mark.parametrize("case,error", [
    ("vector", ValueError), ("stream", ValueError), ("empty_off_diagonal", ValueError), ("ghost", ValueError),
    ("dtype", TypeError), ("strided_ghost", ValueError), ("not_a_matrix", ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    with pytest.raises(error):
        bk.ff_bt_defect(*_bad(case))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 100003])
@pytest.mark.parametrize("bs", SIZES)
def test_cuda_k12_equals_plain(cuda, bs, n):
    """Every operator layout and ghost form; one launch each, bit for bit."""
    calls = 0
    bk.reset_launch_counts()
    for layout in LAYOUTS:
        a, *v = _problem(bs * 7919 + n, bs, n, cuda, layout)
        for ghosts in GHOSTS:
            gl, gr = _ghosts(n, bs, ghosts, cuda)
            got, want = bk.ff_bt_defect(a, *v, gl, gr), bk.ff_bt_defect_plain(a, *v, gl, gr)
            torch.cuda.synchronize()
            calls += 1
            assert _same(got, want), (layout, ghosts)
    assert bk.LAUNCHES["ff_bt_defect"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("bs", SIZES)
def test_cuda_k12_four_stitched_shards_equal_the_whole_launch(cuda, bs):
    n = 100003
    a, *v = _problem(bs, bs, n, cuda)
    whole = bk.ff_bt_defect(a, *v)
    bk.reset_launch_counts()
    got = _stitched(bk.ff_bt_defect, a, *v, [0, 1, 25000, 60001, n])
    assert bk.LAUNCHES["ff_bt_defect"] == 4
    assert _same(got, whole)


@pytest.mark.cuda
def test_cuda_ff_defect_is_one_k12_launch(cuda):
    """On a ``BlockTridiagFF``, ``ff_defect`` launches K12 once and no other
    kernel (no PyTorch elementwise kernel)."""
    from torch.profiler import ProfilerActivity, profile

    a, *v = _problem(3, 2, 65536, cuda)
    x, b = tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3])
    tdf.ff_defect(a, x, b)  # the library built and loaded
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = tdf.ff_defect(a, x, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert bk.LAUNCHES["ff_bt_defect"] == 1
    assert len(kernels) == 1 and "ff_bt_defect_kernel" in kernels[0], kernels
    assert _same(r, bk.ff_bt_defect_plain(a, *v))


@pytest.mark.cuda
def test_cuda_k12_refuses_a_block_size_without_an_instance(cuda):
    a, *v = _problem(6, 6, 300, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        bk.ff_bt_defect(a, *v)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["dg", "cg"])
def test_cuda_multigrid_true_through_k12_equals_the_plain_chain(cuda, monkeypatch, chain):
    """The north star's chain cut to 262,144 DoF (``dg``) and the CG-topped
    flagship's at 131,073 DoF (``cg``: CG p = 8, 4, 2, 1, then agglomerated
    levels whose vectors the seam transfer leaves column-major): the
    residual history and x through K12 (7 launches a cycle on each
    agglomerated level) equal those through the plain chain, to the last
    bit."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    if chain == "dg":
        n = 131072
        spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, first_agg_factor=4,
                             agg_factor=4, c_dir=1000.0 * n)
        h, ffops, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device=cuda)
    else:
        n = 16384
        spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n)
        h, ffops, b_ff, norm_b = build_xl_problem(spec, n, ff_levels=True, device=cuda)
    materialised = sum(isinstance(a, tdf.BlockTridiagFF) for a in ffops.a_ffs[: h.n_levels - 1])
    assert materialised >= 3
    bk.reset_launch_counts()
    kern = multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    it = kern.iterations
    assert it > 0 and bk.LAUNCHES["ff_bt_defect"] == 7 * materialised * it
    monkeypatch.setattr(bk, "ff_bt_defect", bk.ff_bt_defect_plain)
    bk.reset_launch_counts()
    plain = multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-8)
    assert bk.LAUNCHES["ff_bt_defect"] == 0
    assert plain.iterations == it
    assert torch.equal(kern.res_history[:it], plain.res_history[:it])  # NaN beyond the cycles run
    assert torch.equal(kern.x, plain.x)
