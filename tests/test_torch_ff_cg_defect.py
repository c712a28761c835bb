"""Kernel K13 (``ff_cg_defect_kernel``): the float-float defect ``r = b - A x``
of an assembled CG band (``ops.df64.CgBandFF``, ``(2p + 1, n)``).

On the CPU (these count everywhere):

* ``ff_cg_defect_plain`` equals the chain ``ops.df64.ff_cg_defect`` ran
  before K13 (written out below as ``_chain_before``: zero-padded shifts
  without a halo, the concatenated halo with one) bit for bit, signed zeros
  included, at p = 1, 2, 3, 4, 8, with and without a halo, on contiguous and
  strided operands; so do ``ops.df64.ff_cg_defect``, ``ff_defect`` and the
  wrapper's CPU path, which launches nothing;
* a halo on one side only reads zero on the other, and stitched shards, each
  with its neighbours' p nodes as halo, equal the whole array;
* the wrapper refuses what the kernel does not take.

On the card (marker ``cuda``; skipped without one): the kernel against its
plain version bit for bit at those p, at n = 1, p + 1, 257 and 100,003, with
no halo, both sides, one side, on strided x and b views and signed zeros at
the ends (p = 3 through the instance for an order known at run time); one
launch per call and no other operator; a wrong dtype or device raises; and a
small CG-topped hand-over (``_mixed_loop_ff(ffops=)``) and ``multigrid_true``
give the same x, history and counts through K13 as through the plain chain.  The JAX
package's defect is compared in ``tests/test_torch_df64.py``.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_ff_cg_defect.py
"""

import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

ORDERS = (1, 2, 3, 4, 8)
HALOS = ("none", "both", "left", "right")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    return torch.device("cuda")


def _wide(rng, shape):
    """float64 values over 2^-20..2^20 with 5 % +0.0 and 5 % -0.0 entries,
    and a signed zero at each end of the last axis."""
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-20, 21, shape))
    u = rng.random(shape)
    v[u < 0.05] = 0.0
    v[(u >= 0.05) & (u < 0.1)] = -0.0
    v[..., 0], v[..., -1] = -0.0, 0.0
    return v


def _pair(v, device):
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    lo[v == 0] = v[v == 0]  # a signed zero's tail keeps its sign
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _laid_out(t: torch.Tensor, strided: bool) -> torch.Tensor:
    """``t`` contiguous, or every other entry of a tensor twice as long (a
    band: its node axis; also every other row)."""
    if not strided:
        return t.contiguous()
    wide = torch.zeros(*(2 * s for s in t.shape), dtype=t.dtype, device=t.device)
    wide[(slice(None, None, 2),) * t.dim()] = t
    return wide[(slice(None, None, 2),) * t.dim()]


def _problem(seed, p, n, device="cpu", strided=False):
    """A random float-float band and x, b pairs: ``(band_hi, band_lo, x_hi,
    x_lo, b_hi, b_lo)``."""
    rng = np.random.default_rng(seed)
    band = _pair(_wide(rng, (2 * p + 1, n)), device)
    vecs = (*_pair(_wide(rng, (n,)), device), *_pair(_wide(rng, (n,)), device))
    return tuple(_laid_out(t, strided) for t in (*band, *vecs))


def _halo(seed, p, which, device="cpu"):
    """``(halo_left, halo_right)``, each a (hi, lo) pair of (p,) tensors or None."""
    rng = np.random.default_rng(seed + 1)
    one = lambda: _pair(_wide(rng, (p,)), device)  # noqa: E731
    return {"none": (None, None), "both": (one(), one()), "left": (one(), None), "right": (None, one())}[which]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same(got, want) -> bool:
    """hi and lo equal bit for bit (so +0.0 and -0.0 differ)."""
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def _chain_before(a, x, b, halo=None):
    """``ops.df64.ff_cg_defect`` as it was before K13 (defined where n >= p:
    the zero-padded shift is)."""
    p = a.hi.shape[0] // 2
    if halo is None:
        shifted = lambda off: tdf._shifted(x, off)  # noqa: E731
    else:
        (left, right), n = halo, x.hi.shape[-1]
        ext = tdf.FF(torch.cat([left.hi, x.hi, right.hi], dim=-1), torch.cat([left.lo, x.lo, right.lo], dim=-1))
        shifted = lambda off: tdf.FF(ext.hi[p + off : p + off + n], ext.lo[p + off : p + off + n])  # noqa: E731
    acc = b
    for off in range(-p, p + 1):
        t = tdf.ff_mul(tdf.FF(a.hi[off + p], a.lo[off + p]), shifted(off))
        acc = tdf.ff_add(acc, tdf.ff_neg(t))
    return acc.hi, acc.lo


def _zeros_for(halo, p):
    """The halo with a missing side as zeros (what the kernel reads there)."""
    z = torch.zeros(p)
    return tuple(tdf.FF(z, z) if h is None else tdf.FF(*h) for h in halo)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("halo", ["none", "both"])
@pytest.mark.parametrize("n", ["p", "p+1", 1000])
@pytest.mark.parametrize("p", ORDERS)
def test_plain_equals_the_chain_before_k13(p, n, halo, strided):
    n = {"p": p, "p+1": p + 1}.get(n, n)
    band_hi, band_lo, *v = _problem(p * 1000 + n, p, n, strided=strided)
    hl, hr = _halo(p, p, halo)
    a, x, b = tdf.CgBandFF(band_hi, band_lo), tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3])
    ff_halo = None if halo == "none" else (tdf.FF(*hl), tdf.FF(*hr))
    bk.reset_launch_counts()
    plain = bk.ff_cg_defect_plain(band_hi, band_lo, *v, hl, hr)
    assert _same(plain, _chain_before(a, x, b, ff_halo))
    assert _same(plain, tdf.ff_cg_defect(a, x, b, ff_halo))
    assert _same(plain, bk.ff_cg_defect(band_hi, band_lo, *v, hl, hr))  # the wrapper's CPU path
    if halo == "none":
        assert _same(plain, tdf.ff_defect(a, x, b))
    assert bk.LAUNCHES["ff_cg_defect"] == 0


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("p", ORDERS)
def test_a_halo_on_one_side_reads_zero_on_the_other(p, side):
    n = 50
    band_hi, band_lo, *v = _problem(p, p, n)
    halo = _halo(p, p, side)
    got = bk.ff_cg_defect_plain(band_hi, band_lo, *v, *halo)
    a, x, b = tdf.CgBandFF(band_hi, band_lo), tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3])
    assert _same(got, _chain_before(a, x, b, _zeros_for(halo, p)))


def _stitched(defect, band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, cuts):
    """The defect of each shard ``[c0, c1)`` with its neighbours' p nodes of x
    as halo (None at the two ends), concatenated."""
    p, n = band_hi.shape[0] // 2, x_hi.shape[0]
    outs = []
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        hl = None if c0 == 0 else (x_hi[c0 - p : c0], x_lo[c0 - p : c0])
        hr = None if c1 == n else (x_hi[c1 : c1 + p], x_lo[c1 : c1 + p])
        outs.append(defect(band_hi[:, c0:c1], band_lo[:, c0:c1], *(t[c0:c1] for t in (x_hi, x_lo, b_hi, b_lo)),
                           hl, hr))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(2))


@pytest.mark.parametrize("p", ORDERS)
def test_stitched_shards_equal_the_whole_array(p):
    n = 1000
    args = _problem(p, p, n)
    whole = bk.ff_cg_defect_plain(*args)
    assert _same(_stitched(bk.ff_cg_defect_plain, *args, [0, 9, 333, 700, n]), whole)


def _bad(case):
    band_hi, band_lo, x_hi, x_lo, b_hi, b_lo = _problem(0, 2, 16)
    hl = hr = None
    if case == "vector":
        x_lo = x_lo[:15]
    elif case == "band":
        band_lo = band_lo[:, :15]
    elif case == "even_rows":
        band_hi, band_lo = band_hi[:4], band_lo[:4]
    elif case == "halo":
        hl = (torch.zeros(3), torch.zeros(3))
    elif case == "halo_one_part":
        hl = (torch.zeros(2),)
    elif case == "dtype":
        b_hi = b_hi.double()
    elif case == "device":
        b_lo = b_lo.to("meta")
    elif case == "not_a_vector":
        x_hi = x_hi.reshape(4, 4)
    return band_hi, band_lo, x_hi, x_lo, b_hi, b_lo, hl, hr


@pytest.mark.parametrize("case,error", [
    ("vector", ValueError), ("band", ValueError), ("even_rows", ValueError), ("halo", ValueError),
    ("halo_one_part", ValueError), ("dtype", TypeError), ("device", ValueError), ("not_a_vector", ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    with pytest.raises(error):
        bk.ff_cg_defect(*_bad(case))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", ["1", "p+1", "257", "100003"])
@pytest.mark.parametrize("p", ORDERS)
def test_cuda_k13_equals_plain(cuda, p, n):
    """Every halo form, contiguous and strided operands (p = 3 through the
    instance for an order known at run time, the others through their own);
    one launch each, bit for bit."""
    n = p + 1 if n == "p+1" else int(n)
    calls = 0
    bk.reset_launch_counts()
    for strided in (False, True):
        args = _problem(p * 7919 + n, p, n, cuda, strided)
        for halo in HALOS:
            hl, hr = _halo(n, p, halo, cuda)
            got, want = bk.ff_cg_defect(*args, hl, hr), bk.ff_cg_defect_plain(*args, hl, hr)
            torch.cuda.synchronize()
            calls += 1
            assert _same(got, want), (strided, halo)
    assert bk.LAUNCHES["ff_cg_defect"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("p", ORDERS)
def test_cuda_k13_stitched_shards_equal_the_whole_launch(cuda, p):
    n = 100003
    args = _problem(p, p, n, cuda)
    whole = bk.ff_cg_defect(*args)
    bk.reset_launch_counts()
    got = _stitched(bk.ff_cg_defect, *args, [0, 9, 25000, 60001, n])
    assert bk.LAUNCHES["ff_cg_defect"] == 4
    assert _same(got, whole)


@pytest.mark.cuda
def test_cuda_ff_defect_is_one_k13_launch(cuda):
    """On a ``CgBandFF``, ``ff_defect`` launches K13 once and runs no PyTorch
    operator but the outputs' allocation (no elementwise kernel, no copy).
    The operators are seen by a dispatch mode, not by the profiler, whose
    CUDA events a second session in one process may miss."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    band_hi, band_lo, *v = _problem(3, 8, 65537, cuda)
    a, x, b = tdf.CgBandFF(band_hi, band_lo), tdf.FF(v[0], v[1]), tdf.FF(v[2], v[3])
    tdf.ff_defect(a, x, b)  # the library built and loaded
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    with Ops() as ops:
        r = tdf.ff_defect(a, x, b)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["ff_cg_defect"] == 1
    assert ops.names and all(n.startswith("aten.empty") for n in ops.names), ops.names
    assert _same(r, bk.ff_cg_defect_plain(band_hi, band_lo, *v))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "device"])
def test_cuda_k13_refuses_a_wrong_dtype_or_device(cuda, case):
    args = list(_problem(5, 4, 300, cuda))
    if case == "dtype":
        args[4] = args[4].double()
    else:
        args[3] = args[3].cpu()
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        bk.ff_cg_defect(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["handover", "true"])
def test_cuda_solve_through_k13_equals_the_plain_chain(cuda, monkeypatch, driver):
    """The CG-topped flagship's chain at 16,385 DoF (CG p = 8, 4, 2, 1, then
    agglomerated levels), solved by the hand-over ``_mixed_loop_ff(ffops=)``
    and by ``multigrid_true`` (whose cycles take the defect on every CG
    level): every ``ff_cg_defect`` call is one K13 launch, and x, the
    history, the counts (and the hand-over's ``info``) equal those through
    the plain chain, to the last bit."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    n = 2048
    spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n)
    h, ffops, b_ff, norm_b = build_xl_problem(spec, n, ff_levels=True, device=cuda)
    kernel = bk.ff_cg_defect

    def solve(defect):
        calls = [0]

        def counted(*args, **kwargs):
            calls[0] += 1
            return defect(*args, **kwargs)

        monkeypatch.setattr(bk, "ff_cg_defect", counted)
        bk.reset_launch_counts()
        if driver == "true":
            res = multigrid_true(h, ffops, b_ff, norm_b, 6, 1e-12)
            out = ((res.x,), res.iterations, res.iterations, res.res_history[: res.iterations].cpu().numpy(), {})
        else:
            zero, info = torch.zeros_like(b_ff.hi), {}
            x, outer, cycles, hist = _mixed_loop_ff(h, ffops.a_ffs[0], tdf.FF(zero, zero), b_ff,
                                                    np.float32(1.0 / norm_b), ffops=ffops, info=info, maxiter=30,
                                                    tol=1e-13, inner_tol=3e-5, max_inner=20)
            out = (x, outer, cycles, np.asarray(hist[:outer]), info)
        torch.cuda.synchronize()
        return (*out, calls[0], bk.LAUNCHES["ff_cg_defect"])

    kern = solve(kernel)
    plain = solve(bk.ff_cg_defect_plain)
    assert kern[5] > 0 and kern[6] == kern[5] and plain[6] == 0  # one launch a call; none on the plain chain
    assert _same(kern[0], plain[0]) and np.array_equal(kern[3], plain[3])
    assert kern[1:3] == plain[1:3] and kern[4] == plain[4] and kern[5] == plain[5]
