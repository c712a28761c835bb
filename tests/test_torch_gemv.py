"""The block contractions' plain versions (``bd_gemv_plain``,
``bp_prolong_gemv_plain``, ``bp_restrict_gemv_plain`` of
``ops/kernels/block_kernels.py``, the order the card's kernels round in) on
the CPU: held to ``torch.einsum``; in float32 equal, bit for bit, to an
independent emulation of the card's order (halves of fma chains, each fma
formed with the product exact in float64, as
``tests/test_torch_stencil.py::_prolong_fused`` forms it); the
exact ``_fma`` against rational arithmetic.  CPU tensors keep the einsum of
``bd_matvec`` / ``bp_prolong`` / ``bp_restrict`` bit for bit and launch
nothing; the wrappers run the plain versions on the CPU and raise on
operands the kernels do not take.  The kernels themselves are held to these plain versions on the
card (``tests/test_torch_cuda.py``)."""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag, bd_matvec
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import (
    BlockProlong,
    block_prolong_constant,
    bp_prolong,
    bp_restrict,
)

N = 300  # block columns: not a multiple of the kernels' 256-thread block
DTYPES = (torch.float32, torch.float64)
SIZES = bk.SUPPORTED_BLOCK_SIZES  # the kernels' range: every block size, every pair (bs_f, bs_c)
PAIRS = [(f, c) for f in SIZES for c in SIZES]
GEMV_KEYS = ("bd_gemv", "bp_prolong_gemv", "bp_restrict_gemv")


def _rnd(seed, shape, dtype):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _fused_dot(ms, vs):
    """The two halves ``j < h``, ``j >= h`` (``h = ceil(K / 2)``), each
    ``ms[0] vs[0]`` then ``fma(m, v, acc)`` ascending, added; each fma formed
    in float64 (the float32 product exact there) and rounded to float32."""
    def chain(ms, vs):
        acc = ms[0] * vs[0]
        for m, v in zip(ms[1:], vs[1:]):
            acc = (m.double() * v.double() + acc.double()).float()
        return acc

    h = (len(ms) + 1) // 2
    return chain(ms[:h], vs[:h]) + chain(ms[h:], vs[h:]) if h < len(ms) else chain(ms, vs)


def _hold(plain, einsum, fused):
    """The plain version within a few ulps of the einsum; in float32 equal
    to the fused emulation ``fused()`` bit for bit."""
    eps = torch.finfo(plain.dtype).eps
    assert float((plain - einsum).abs().max()) <= 8 * eps * float(einsum.abs().max())
    if plain.dtype == torch.float32:
        assert torch.equal(plain, fused())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("bs", SIZES)
def test_bd_gemv_plain(bs, dtype):
    blocks, x = _rnd(bs, (bs, bs, N), dtype), _rnd(bs + 10, (bs, N), dtype)
    _hold(bk.bd_gemv_plain(blocks, x), torch.einsum("ijn,jn->in", blocks, x),
          lambda: torch.stack([_fused_dot(blocks[i], x) for i in range(bs)]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("bs_f,bs_c", PAIRS)
@pytest.mark.parametrize("r", [1, 2, 4])
def test_bp_prolong_gemv_plain(r, bs_f, bs_c, dtype):
    blocks, xc = _rnd(r * bs_f, (r, bs_f, bs_c, N), dtype), _rnd(bs_c, (bs_c, N), dtype)
    want = torch.einsum("jibn,bn->jin", blocks, xc).permute(1, 2, 0).reshape(bs_f, r * N)

    def fused():
        t = torch.stack([torch.stack([_fused_dot(blocks[j, i], xc) for i in range(bs_f)]) for j in range(r)])
        return t.permute(1, 2, 0).reshape(bs_f, r * N)

    _hold(bk.bp_prolong_gemv_plain(blocks, xc), want, fused)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("bs_f,bs_c", PAIRS)
@pytest.mark.parametrize("r", [1, 2, 4])
def test_bp_restrict_gemv_plain(r, bs_f, bs_c, dtype):
    blocks, rf = _rnd(r * bs_c, (r, bs_f, bs_c, N), dtype), _rnd(bs_f, (bs_f, r * N), dtype)
    want = sum(torch.einsum("ibn,in->bn", blocks[j], rf[:, j::r]) for j in range(r))

    def fused():
        parts = [torch.stack([_fused_dot(blocks[j, :, b], rf[:, j::r]) for b in range(bs_c)]) for j in range(r)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    _hold(bk.bp_restrict_gemv_plain(blocks, rf), want, fused)


def _round(q: Fraction, bits: int) -> float:
    """``q`` rounded to nearest (ties to even) with a ``bits``-bit significand."""
    if q == 0:
        return 0.0
    e = math.floor(math.log2(abs(q)))
    e += 1 if abs(q) >= Fraction(2) ** (e + 1) else (-1 if abs(q) < Fraction(2) ** e else 0)
    unit = Fraction(2) ** (e - bits + 1)
    return float(round(q / unit) * unit)


@pytest.mark.parametrize("dtype,bits", [(torch.float32, 24), (torch.float64, 53)], ids=["f32", "f64"])
def test_fma_rounds_once(dtype, bits):
    """``_fma(a, b, c)`` is ``a b + c`` rounded once: random operands, and
    ``c`` the negated rounded product, where the sum is the product's
    rounding error (exact in the fma, lost by a plain product)."""
    rng = np.random.default_rng(bits)
    n = 1500
    a, b = (torch.from_numpy(rng.standard_normal(n)).to(dtype) for _ in range(2))
    c = torch.from_numpy(rng.standard_normal(n) * 2.0 ** rng.integers(-40, 8, n)).to(dtype)
    c[: n // 3] = -(a[: n // 3] * b[: n // 3])
    got = bk._fma(a, b, c)
    want = [_round(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)), bits) for x, y, z in zip(a, b, c)]
    assert got.tolist() == want
    assert bool((got[: n // 3] != 0).any())  # the cancelled third keeps the product's error


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_cpu_tensors_take_the_einsum(dtype):
    """On the CPU ``bd_matvec``, ``bp_prolong`` and ``bp_restrict`` are the
    einsum they were, bit for bit (an expanded r = 1 prolongation too), and
    no contraction kernel is launched or counted."""
    bk.reset_launch_counts()
    blocks, x = _rnd(1, (2, 2, N), dtype), _rnd(2, (2, N), dtype)
    assert torch.equal(bd_matvec(BlockDiag(blocks), x), torch.einsum("ijn,jn->in", blocks, x))
    for l in (BlockProlong(_rnd(3, (4, 2, 2, N), dtype)), block_prolong_constant(_rnd(4, (4, 2), dtype), N)):
        r, bs_f, bs_c, _ = l.blocks.shape
        xc, rf = _rnd(5, (bs_c, N), dtype), _rnd(6, (bs_f, r * N), dtype)
        want = torch.einsum("jibn,bn->jin", l.blocks, xc).permute(1, 2, 0).reshape(bs_f, r * N)
        assert torch.equal(bp_prolong(l, xc), want)
        want = torch.einsum("ibn,in->bn", l.blocks[0], rf[:, 0::r])
        for j in range(1, r):
            want = want + torch.einsum("ibn,in->bn", l.blocks[j], rf[:, j::r])
        assert torch.equal(bp_restrict(l, rf), want)
    assert all(bk.LAUNCHES[k] == 0 for k in GEMV_KEYS)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_gemv_wrappers_run_plain_on_the_cpu(dtype):
    """The wrappers on CPU tensors run the plain versions (strided operands
    too) and launch nothing."""
    bk.reset_launch_counts()
    blocks, x = _rnd(1, (5, 5, N), dtype), _rnd(2, (5, 2 * N), dtype)[:, ::2]
    assert torch.equal(bk.bd_gemv(blocks, x), bk.bd_gemv_plain(blocks, x))
    blocks, xc, rf = _rnd(3, (2, 9, 5, N), dtype), _rnd(4, (5, N), dtype), _rnd(5, (9, 2 * N), dtype)
    assert torch.equal(bk.bp_prolong_gemv(blocks, xc), bk.bp_prolong_gemv_plain(blocks, xc))
    assert torch.equal(bk.bp_restrict_gemv(blocks, rf), bk.bp_restrict_gemv_plain(blocks, rf))
    assert all(bk.LAUNCHES[k] == 0 for k in GEMV_KEYS)


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: bk.bd_gemv(torch.zeros(2, 2, 4), torch.zeros(2, 4, dtype=torch.float64)), TypeError),
        (lambda: bk.bd_gemv(torch.zeros(2, 2, 4).half(), torch.zeros(2, 4).half()), TypeError),
        (lambda: bk.bd_gemv(torch.zeros(2, 2, 4), torch.zeros(2, 5)), ValueError),
        (lambda: bk.bp_prolong_gemv(torch.zeros(2, 4, 2, 4), torch.zeros(4, 4)), ValueError),
        (lambda: bk.bp_restrict_gemv(torch.zeros(2, 4, 2, 4), torch.zeros(4, 4)), ValueError),
    ],
    ids=["mixed_dtypes", "float16", "bd_shape", "prolong_shape", "restrict_shape"],
)
def test_gemv_wrappers_raise_on_bad_operands(call, error):
    """Operands the kernels do not take raise, on the CPU as on the card
    (where a block size outside ``SUPPORTED_BLOCK_SIZES`` raises too): no
    call is handed to another path."""
    with pytest.raises(error):
        call()
