"""The torch port's CUDA kernels (K1-K3, K5, K6 and K6s bit for bit, K7 with ghosts
and in-place columns, the edge pair and its packing kernel, K8, K4, the three
block contractions bit for bit), its
mixed solve, its true-precision solve and its sharded solve on a one-rank
NCCL group, the CG-topped stencil build, the ragged transfers and the
pentadiagonal and scattered chains against the CPU's, on a CUDA card.

Every test here needs the card (marker ``cuda``) and skips without one.  This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu_torch.models import (
    chebyshev_hierarchy,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul, bt_matvec
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk


GEMV_KEYS = ("bd_gemv", "bp_prolong_gemv", "bp_restrict_gemv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, bs, n, device):
    """Random diagonally dominant operators with S^-1 the exact inverse of A_D."""
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u = rng.standard_normal((bs, bs, n))
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 5 * np.eye(bs)[:, :, None]
    sinv = np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0)
    x = rng.standard_normal((bs, n))
    b = rng.standard_normal((bs, n))
    l, d, u, sinv, x, b = (
        torch.tensor(m, dtype=torch.float32, device=device).contiguous() for m in (l, d, u, sinv, x, b)
    )
    return l, d, u, sinv, block_mul(sinv, l), block_mul(sinv, u), x, b


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n", [(1, 777), (2, 1000), (3, 4097), (4, 65536), (5, 300), (9, 640)])
def test_cuda_kernels_match_plain(cuda, bs, n):
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n, bs, n, cuda)
    a = BlockTridiag(l, d, u)
    bk.reset_launch_counts()
    pairs = [(bk.fused_bt_matvec(a, x), bk.bt_matvec_plain(a, x))]
    for k in (1, 3, bk.MAX_SWEEPS):
        pairs.append((bk.multisweep(ml, mu, sinv, x, b, k), bk.multisweep_plain(ml, mu, sinv, x, b, k)))
        pairs += list(
            zip(
                bk.multisweep_residual(ml, mu, sinv, d, x, b, k),
                bk.multisweep_residual_plain(ml, mu, sinv, d, x, b, k),
            )
        )
    torch.cuda.synchronize()
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert {k: bk.LAUNCHES[k] for k in ("bt_matvec", "multisweep", "multisweep_residual")} == {
        "bt_matvec": 1, "multisweep": 3, "multisweep_residual": 3,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n", [(1, 777), (2, 1000), (2, 131072), (3, 4097), (4, 65536), (9, 640)])
def test_cuda_chebyshev_kernel_matches_plain(cuda, bs, n):
    """K5, without and with the residual, for 1, 3 and MAX_SWEEPS steps."""
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n + 1, bs, n, cuda)
    table = bk.chebyshev_coefficients(0.3, 1.2, bk.MAX_SWEEPS)
    bk.reset_launch_counts()
    pairs = []
    for k in (1, 3, bk.MAX_SWEEPS):
        coef = table[:k]
        pairs.append((bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef),
                      bk.chebyshev_multisweep_plain(ml, mu, sinv, x, b, coef)))
        pairs += list(zip(bk.chebyshev_multisweep_residual(ml, mu, sinv, d, x, b, coef),
                          bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, d, x, b, coef)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bk.LAUNCHES["chebyshev_multisweep"] == 3 and bk.LAUNCHES["chebyshev_multisweep_residual"] == 3


@pytest.mark.cuda
def test_cuda_mixed_solve_uses_kernels_and_matches_f64(cuda):
    prob = poisson_dg_hierarchy(n=4096, max_p=3, n_dg=2, n_agg=5, device=cuda)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    bk.reset_launch_counts()
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    counts = dict(bk.LAUNCHES)
    assert all(counts[k] > 0 for k in ("bt_matvec", "multisweep", "multisweep_residual")), counts
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(bt_matvec(prob.hierarchy.levels[0].a, res.x) - b)) / nb
    assert rel < 1e-10
    ref = multigrid(prob.hierarchy, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
    assert float((res.x - ref.x).abs().max()) < 1e-4


@pytest.mark.cuda
def test_cuda_chebyshev_flagship_solve_uses_k5(cuda):
    """A small Chebyshev mixed solve of the CG-topped flagship reaches 1e-10
    through K5 on its agglomerated levels."""
    prob = poisson_full_hierarchy(n=1024, device=cuda)
    h = chebyshev_hierarchy(prob.hierarchy)
    b = prob.b
    bk.reset_launch_counts()
    res = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    assert bk.LAUNCHES["chebyshev_multisweep"] > 0 and bk.LAUNCHES["chebyshev_multisweep_residual"] > 0
    assert bk.LAUNCHES["multisweep"] == 0  # every smoothed block level is Chebyshev
    from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import cg_matvec

    rel = float(torch.linalg.vector_norm(cg_matvec(prob.hierarchy.levels[0].a, res.x) - b))
    assert rel / float(torch.linalg.vector_norm(b)) < 1e-10


def _k6_inputs(seed, bs, n, bw, device):
    """A random float-float stencil (packed, hi ~ 1e3, lo ~ 1e-4) and x, b pairs."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    blocks = torch.stack([t(rng.standard_normal((3, bs, bs, 2 * bw + 1)) * 1e3),
                          t(rng.standard_normal((3, bs, bs, 2 * bw + 1)) * 1e-4)]).contiguous()
    x_hi, b_hi = t(rng.standard_normal((bs, n))), t(rng.standard_normal((bs, n)) * 1e3)
    return blocks, x_hi, t(rng.standard_normal((bs, n)) * 1e-8), b_hi, t(rng.standard_normal((bs, n)) * 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,bw", [(2, 16384, 4), (4, 1000, 4), (2, 777, 0), (9, 300, 4)])
def test_cuda_k6_bit_exact(cuda, bs, n, bw):
    """K6 equals its plain version bit for bit, hi and lo, with and without
    boundary columns."""
    args = _k6_inputs(bs * n + bw, bs, n, bw, cuda)
    bk.reset_launch_counts()
    got = bk.ff_stencil_mid_defect(*args)
    want = bk.ff_stencil_mid_defect_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bk.LAUNCHES["ff_stencil_mid_defect"] == 1
    with pytest.raises(TypeError):  # no plain path for a CUDA tensor of another type
        bk.ff_stencil_mid_defect(args[0], args[1].double(), *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n", [(2, 1001), (4, 4097)])
def test_cuda_k6s_bit_exact_and_stitched(cuda, bs, n):
    """K6s equals its plain version bit for bit at a shard with ghosts on
    both sides, and two stitched shards (cut at a column that is no multiple
    of bw, ghosts from each other) equal K6 on the whole array."""
    blocks, x_hi, x_lo, b_hi, b_lo = _k6_inputs(bs + n, bs, n, 4, cuda)

    def ghost(c):
        return torch.stack([x_hi[:, c], x_lo[:, c]]).contiguous() if 0 <= c < n else None

    def shard(c0, c1):
        cut = [t[:, c0:c1].contiguous() for t in (x_hi, x_lo, b_hi, b_lo)]
        return (blocks, *cut, c0, n, ghost(c0 - 1), ghost(c1))

    bk.reset_launch_counts()
    mid = shard(3, n - 5)
    got, want = bk.ff_stencil_shard_defect(*mid), bk.ff_stencil_mid_defect_plain(*mid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cut = n // 2 + 1
    parts = [bk.ff_stencil_shard_defect(*shard(0, cut)), bk.ff_stencil_shard_defect(*shard(cut, n))]
    whole = bk.ff_stencil_mid_defect(blocks, x_hi, x_lo, b_hi, b_lo)
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=1), whole[k])
    assert bk.LAUNCHES["ff_stencil_shard_defect"] == 3 and bk.LAUNCHES["ff_stencil_mid_defect"] == 1


@pytest.mark.cuda
def test_cuda_multigrid_true_launches_k6(cuda):
    """The n=4096 stencil configuration built and solved on the card:
    converges to 1e-8 and launches K6 n_pre + 1 + n_post = 7 times per cycle."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    n = 4096
    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n)
    h, ffops, b_ff, norm_b = build_xl_problem(spec, n, z=8, slim_fine=True, ff_levels=True, device=cuda)
    bk.reset_launch_counts()
    res = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
    it = res.iterations
    assert 0 < it < 40 and float(res.res_history[it - 1]) < 1e-8 * norm_b
    assert bk.LAUNCHES["ff_stencil_mid_defect"] == 7 * it
    assert res.x.device.type == "cuda" and bool(torch.isfinite(res.x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,g", [(2, 1000, 4), (4, 65536, 4), (3, 777, 9), (4, 300, 128)])
def test_cuda_k7_matches_plain(cuda, bs, n, g):
    """K7's four forms with non-zero ghosts of width g, whole and as the two
    in-place edge strips of the sharded path."""
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n + g, bs, n, cuda)
    _, _, _, gs, gml, gmu, gx, gb = _inputs(g, bs, 2 * g, cuda)
    ghosts = (torch.stack([gml, gmu, gs]).contiguous(), torch.stack([gx, gb]).contiguous())
    coef = bk.chebyshev_coefficients(0.3, 1.2, 3)
    forms = [
        (lambda **kw: bk.multisweep(ml, mu, sinv, x, b, 3, ghosts=ghosts, **kw),
         bk.multisweep_plain(ml, mu, sinv, x, b, 3, ghosts=ghosts)),
        (lambda **kw: bk.multisweep_residual(ml, mu, sinv, d, x, b, 3, ghosts=ghosts, **kw),
         bk.multisweep_residual_plain(ml, mu, sinv, d, x, b, 3, ghosts=ghosts)),
        (lambda **kw: bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef, ghosts=ghosts, **kw),
         bk.chebyshev_multisweep_plain(ml, mu, sinv, x, b, coef, ghosts=ghosts)),
        (lambda **kw: bk.chebyshev_multisweep_residual(ml, mu, sinv, d, x, b, coef, ghosts=ghosts, **kw),
         bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, d, x, b, coef, ghosts=ghosts)),
    ]
    bk.reset_launch_counts()
    for kern, want in forms:
        want = want if isinstance(want, tuple) else (want,)
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        out = tuple(torch.full_like(w, 7.0) for w in want)
        for cols in ((0, 4), (n - 4, n)):
            kern(out=out if len(out) > 1 else out[0], cols=cols)
        torch.cuda.synchronize()
        for g_, o_, w_ in zip(got, out, want):
            assert float((g_ - w_).abs().max()) <= 1e-5 * float(w_.abs().max())
            edges = torch.cat([o_[:, :4], o_[:, -4:]], dim=1)
            assert float((edges - torch.cat([w_[:, :4], w_[:, -4:]], dim=1)).abs().max()) <= 1e-5 * float(w_.abs().max())
            assert bool((o_[:, 4:-4] == 7.0).all())  # the columns outside cols are untouched
    assert all(bk.LAUNCHES[k] == 3 for k in ("multisweep_ghost", "multisweep_residual_ghost",
                                              "chebyshev_multisweep_ghost", "chebyshev_multisweep_residual_ghost"))


def _edge_forms(ops, x, b, coef):
    """Per form: (edge-pair launch ``(plan, out)``, its plain version
    ``(gops, from_left, from_right)``, the K7 strip launch ``(ghosts, out,
    cols)``, residual?)."""
    ml, mu, sinv, d = ops
    return [
        (lambda p, out: p.sweep_edges(x, b, out),
         lambda *gh: bk.multisweep_edges_plain(ml, mu, sinv, x, b, *gh),
         lambda gh, out, cols: bk.multisweep(ml, mu, sinv, x, b, ghosts=gh, out=out, cols=cols), False),
        (lambda p, out: p.sweep_edges(x, b, out),
         lambda *gh: bk.multisweep_residual_edges_plain(ml, mu, sinv, d, x, b, *gh),
         lambda gh, out, cols: bk.multisweep_residual(ml, mu, sinv, d, x, b, ghosts=gh, out=out, cols=cols), True),
        (lambda p, out: p.chebyshev_edges(x, b, out, coef),
         lambda *gh: bk.chebyshev_multisweep_edges_plain(ml, mu, sinv, x, b, coef, *gh),
         lambda gh, out, cols: bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef, ghosts=gh, out=out, cols=cols), False),
        (lambda p, out: p.chebyshev_edges(x, b, out, coef),
         lambda *gh: bk.chebyshev_multisweep_residual_edges_plain(ml, mu, sinv, d, x, b, coef, *gh),
         lambda gh, out, cols: bk.chebyshev_multisweep_residual(ml, mu, sinv, d, x, b, coef, ghosts=gh, out=out, cols=cols),
         True),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,g", [(2, 1000, 9), (4, 65536, 9), (3, 777, 4), (9, 64, 9), (4, 8, 8)])
def test_cuda_edge_pair_matches_plain_and_strips(cuda, bs, n, g):
    """The edge pair, four forms, random non-zero ghosts: its plain version
    to 1e-5 of max|out|, K7's two in-place strips to 1e-6 (the same
    arithmetic: 0 expected), nothing written outside the edges, a null side
    exactly the zero ghosts; one launch per call."""
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n + g + 1, bs, n, cuda)
    _, _, _, gs, gml, gmu, gx, gb = _inputs(g + 1, bs, 2 * g, cuda)
    gops, gvec = torch.stack([gml, gmu, gs]).contiguous(), torch.stack([gx, gb]).contiguous()
    ops = (ml, mu, sinv, d)

    def plan_with(gops_, left=True, right=True, zero=None):
        p = bk.EdgePlan(*ops, gops_, left=left, right=right)
        for side, (buf, half) in enumerate(((p.from_left, slice(None, g)), (p.from_right, slice(g, None)))):
            if buf is not None and side != zero:
                buf.copy_(gvec[..., half])
        return p

    plan = plan_with(gops)
    bk.reset_launch_counts()
    for pair, plain, strip, residual in _edge_forms(ops, x, b, bk.chebyshev_coefficients(0.3, 1.2, 3)):
        fresh = lambda: tuple(torch.full_like(x, 7.0) for _ in range(2 if residual else 1))  # noqa: E731
        arg = lambda o: o if residual else o[0]  # noqa: E731
        got, old = fresh(), fresh()
        pair(plan, arg(got))
        for cols in ((0, 4), (n - 4, n)):
            strip((gops, gvec), arg(old), cols)
        want = plain(gops, plan.from_left, plan.from_right)
        torch.cuda.synchronize()
        scale = max(float(w.abs().max()) for w in want)
        for i, (g_, o_) in enumerate(zip(got, old)):
            for side, crop in enumerate((slice(None, 4), slice(-4, None))):
                assert float((g_[:, crop] - want[2 * i + side]).abs().max()) <= 1e-5 * scale
                assert float((g_[:, crop] - o_[:, crop]).abs().max()) <= 1e-6 * scale
            assert bool((g_[:, 4:-4] == 7.0).all())
        for side, half in enumerate((slice(None, g), slice(g, None))):
            zeroed = gops.clone()
            zeroed[..., half] = 0
            with_null, with_zero = fresh(), fresh()
            pair(plan_with(gops, left=side != 0, right=side != 1), arg(with_null))
            pair(plan_with(zeroed, zero=side), arg(with_zero))
            torch.cuda.synchronize()
            assert all(torch.equal(n_, z_) for n_, z_ in zip(with_null, with_zero))
    assert all(bk.LAUNCHES[k] == 5 for k in ("edge_pair", "edge_pair_residual", "chebyshev_edge_pair",
                                              "chebyshev_edge_pair_residual"))


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,g", [(2, 1000, 9), (4, 65536, 9), (9, 64, 5), (1, 9, 9)])
def test_cuda_pack_edges_is_exact(cuda, bs, n, g):
    """The packing kernel equals its plain version exactly, with both
    neighbours, one, and none (then nothing is launched)."""
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n + 3, bs, n, cuda)
    gops = torch.zeros(3, bs, bs, 2 * g, device=cuda)
    bk.reset_launch_counts()
    for left, right in ((True, True), (False, True), (True, False), (False, False)):
        plan = bk.EdgePlan(ml, mu, sinv, d, gops, left=left, right=right)
        plan.pack(x, b)
        torch.cuda.synchronize()
        for got, want in zip((plan.to_left, plan.to_right), bk.pack_edges_plain(x, b, g, left, right)):
            assert (got is None and want is None) or torch.equal(got, want)
    assert bk.LAUNCHES["pack_edges"] == 3


@pytest.mark.cuda
def test_cuda_edge_plan_raises_on_the_card(cuda):
    """On a CUDA tensor the plan launches or raises: no plain path for a wrong
    dtype, a CPU tensor or a shard narrower than two edges; the launch floor
    (an empty kernel through the same route) launches."""
    l, d, u, sinv, ml, mu, x, b = _inputs(5, 2, 64, cuda)
    plan = bk.EdgePlan(ml, mu, sinv, d, torch.zeros(3, 2, 2, 18, device=cuda), left=False, right=False)
    out = torch.empty_like(x)
    with pytest.raises(TypeError):
        plan.sweep_edges(x.double(), b, out)
    with pytest.raises(ValueError, match="device"):
        plan.sweep_edges(x.cpu(), b, out)
    with pytest.raises(ValueError, match="shape"):
        plan.sweep_edges(x, b[:, :32].contiguous(), out)
    bk.reset_launch_counts()
    assert plan.sweep_edges(x, b, out) is out
    bk.launch_floor()
    torch.cuda.synchronize()
    assert bk.LAUNCHES["edge_pair"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n", [(2, 1000), (4, 65536), (9, 640)])
def test_cuda_k8_and_k4_match_plain(cuda, bs, n):
    l, d, u, sinv, ml, mu, x, b = _inputs(bs * n + 2, bs, n, cuda)
    a = BlockTridiag(l, d, u)
    bk.reset_launch_counts()
    pairs = [(bk.block_jacobi_sweep(a, sinv, x, b), bk.block_jacobi_sweep_plain(a, sinv, x, b)),
             (bk.stream_kernel(ml, mu, sinv, x, b), bk.stream_kernel_plain(ml, mu, sinv, x, b))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bk.LAUNCHES["block_jacobi_sweep"] == 1 and bk.LAUNCHES["stream_kernel"] == 1


@pytest.mark.cuda
def test_cuda_sharded_solve_on_one_rank(cuda, tmp_path):
    """The sharded mixed solve on a one-rank NCCL group: one edge-pair launch
    per smoothing and no K7 strip, the unsharded solve's counts and a 1e-10
    residual."""
    from agglomerationmultigrid1d_tpu_torch.parallel import (
        initialize,
        shard_hierarchy,
        shard_vector,
        shutdown,
        unshard_vector,
    )

    prob = poisson_dg_hierarchy(n=4096, max_p=3, n_dg=2, n_agg=5, device=cuda)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    ref = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    g = initialize(0, 1, store_path=str(tmp_path / "store"))
    try:
        h, hl = shard_hierarchy(prob.hierarchy, g), shard_hierarchy(h32, g)
        bl = shard_vector(b, g)
        bk.reset_launch_counts()
        res = multigrid_mixed(h, hl, torch.zeros_like(bl), bl, 80, 1e-10)
        x = unshard_vector(res.x, h)
    finally:
        shutdown()
    n_sharded = sum(hl.layout.sharded)
    assert bk.LAUNCHES["edge_pair"] == bk.LAUNCHES["edge_pair_residual"] == res.inner_cycles * n_sharded > 0
    assert bk.LAUNCHES["multisweep_ghost"] == 0 and bk.LAUNCHES["multisweep_residual_ghost"] == 0
    assert bk.LAUNCHES["pack_edges"] == 0  # a ring of one has no neighbour to pack for
    assert (res.iterations, res.inner_cycles) == (ref.iterations, ref.inner_cycles)
    rel = float(torch.linalg.vector_norm(bt_matvec(prob.hierarchy.levels[0].a, x) - b) / torch.linalg.vector_norm(b))
    assert rel < 1e-10


@pytest.mark.cuda
def test_cuda_narrow_shards_take_k7_or_raise(cuda):
    """On the card a float32 shard never takes the plain sweep: narrower than
    two strips it runs one whole-shard K7 launch (equal to the unsharded
    K2 on a one-rank ring, whose ghosts are the zero boundary), narrower than
    the k + 1 ghost columns it raises."""
    from agglomerationmultigrid1d_tpu_torch.parallel import SolverGroup, sharded_multisweep

    g = SolverGroup(group=None, rank=0, world=1, device=cuda, backend="nccl")  # a ring of one: no exchange
    for n in (5, 3):
        l, d, u, sinv, ml, mu, x, b = _inputs(n, 2, n, cuda)
        a = BlockTridiag(l, d, u)
        bk.reset_launch_counts()
        if n == 3:
            with pytest.raises(ValueError, match="narrower"):
                sharded_multisweep(g, a, sinv, x, b, ml=ml, mu=mu)
            continue
        got = sharded_multisweep(g, a, sinv, x, b, ml=ml, mu=mu)
        want = bk.multisweep_plain(ml, mu, sinv, x, b)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert bk.LAUNCHES["multisweep_ghost"] == 1 and bk.LAUNCHES["multisweep"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("smoother", ["jac", "hybridSchwarz"])
def test_cuda_cg_topped_xl_build_equals_cpu_build(cuda, smoother):
    """The CG-topped stencil build on the card equals the one on the CPU:
    every float32 leaf to 3e-7 of its max (the same host stencil, inflated
    by broadcasts), the float64 rhs to 1e-12, ``norm_b`` to 1e-12."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_map

    n = 2048
    spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=3, p_agg=1, c_dir=1000.0 * n, cg_smoother=smoother)
    outs = [build_xl_problem(spec, n, ff_levels=True, device=dev) for dev in (cuda, "cpu")]
    leaves = [[], []]
    for out, acc in zip(outs, leaves):
        tree_map(acc.append, (out[0].levels, out[0].transfers, out[1].a_ffs, out[1].t_los))
    assert len(leaves[0]) == len(leaves[1]) > 40
    for got, want in zip(*leaves):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        if want.numel():
            scale = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= 3e-7 * scale
    b_gpu, b_cpu = ff_join(outs[0][2]).cpu(), ff_join(outs[1][2])
    assert float((b_gpu - b_cpu).abs().max()) <= 1e-12 * float(b_cpu.abs().max())
    assert abs(outs[0][3] - outs[1][3]) <= 1e-12 * outs[1][3]


@pytest.mark.cuda
def test_cuda_ragged_transfers_equal_cpu(cuda):
    """A ragged hierarchy's transfers on the card: prolongation (a gather
    through the owner table), restriction and the Galerkin product equal
    the CPU's in float64 (to 1e-14 of the largest entry), and the ragged
    float32 solve launches K1 / K2 / K3."""
    from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import (
        RaggedBlockProlong,
        rbp_galerkin,
        rbp_prolong,
        rbp_restrict,
    )
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    prob = poisson_dg_hierarchy(n=1000, max_p=3, n_dg=2, n_agg=5, device="cpu")
    rng = np.random.default_rng(0)
    n_ragged = 0
    for k, t in enumerate(prob.hierarchy.transfers):
        if not isinstance(t, RaggedBlockProlong):
            continue
        n_ragged += 1
        tg = tree_to(t, cuda)
        xc = torch.from_numpy(rng.standard_normal((t.bs_coarse, t.n_coarse)))
        rf = torch.from_numpy(rng.standard_normal((t.bs_fine, t.n_fine)))
        for got, want in ((rbp_prolong(tg, xc.to(cuda)), rbp_prolong(t, xc)),
                          (rbp_restrict(tg, rf.to(cuda)), rbp_restrict(t, rf))):
            assert float((got.cpu() - want).abs().max()) <= 1e-14 * float(want.abs().max())
        fine_a = prob.hierarchy.levels[k].a
        for got, want in zip(rbp_galerkin(tg, tree_to(fine_a, cuda)), rbp_galerkin(t, fine_a)):
            assert float((got.cpu() - want).abs().max()) <= 1e-14 * float(want.abs().max())
    assert n_ragged >= 2
    h = tree_to(prob.hierarchy, cuda)
    b = prob.b.to(cuda)
    bk.reset_launch_counts()
    res = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * float(torch.linalg.vector_norm(b))
    assert all(bk.LAUNCHES[k] > 0 for k in ("multisweep", "multisweep_residual", "bt_matvec"))


@pytest.mark.cuda
def test_cuda_penta_and_scattered_chains(cuda):
    """The mixed-switch chain on the card: float64 ``multigrid`` and
    ``multigrid_progressive`` (whose float32 stopping test reads a 0-d
    tensor on the card) with the CPU's counts and none of K1-K8 launched; the
    scattered chain: ``multigrid_mixed`` with one K1 / K2 / K3 launch per
    V-cycle (the fine level only), its block-COO matvec equal to the CPU's."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        interleaved_pair_groups,
        level_matvec,
        multigrid_progressive,
        poisson_scattered_hierarchy,
        poisson_switch_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    counts = {}
    for dev in ("cpu", cuda):
        prob = poisson_switch_hierarchy(1024, 2, device=dev)
        h, b = prob.hierarchy, prob.b
        h32 = make_low_precision_hierarchy(h)
        bk.reset_launch_counts()
        r1 = multigrid(h, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
        r2 = multigrid_progressive(h, h32, torch.zeros_like(b), b, 80, 1e-10)
        assert not any(v for k, v in bk.LAUNCHES.items() if k not in GEMV_KEYS)
        nb = float(torch.linalg.vector_norm(b))
        assert float(r2.res_history[r2.iterations - 1]) < 1e-10 * nb
        counts[str(dev)] = (r1.iterations, r2.iterations)
    assert counts["cpu"] == counts[str(cuda)], counts

    prob = poisson_scattered_hierarchy(n=8192, p_dg=1, groups_per_level=interleaved_pair_groups(8192, 1024),
                                       device="cpu")
    h = tree_to(prob.hierarchy, cuda)
    b = prob.b.to(cuda)
    x = torch.randn(prob.b.shape, dtype=torch.float64)
    for k in (1, 2):
        got = level_matvec(h.levels[k], x[:, : h.levels[k].a.n_cols].to(cuda)).cpu()
        want = level_matvec(prob.hierarchy.levels[k], x[:, : h.levels[k].a.n_cols])
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    bk.reset_launch_counts()
    res = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * float(torch.linalg.vector_norm(b))
    for k in ("multisweep", "multisweep_residual", "bt_matvec"):
        assert bk.LAUNCHES[k] == res.inner_cycles, (k, dict(bk.LAUNCHES), res.inner_cycles)


def _einsum_restrict(blocks, rf):
    r, out = blocks.shape[0], None
    for j in range(r):
        oj = torch.einsum("ibn,in->bn", blocks[j], rf[:, j::r])
        out = oj if out is None else out + oj
    return out


def _einsum_contractions(monkeypatch):
    """Send every block contraction on the card to the einsum its kernel
    replaced (the CPU lines of ``bd_matvec``, ``bp_prolong`` and
    ``bp_restrict``, uncounted), the true cycles' Chebyshev steps to the
    plain chain in place of K14 (whose block-Jacobi apply rounds as K9): the
    path before K9-K11 and K14."""
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops import transfer_ops
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, ff_add

    monkeypatch.setattr(solvers, "_chebyshev_k14", lambda s, degree, u, residual: solvers._chebyshev(
        s, degree, u, residual, lambda v, d: ff_add(v, FF(d, torch.zeros_like(d)))))

    monkeypatch.setattr(bk, "bd_gemv", lambda blocks, x: torch.einsum("ijn,jn->in", blocks, x))
    monkeypatch.setattr(transfer_ops, "bp_prolong_gemv", lambda blocks, xc: torch.einsum(
        "jibn,bn->jin", blocks, xc).permute(1, 2, 0).reshape(blocks.shape[1], blocks.shape[0] * xc.shape[-1]))
    monkeypatch.setattr(transfer_ops, "bp_restrict_gemv", _einsum_restrict)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_gemv_kernels_equal_plain(cuda, dtype):
    """The three contraction kernels equal their plain versions bit for bit:
    every block size and pair of ``SUPPORTED_BLOCK_SIZES``, r = 1, 2, 3, 4,
    column counts off the 256-thread block, a strided vector and an expanded
    r = 1 prolongation; one launch per call.  A block size outside the range
    raises."""
    from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import block_prolong_constant

    g = torch.Generator(device=cuda).manual_seed(17)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda, dtype=dtype)

    bk.reset_launch_counts()
    calls = 0
    for bs in bk.SUPPORTED_BLOCK_SIZES:
        for n in (1, 255, 257, 70001):
            blocks, x = rnd(bs, bs, n), rnd(bs, 2 * n)
            for v in (x[:, :n].contiguous(), x[:, ::2]):
                assert torch.equal(bk.bd_gemv(blocks, v), bk.bd_gemv_plain(blocks, v))
                calls += 1
    for bs_f in bk.SUPPORTED_BLOCK_SIZES:
        for bs_c in bk.SUPPORTED_BLOCK_SIZES:
            for r, n_c in ((1, 70001), (2, 257), (3, 1000), (4, 33333)):
                blocks, xc, rf = rnd(r, bs_f, bs_c, n_c), rnd(bs_c, n_c), rnd(bs_f, r * n_c)
                assert torch.equal(bk.bp_prolong_gemv(blocks, xc), bk.bp_prolong_gemv_plain(blocks, xc))
                assert torch.equal(bk.bp_restrict_gemv(blocks, rf), bk.bp_restrict_gemv_plain(blocks, rf))
    blocks = block_prolong_constant(rnd(4, 2), 4097).blocks
    xc, rf = rnd(2, 4097), rnd(4, 4097)
    assert torch.equal(bk.bp_prolong_gemv(blocks, xc), bk.bp_prolong_gemv_plain(blocks, xc))
    assert torch.equal(bk.bp_restrict_gemv(blocks, rf), bk.bp_restrict_gemv_plain(blocks, rf))
    assert bk.LAUNCHES["bd_gemv"] == calls
    assert bk.LAUNCHES["bp_prolong_gemv"] == bk.LAUNCHES["bp_restrict_gemv"] == 36 * 4 + 1
    with pytest.raises(ValueError, match="no kernel"):
        bk.bd_gemv(rnd(6, 6, 8), rnd(6, 8))
    with pytest.raises(ValueError, match="no kernel"):
        bk.bp_prolong_gemv(rnd(2, 6, 2, 8), rnd(2, 8))


def _north_star_like(n: int, cuda):
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, first_agg_factor=4, agg_factor=4,
                         c_dir=1000.0 * n)
    return build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device=cuda)


@pytest.mark.cuda
def test_cuda_gemv_kernels_on_the_cells_hierarchies(cuda):
    """The four benchmark cells' hierarchies, cut in size, solved as their
    cells solve them (``multigrid_mixed`` and float64 ``multigrid`` on the
    DG p = 3, p = 1, agglomerated slice; ``multigrid_true`` and the hand-over
    on the 4:1 DG p = 1 chain), and the max_p = 4 slice of the on-device
    examples (bs 5 on the fine level, a 5 -> 3 transfer): every block
    contraction launches its kernel.  ``multigrid_true``'s block-Jacobi
    applies are all inside K14 (``ff_cheb_update``), which its true cycles
    launch (the hand-over here ends before any true cycle)."""
    from agglomerationmultigrid1d_tpu_torch.models import multigrid_true
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    prob = poisson_dg_hierarchy(n=8192, max_p=3, n_dg=2, n_agg=6, device=cuda)
    h, b = prob.hierarchy, prob.b
    runs = {}
    bk.reset_launch_counts()
    multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    runs["mixed"] = {k: bk.LAUNCHES[k] for k in GEMV_KEYS}
    bk.reset_launch_counts()
    multigrid(h, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
    runs["f64"] = {k: bk.LAUNCHES[k] for k in GEMV_KEYS}
    h_low, ffops, b_ff, norm_b = _north_star_like(65536, cuda)
    bk.reset_launch_counts()
    multigrid_true(h_low, ffops, b_ff, norm_b, 40, 1e-8)
    runs["true"] = {k: bk.LAUNCHES[k] for k in GEMV_KEYS}
    k14 = bk.LAUNCHES["ff_cheb_update"]
    bk.reset_launch_counts()
    zero = torch.zeros_like(b_ff.hi)
    solvers._mixed_loop_ff(h_low, ffops.a_ffs[0], FF(zero, zero), b_ff, np.float32(1 / norm_b), ffops=ffops,
                           maxiter=100, tol=1e-8, inner_tol=3e-5, max_inner=20)
    runs["handover"] = {k: bk.LAUNCHES[k] for k in GEMV_KEYS}
    its = {}
    for dev in ("cpu", cuda):  # max_p = 4: DG p = 4, 2, 1 (bs 5, 3, 2), then the agglomerated levels
        prob = poisson_dg_hierarchy(n=4096, max_p=4, n_dg=3, n_agg=6, device=dev)
        bk.reset_launch_counts()
        its[str(dev)] = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 80, 1e-10,
                                  compute_error=False).iterations
    runs["max_p4"] = {k: bk.LAUNCHES[k] for k in GEMV_KEYS}
    assert its["cpu"] == its[str(cuda)], its
    # the mixed cell smooths through K1 / K2, the true cycles through K14: no block-Jacobi apply of its own
    for cell, counts in runs.items():
        assert all(counts[k] > 0 for k in GEMV_KEYS if (cell, k) not in (("mixed", "bd_gemv"), ("true", "bd_gemv"))), (
            cell, counts)
    assert k14 > 0


@pytest.mark.cuda
def test_cuda_true_cycle_rounds_as_the_einsum(cuda, monkeypatch):
    """At the G7 witness's size and conditioning (16,384 elements, eps_f32
    kappa_elem ~ 6, where the rounding of ``T e_hi`` decides the contraction
    rate) ``multigrid_true`` through the kernels takes the einsum path's
    cycles and residual history, bit for bit (the block-Jacobi apply of the
    true cycles' smoothing inside K14 on one side, the einsum on the
    other)."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    n = 16384
    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, agg_factor=4,
                         c_dir=1000.0 * float(3 << 24) ** 2 / n)
    prob = build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device=cuda)
    bk.reset_launch_counts()
    kern = multigrid_true(*prob, 25, 1e-10)
    assert all(bk.LAUNCHES[k] > 0 for k in ("bp_prolong_gemv", "bp_restrict_gemv", "ff_cheb_update"))
    _einsum_contractions(monkeypatch)
    bk.reset_launch_counts()
    ein = multigrid_true(*prob, 25, 1e-10)
    assert not any(bk.LAUNCHES[k] for k in (*GEMV_KEYS, "ff_cheb_update"))
    it = kern.iterations
    assert it == ein.iterations
    assert torch.equal(kern.res_history[:it], ein.res_history[:it])  # NaN beyond the cycles run
