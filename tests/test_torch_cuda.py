"""The torch port's CUDA kernels (K1-K3, K5, K6 bit for bit, K7 with ghosts
and in-place columns, K8, K4), its mixed solve, its true-precision solve and
its sharded solve on a one-rank NCCL group, on a CUDA card.

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
    """The sharded mixed solve on a one-rank NCCL group: K7 launched, the
    unsharded solve's counts and a 1e-10 residual."""
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
    assert bk.LAUNCHES["multisweep_ghost"] > 0 and bk.LAUNCHES["multisweep_residual_ghost"] > 0
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
