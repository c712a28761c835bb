"""Kernels K7 (ghosted multisweep and Chebyshev), K8 (one A-form sweep) and
K4 (the bandwidth yardstick) of the torch port on the CPU, through their
plain versions, and the sharded smoothers over a 4-rank gloo group.

* K7's plain version against the JAX package's ghosted Pallas kernels
  (``_multisweep_impl(..., ghosts=)``, ``pallas_chebyshev_multisweep(...,
  ghosts=)``, interpret mode), all four forms, bs 2 and 4, to 1e-5 of
  ``max|out|`` (float32, the tolerance the CUDA kernels are held to);
* the edge pair's plain versions (both shard edges from their own windows,
  ghosts from the received messages), all four forms, bs 2 and 4: against
  K7's whole-shard plain version cropped to the edges (1e-6 of ``max|out|``:
  the same float32 operations on the same columns) and against the same
  ghosted Pallas kernels (1e-5); a ring end (``None``) against zero ghosts,
  exactly; the packing's plain version, exactly; ``EdgePlan`` on the CPU
  (in place, nothing outside the edges) and what it refuses;
* K8's against ``pallas_block_jacobi_sweep(interpret=True)``, K4's against
  its definition;
* ``sharded_multisweep`` / ``sharded_chebyshev_multisweep`` with ``overlap``
  True and False against the JAX package's sharded versions on a 4-device
  mesh and against the unsharded sweeps (``tests/test_sharded_kernels.py``
  is the model), float32 through K7's plain version (a 5-column shard
  through one whole-shard launch, a 3-column one through the halo-aware
  plain sweep), float64 through the halo-aware plain sweep;
* the sharded V-cycle (float64, and float32 through K7's schedule on every
  sharded level) and f64 ``multigrid`` (``distributed_v_cycle`` /
  ``distributed_multigrid``) against the unsharded port and the JAX
  package's fused solve (``shard=``).

The port's side of the group runs in one spawned 4-rank gloo group per
module (``torch_group.run_group``), under a time limit.  The CUDA kernels
themselves are tested in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_group as tg
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.ops import BlockTridiag as JBlockTridiag
from agglomerationmultigrid1d_tpu.ops.block_tridiag import block_mul as jblock_mul
from agglomerationmultigrid1d_tpu.ops.pallas import chebyshev_coefficients as jcoef
from agglomerationmultigrid1d_tpu.ops.pallas import pallas_block_jacobi_sweep, pallas_chebyshev_multisweep
from agglomerationmultigrid1d_tpu.ops.pallas.block_kernels import _multisweep_impl
from agglomerationmultigrid1d_tpu.parallel import fused_shard_spec as jfused_shard_spec
from agglomerationmultigrid1d_tpu.parallel import make_solver_mesh
from agglomerationmultigrid1d_tpu.parallel import shard_hierarchy as jshard_hierarchy
from agglomerationmultigrid1d_tpu.parallel import sharded_chebyshev_multisweep as jsharded_cheb
from agglomerationmultigrid1d_tpu.parallel import sharded_multisweep as jsharded_multisweep
from agglomerationmultigrid1d_tpu.parallel.distributed import shard_vector as jshard_vector
from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid, v_cycle
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul, bt_matvec
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

WORLD = 4
# per rank: three 128-column Pallas tiles.  JAX's overlapped schedule needs
# 2 * 640 + 128 columns a shard; below that its overlap=True runs the blocking
# schedule (which tests/test_sharded_kernels.py holds equal to it), so the
# port's two schedules are both held to JAX's blocking one
N_LOCAL = 384
FORMS = ["damped", "damped_residual", "cheb", "cheb_residual"]
CHEB = (0.2, 2.0)  # the Chebyshev interval of the sharded tests
DG = dict(n=128, max_p=4, n_dg=3)  # test_distributed.py's problem


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: arrays from JAX are read-only


def _ops(rng, bs, n, dtype=np.float32):
    """Diagonally dominant block-tridiagonal (lower, diag, upper) and the
    exact inverse of the diagonal blocks."""
    l = 0.3 * rng.standard_normal((bs, bs, n))
    u = 0.3 * rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 6 * np.eye(bs)[:, :, None]
    sinv = np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0)
    return tuple(np.ascontiguousarray(m, dtype=dtype) for m in (l, d, u, sinv))


def _mform(sinv, l, u):
    """ML, MU formed once (by the JAX package) and handed to both sides."""
    return tuple(np.asarray(jblock_mul(jnp.asarray(sinv), jnp.asarray(m))) for m in (l, u))


def _close(got, want, scale_tol=1e-5):
    for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(np.asarray(g_), w_, rtol=0, atol=scale_tol * np.abs(w_).max())


# ---------------------------------------------------------------------------
# K7, K8, K4 plain versions (one process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("form", FORMS)
def test_k7_plain_matches_ghosted_pallas(rng, form, bs):
    """n = 384 is three 128-column tiles, so the Pallas call runs its kernel
    body with the 128-column ghosts of the JAX layout."""
    n, halo = 384, 128
    l, d, u, sinv = _ops(rng, bs, n)
    ml, mu = _mform(sinv, l, u)
    x, b = (rng.standard_normal((bs, n)).astype(np.float32) for _ in range(2))
    residual = form.endswith("residual")
    gops = (0.2 * rng.standard_normal((4 if residual else 3, bs, bs, 2 * halo))).astype(np.float32)
    gvec = rng.standard_normal((2, bs, 2 * halo)).astype(np.float32)
    a = JBlockTridiag(*map(jnp.asarray, (l, d, u)))
    jargs = (a, jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b))
    jkw = dict(ghosts=(jnp.asarray(gops), jnp.asarray(gvec)), ml=jnp.asarray(ml), mu=jnp.asarray(mu))
    ghosts = (_t(gops), _t(gvec))
    targs = (_t(ml), _t(mu), _t(sinv)) + ((_t(d),) if residual else ()) + (_t(x), _t(b))
    if form.startswith("damped"):
        want = _multisweep_impl(*jargs, 3, 2.0 / 3.0, True, residual, **jkw)
        plain = bk.multisweep_residual_plain if residual else bk.multisweep_plain
        wrapper = bk.multisweep_residual if residual else bk.multisweep
        extra = (3, 2.0 / 3.0)
    else:
        coef = jcoef(jnp.float32(CHEB[0]), jnp.float32(CHEB[1]), 3)
        want = pallas_chebyshev_multisweep(*jargs, coef, 3, interpret=True, emit_residual=residual, **jkw)
        plain = bk.chebyshev_multisweep_residual_plain if residual else bk.chebyshev_multisweep_plain
        wrapper = bk.chebyshev_multisweep_residual if residual else bk.chebyshev_multisweep
        extra = (bk.chebyshev_coefficients(*CHEB, 3),)
    got = plain(*targs, *extra, ghosts=ghosts)
    _close(tuple(t.numpy() for t in got) if residual else got.numpy(), tuple(want) if residual else want)
    bk.reset_launch_counts()
    on_cpu = wrapper(*targs, *extra, ghosts=ghosts)  # the wrapper's CPU path is the plain version
    for g_, w_ in zip(on_cpu if residual else (on_cpu,), got if residual else (got,)):
        assert torch.equal(g_, w_)
    assert all(v == 0 for v in bk.LAUNCHES.values())


@pytest.mark.parametrize("form", FORMS)
def test_k7_plain_stitches_to_the_unsharded_sweeps(rng, form):
    """Two shards with their neighbours' k + 1 columns as ghosts give the
    unsharded sweeps' result, column for column (what the card's four-shard
    phase checks for the kernel)."""
    bs, n, k = 3, 200, 3
    l, d, u, sinv = (_t(m) for m in _ops(rng, bs, n, np.float64))
    ml, mu = block_mul(sinv, l), block_mul(sinv, u)
    x, b = _t(rng.standard_normal((bs, n))), _t(rng.standard_normal((bs, n)))
    residual = form.endswith("residual")
    coef = bk.chebyshev_coefficients(*CHEB, k)
    ops = (ml, mu, sinv) + ((d,) if residual else ())
    fn = {
        "damped": lambda o, xx, bb, gh: bk.multisweep_plain(*o, xx, bb, k, ghosts=gh),
        "damped_residual": lambda o, xx, bb, gh: bk.multisweep_residual_plain(*o, xx, bb, k, ghosts=gh),
        "cheb": lambda o, xx, bb, gh: bk.chebyshev_multisweep_plain(*o, xx, bb, coef, ghosts=gh),
        "cheb_residual": lambda o, xx, bb, gh: bk.chebyshev_multisweep_residual_plain(*o, xx, bb, coef, ghosts=gh),
    }[form]
    want = fn(ops, x, b, None)
    g, half = k + 1, n // 2
    parts = []
    for lo, hi in ((0, half), (half, n)):
        def ghost(t):
            left = t[..., lo - g : lo] if lo > 0 else torch.zeros_like(t[..., :g])
            right = t[..., hi : hi + g] if hi < n else torch.zeros_like(t[..., :g])
            return torch.cat([left, right], dim=-1)

        gh = (torch.stack([ghost(m) for m in (ml, mu, sinv)]), torch.stack([ghost(x), ghost(b)]))
        parts.append(fn(tuple(m[..., lo:hi] for m in ops), x[:, lo:hi], b[:, lo:hi], gh))
    if residual:
        got = tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(2))
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=0, atol=1e-12)
    else:
        torch.testing.assert_close(torch.cat(parts, dim=-1), want, rtol=0, atol=1e-12)


def test_k7_wrappers_reject_bad_ghosts(rng):
    bs, n = 2, 64
    l, d, u, sinv = (_t(m) for m in _ops(rng, bs, n))
    x, b = _t(rng.standard_normal((bs, n)).astype(np.float32)), _t(rng.standard_normal((bs, n)).astype(np.float32))
    gops, gvec = torch.zeros(3, bs, bs, 8), torch.zeros(2, bs, 8)
    with pytest.raises(ValueError, match="ghost width"):  # g = 4 < the 4 + 1 columns the residual needs
        bk.multisweep_residual(l, u, sinv, d, x, b, 4, ghosts=(gops, gvec))
    with pytest.raises(ValueError):
        bk.multisweep(l, u, sinv, x, b, 3, ghosts=(gops, gvec[:, :, :6]))
    with pytest.raises(TypeError):
        bk.chebyshev_multisweep(l, u, sinv, x, b, bk.chebyshev_coefficients(*CHEB, 3), ghosts=(gops.double(), gvec))


def test_k7_cols_write_only_those_columns(rng):
    """``cols=(lo, hi)`` with ``out=``: the sharded path's edge strips write
    their columns of the ghosted result in place and leave the rest."""
    bs, n, k = 2, 40, 3
    l, d, u, sinv = (_t(m) for m in _ops(rng, bs, n))
    ml, mu = block_mul(sinv, l), block_mul(sinv, u)
    x, b = _t(rng.standard_normal((bs, n)).astype(np.float32)), _t(rng.standard_normal((bs, n)).astype(np.float32))
    ghosts = (_t(rng.standard_normal((3, bs, bs, 8)).astype(np.float32)), _t(rng.standard_normal((2, bs, 8)).astype(np.float32)))
    want = bk.multisweep_residual_plain(ml, mu, sinv, d, x, b, k, ghosts=ghosts)
    out = (torch.full_like(x, 7.0), torch.full_like(x, 7.0))
    for cols in ((0, k + 1), (n - k - 1, n)):
        assert bk.multisweep_residual(ml, mu, sinv, d, x, b, k, ghosts=ghosts, out=out, cols=cols) is out
    for o_, w_ in zip(out, want):
        assert torch.equal(o_[:, : k + 1], w_[:, : k + 1]) and torch.equal(o_[:, -k - 1 :], w_[:, -k - 1 :])
        assert bool((o_[:, k + 1 : -k - 1] == 7.0).all())
    with pytest.raises(ValueError):
        bk.multisweep(ml, mu, sinv, x, b, k, ghosts=ghosts, out=out[0], cols=(0, n + 1))
    with pytest.raises(ValueError):
        bk.multisweep(ml, mu, sinv, x, b, k, out=out[0])
    with pytest.raises(ValueError):
        bk.multisweep(ml, mu, sinv, x, b, k, cols=(0, 4))


def _edge_case(rng, form, bs, n, g, k=3):
    """Float32 operators, x, b, random ghosts of width ``g`` in K7's layout
    and as the two received messages, and the four forms' plain functions:
    ``(whole-shard ghosted plain, edge-pair plain, EdgePlan method)`` results
    as tuples ``(x[, r])`` / ``(x_left, x_right[, r_left, r_right])``."""
    l, d, u, sinv = (_t(m) for m in _ops(rng, bs, n))
    ml, mu = block_mul(sinv, l), block_mul(sinv, u)
    x, b = (_t(rng.standard_normal((bs, n)).astype(np.float32)) for _ in range(2))
    gops = _t((0.2 * rng.standard_normal((3, bs, bs, 2 * g))).astype(np.float32))
    gvec = _t(rng.standard_normal((2, bs, 2 * g)).astype(np.float32))
    msgs = (gvec[..., :g].contiguous(), gvec[..., g:].contiguous())
    residual = form.endswith("residual")
    ops = (ml, mu, sinv) + ((d,) if residual else ())
    coef = bk.chebyshev_coefficients(*CHEB, k)
    if form.startswith("damped"):
        whole = bk.multisweep_residual_plain if residual else bk.multisweep_plain
        edge = bk.multisweep_residual_edges_plain if residual else bk.multisweep_edges_plain
        whole_fn = lambda gh: whole(*ops, x, b, k, ghosts=gh)  # noqa: E731
        edge_fn = lambda go, fl, fr: edge(*ops, x, b, go, fl, fr, k)  # noqa: E731
        plan_fn = lambda p, out: p.sweep_edges(x, b, out, k)  # noqa: E731
    else:
        whole = bk.chebyshev_multisweep_residual_plain if residual else bk.chebyshev_multisweep_plain
        edge = bk.chebyshev_multisweep_residual_edges_plain if residual else bk.chebyshev_multisweep_edges_plain
        whole_fn = lambda gh: whole(*ops, x, b, coef, ghosts=gh)  # noqa: E731
        edge_fn = lambda go, fl, fr: edge(*ops, x, b, coef, go, fl, fr)  # noqa: E731
        plan_fn = lambda p, out: p.chebyshev_edges(x, b, out, coef)  # noqa: E731
    return dict(ops=(ml, mu, sinv, d), x=x, b=b, gops=gops, gvec=gvec, msgs=msgs, residual=residual,
                whole=whole_fn, edge=edge_fn, plan=plan_fn, s=k + 1)


def _crop_edges(res, s):
    """``(x[, r])`` of the whole shard -> ``(x_left, x_right[, r_left, r_right])``."""
    res = res if isinstance(res, tuple) else (res,)
    return tuple(c for t in res for c in (t[:, :s], t[:, -s:]))


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("form", FORMS)
def test_edge_pair_plain_matches_whole_shard_plain(rng, form, bs):
    """The two edges from their own ``s + 2 halo``-column windows equal the
    whole shard's ghosted sweeps on those columns: the same float32
    operations on the same columns, so 1e-6 of ``max|out|``."""
    c = _edge_case(rng, form, bs, n=40, g=9)
    want = _crop_edges(c["whole"]((c["gops"], c["gvec"])), c["s"])
    got = c["edge"](c["gops"], *c["msgs"])
    assert len(got) == len(want) == (4 if c["residual"] else 2)
    scale = max(float(w.abs().max()) for w in want)
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == (bs, c["s"])
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("form", FORMS)
def test_edge_pair_plain_matches_ghosted_pallas(rng, form, bs):
    """Against the JAX package's ghosted Pallas kernels in interpret mode
    (n = 384, three 128-column tiles, 128-column ghosts), cropped to the
    edges: 1e-5 of ``max|out|``, as K7's plain version is held."""
    n, halo = 384, 128
    l, d, u, sinv = _ops(rng, bs, n)
    ml, mu = _mform(sinv, l, u)
    x, b = (rng.standard_normal((bs, n)).astype(np.float32) for _ in range(2))
    residual = form.endswith("residual")
    gops = (0.2 * rng.standard_normal((4 if residual else 3, bs, bs, 2 * halo))).astype(np.float32)
    gvec = rng.standard_normal((2, bs, 2 * halo)).astype(np.float32)
    a = JBlockTridiag(*map(jnp.asarray, (l, d, u)))
    jargs = (a, jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b))
    jkw = dict(ghosts=(jnp.asarray(gops), jnp.asarray(gvec)), ml=jnp.asarray(ml), mu=jnp.asarray(mu))
    msgs = (_t(gvec[..., :halo]).contiguous(), _t(gvec[..., halo:]).contiguous())
    targs = (_t(ml), _t(mu), _t(sinv)) + ((_t(d),) if residual else ()) + (_t(x), _t(b))
    if form.startswith("damped"):
        want = _multisweep_impl(*jargs, 3, 2.0 / 3.0, True, residual, **jkw)
        edge = bk.multisweep_residual_edges_plain if residual else bk.multisweep_edges_plain
        got = edge(*targs, _t(gops), *msgs, 3, 2.0 / 3.0)
    else:
        coef = jcoef(jnp.float32(CHEB[0]), jnp.float32(CHEB[1]), 3)
        want = pallas_chebyshev_multisweep(*jargs, coef, 3, interpret=True, emit_residual=residual, **jkw)
        edge = bk.chebyshev_multisweep_residual_edges_plain if residual else bk.chebyshev_multisweep_edges_plain
        got = edge(*targs, bk.chebyshev_coefficients(*CHEB, 3), _t(gops), *msgs)
    want = tuple(np.asarray(w) for w in want) if residual else (np.asarray(want),)
    scale = max(np.abs(w).max() for w in want)
    for g_, w_ in zip(got, (c for w in want for c in (w[:, :4], w[:, -4:]))):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("form", FORMS)
def test_edge_pair_ring_end_none_equals_zero_ghosts(rng, form):
    """A ring end (``None`` message) is the zero Dirichlet boundary: exactly
    the result with zero vector and operator ghosts on that side, and on both
    sides exactly the unghosted sweeps' edge columns."""
    c = _edge_case(rng, form, 2, n=40, g=9)
    g = 9
    for side, half in enumerate((slice(None, g), slice(g, None))):
        gops0 = c["gops"].clone()
        gops0[..., half] = 0
        zero = torch.zeros_like(c["msgs"][side])
        with_none = c["edge"](c["gops"], *(None if i == side else m for i, m in enumerate(c["msgs"])))
        with_zero = c["edge"](gops0, *(zero if i == side else m for i, m in enumerate(c["msgs"])))
        for n_, z_ in zip(with_none, with_zero):
            assert torch.equal(n_, z_)
    for got, want in zip(c["edge"](c["gops"], None, None), _crop_edges(c["whole"](None), c["s"])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("left,right", [(True, True), (False, True), (True, False), (False, False)])
def test_pack_edges_plain_is_exact(rng, left, right):
    bs, n, g = 3, 50, 9
    x, b = (_t(rng.standard_normal((bs, n)).astype(np.float32)) for _ in range(2))
    to_left, to_right = bk.pack_edges_plain(x, b, g, left, right)
    assert (to_left is None) == (not left) and (to_right is None) == (not right)
    if left:
        assert tuple(to_left.shape) == (2, bs, g)
        assert torch.equal(to_left[0], x[:, :g]) and torch.equal(to_left[1], b[:, :g])
    if right:
        assert torch.equal(to_right[0], x[:, -g:]) and torch.equal(to_right[1], b[:, -g:])
    ops = [_t(m) for m in _ops(rng, bs, n)]
    plan = bk.EdgePlan(*ops, torch.zeros(3, bs, bs, 2 * g), left=left, right=right)
    bk.reset_launch_counts()
    plan.pack(x, b)
    for got, want in zip((plan.to_left, plan.to_right), (to_left, to_right)):
        assert (got is None and want is None) or torch.equal(got, want)
    assert (plan.from_left is None) == (not left) and (plan.from_right is None) == (not right)
    assert all(v == 0 for v in bk.LAUNCHES.values())


@pytest.mark.parametrize("form", FORMS)
def test_edge_plan_on_cpu_rewrites_only_the_edges(rng, form):
    """``EdgePlan`` on CPU tensors runs the plain versions: the ``s`` columns
    at either edge of the outputs equal the edge pair's plain result, every
    other column is left as it was, in place, and nothing is launched."""
    c = _edge_case(rng, form, 4, n=64, g=9)
    plan = bk.EdgePlan(*c["ops"], c["gops"], left=True, right=True)
    plan.from_left.copy_(c["msgs"][0])
    plan.from_right.copy_(c["msgs"][1])
    assert plan.bound_to(*c["ops"], c["gops"]) and not plan.bound_to(*c["ops"], c["gops"].clone())
    want = c["edge"](c["gops"], *c["msgs"])
    outs = tuple(torch.full_like(c["x"], 7.0) for _ in range(2 if c["residual"] else 1))
    out = outs if c["residual"] else outs[0]
    bk.reset_launch_counts()
    assert c["plan"](plan, out) is out
    s = c["s"]
    for i, o_ in enumerate(outs):
        assert torch.equal(o_[:, :s], want[2 * i]) and torch.equal(o_[:, -s:], want[2 * i + 1])
        assert bool((o_[:, s:-s] == 7.0).all())
    assert all(v == 0 for v in bk.LAUNCHES.values())
    gvec = plan.ghost_vectors()  # K7's layout, for the whole-shard launch of a narrow shard
    assert torch.equal(gvec, c["gvec"])


def test_edge_plan_rejects_bad_inputs(rng):
    """The plan checks its operators once, then x, b and the outputs per
    call: dtype, shape, device, contiguity; the steps against its ghost
    width and the shard against two edges."""
    bs, n, g = 2, 32, 4
    l, d, u, sinv = (_t(m) for m in _ops(rng, bs, n))
    gops = torch.zeros(3, bs, bs, 2 * g)
    x, b = (_t(rng.standard_normal((bs, n)).astype(np.float32)) for _ in range(2))
    with pytest.raises(TypeError):
        bk.EdgePlan(l, u, sinv, d.double(), gops, left=True, right=True)
    with pytest.raises(ValueError):
        bk.EdgePlan(l, u, sinv[..., :-1].contiguous(), d, gops, left=True, right=True)
    with pytest.raises(ValueError, match="ghost operators"):
        bk.EdgePlan(l, u, sinv, d, gops[..., :7].contiguous(), left=True, right=True)
    with pytest.raises(ValueError, match="contiguous"):
        bk.EdgePlan(l, u.transpose(0, 1), sinv, d, gops, left=True, right=True)
    plan = bk.EdgePlan(l, u, sinv, d, gops, left=True, right=False)
    out = torch.empty_like(x)
    with pytest.raises(TypeError):
        plan.sweep_edges(x.double(), b, out)
    with pytest.raises(TypeError):
        plan.pack(x, b.double())
    with pytest.raises(ValueError, match="shape"):
        plan.sweep_edges(x[:, :-1].contiguous(), b, out)
    with pytest.raises(ValueError, match="shape"):
        plan.sweep_edges(x, b, (out, torch.empty(bs, n + 1)))
    with pytest.raises(ValueError, match="device"):
        plan.sweep_edges(x, b, torch.empty(bs, n, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        plan.chebyshev_edges(x, b.t().contiguous().t(), out, bk.chebyshev_coefficients(*CHEB, 3))
    with pytest.raises(ValueError, match="ghost width"):  # g = 4 < the 4 + 1 columns the residual needs
        plan.sweep_edges(x, b, (out, torch.empty_like(x)), 4)
    with pytest.raises(ValueError, match="n_sweeps"):
        plan.sweep_edges(x, b, out, bk.MAX_SWEEPS + 1)
    l5, d5, u5, sinv5 = (_t(m) for m in _ops(rng, bs, 5))
    narrow = bk.EdgePlan(l5, u5, sinv5, d5, gops, left=True, right=True)
    with pytest.raises(ValueError, match="narrower"):
        narrow.sweep_edges(torch.zeros(bs, 5), torch.zeros(bs, 5), torch.zeros(bs, 5), 3)
    with pytest.raises(ValueError, match="ghost columns"):
        bk.EdgePlan(l5, u5, sinv5, d5, torch.zeros(3, bs, bs, 12), left=True, right=True)


@pytest.mark.parametrize("bs", [2, 4])
def test_k8_plain_matches_pallas_sweep(rng, bs):
    """A-form: S^-1 need not invert A_D (JAX's test feeds a random one)."""
    n = 384
    l, d, u, _ = _ops(rng, bs, n)
    sinv = rng.standard_normal((bs, bs, n)).astype(np.float32)
    x, b = (rng.standard_normal((bs, n)).astype(np.float32) for _ in range(2))
    want = pallas_block_jacobi_sweep(
        JBlockTridiag(*map(jnp.asarray, (l, d, u))), jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b),
        interpret=True,
    )
    a = BlockTridiag(_t(l), _t(d), _t(u))
    got = bk.block_jacobi_sweep_plain(a, _t(sinv), _t(x), _t(b))
    _close(got.numpy(), want)
    bk.reset_launch_counts()
    assert torch.equal(bk.block_jacobi_sweep(a, _t(sinv), _t(x), _t(b)), got)
    assert bk.LAUNCHES["block_jacobi_sweep"] == 0


@pytest.mark.parametrize("bs", [2, 4])
def test_k4_plain_matches_its_definition(rng, bs):
    n = 1000
    ml, mu, sinv = (rng.standard_normal((bs, bs, n)).astype(np.float32) for _ in range(3))
    x, b = (rng.standard_normal((bs, n)).astype(np.float32) for _ in range(2))
    want = x.astype(np.float64) + b + sum(m.astype(np.float64).sum(axis=1) for m in (ml, mu, sinv))
    got = bk.stream_kernel_plain(_t(ml), _t(mu), _t(sinv), _t(x), _t(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (bs, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(bk.stream_kernel(_t(ml), _t(mu), _t(sinv), _t(x), _t(b)), got)


# ---------------------------------------------------------------------------
# the sharded smoothers and solves over a 4-rank gloo group
# ---------------------------------------------------------------------------


def _sweep_system(seed, dtype, n_local=N_LOCAL):
    rng = np.random.default_rng(seed)
    bs, n = 4, WORLD * n_local
    l, d, u, sinv = _ops(rng, bs, n, dtype)
    x, b = (rng.standard_normal((bs, n)).astype(dtype) for _ in range(2))
    return (l, d, u), sinv, x, b


def _sweep_cases():
    """(name, kind, dtype, local columns, kw) of every sharded-smoother job."""
    cases = []
    for kind in ("damped", "cheb"):
        for overlap in (True, False):
            for residual in (False, True):
                name = f"{kind}-{'overlap' if overlap else 'blocking'}{'-residual' if residual else ''}"
                cases.append((name, kind, np.float32, N_LOCAL, dict(emit_residual=residual, overlap=overlap)))
    cases.append(("damped-f64-residual", "damped", np.float64, N_LOCAL, dict(emit_residual=True)))
    cases.append(("cheb-f64", "cheb", np.float64, N_LOCAL, dict()))
    # narrower than two 4-column strips: one ghosted launch over the shard
    cases.append(("damped-narrow-residual", "damped", np.float32, 5, dict(emit_residual=True)))
    # narrower than the 4 ghost columns 3 steps need: the halo-aware plain sweep
    cases.append(("cheb-tiny", "cheb", np.float32, 3, dict()))
    return cases


SWEEP_CASES = _sweep_cases()


def _port_kw(kind, kw, degree=3):
    kw = dict(kw)
    if kind == "cheb":
        kw.update(coef=bk.chebyshev_coefficients(*CHEB, degree), degree=degree)
    else:
        kw.update(n_sweeps=3, alpha=2.0 / 3.0)
    return kw


def _dg_problem():
    jprob = jproblems.poisson_dg_hierarchy(**DG)
    h = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy), device="cpu")
    return jprob, h, np.array(jprob.b)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jobs = []
    for name, kind, dtype, n_local, kw in SWEEP_CASES:
        a, sinv, x, b = _sweep_system(7, dtype, n_local)
        jobs.append((name, tg.job_sharded_sweeps, (a, sinv, x, b, kind, _port_kw(kind, kw))))
    _, h, b = _dg_problem()
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    jobs.append(("v_cycle", tg.job_v_cycle, (h, b, x0, 4)))
    jobs.append(("v_cycle32", tg.job_v_cycle, (h, b, x0, 4, True)))
    jobs.append(("multigrid", tg.job_multigrid, (h, b, 4)))
    store = tmp_path_factory.mktemp("gloo") / "store"
    return tg.run_group(jobs, WORLD, str(store), timeout_s=180)


def _stitch(per_rank):
    per_rank = tg.check(per_rank)
    if isinstance(per_rank[0], tuple):
        return tuple(np.concatenate([p[i] for p in per_rank], axis=-1) for i in range(len(per_rank[0])))
    return np.concatenate(per_rank, axis=-1)


def _reference(kind, a, sinv, x, b, residual):
    """The unsharded A-form sweeps in float64 (tests/test_sharded_kernels.py's reference)."""
    a64 = BlockTridiag(*(_t(m).double() for m in a))
    s64, x, b = _t(sinv).double(), _t(x).double(), _t(b).double()
    if kind == "damped":
        for _ in range(3):
            x = x + (2.0 / 3.0) * torch.einsum("ijn,jn->in", s64, b - bt_matvec(a64, x))
    else:
        d = torch.zeros_like(x)
        for c_d, c_z in bk.chebyshev_coefficients(*CHEB, 3):
            d = float(c_d) * d + float(c_z) * torch.einsum("ijn,jn->in", s64, b - bt_matvec(a64, x))
            x = x + d
    out = (x, b - bt_matvec(a64, x)) if residual else x
    return tuple(t.numpy() for t in out) if residual else out.numpy()


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_sharded_smoothers_match_jax_and_unsharded(group, case):
    name, kind, dtype, n_local, kw = case
    a, sinv, x, b = _sweep_system(7, dtype, n_local)
    got = _stitch(group[name])
    residual = kw.get("emit_residual", False)
    f32 = dtype == np.float32
    mesh = make_solver_mesh(WORLD)
    ja = JBlockTridiag(*map(jnp.asarray, a))
    jargs = (mesh, "x", ja, jnp.asarray(sinv), jnp.asarray(x), jnp.asarray(b))
    jkw = dict(kw, use_pallas=f32, interpret=True)
    if kind == "cheb":
        want = jsharded_cheb(*jargs, jcoef(jnp.float32(CHEB[0]), jnp.float32(CHEB[1]), 3), degree=3, **jkw)
    else:
        want = jsharded_multisweep(*jargs, n_sweeps=3, alpha=2.0 / 3.0, **jkw)
    want = tuple(np.asarray(w) for w in want) if residual else np.asarray(want)
    ref = _reference(kind, a, sinv, x, b, residual)
    if f32:
        # M-form float32 against JAX's M-form Pallas kernel (1e-5 of max|out|, as
        # the CUDA kernels are held), and against the float64 A-form sweeps
        _close(got, want, 1e-5)
        _close(got, ref, 2e-5)
    else:
        _close(got, want, 1e-13)
        _close(got, ref, 1e-13)


def test_fused_v_cycle_matches_unsharded(group):
    """The sharded V-cycle gives the unsharded one (float64: the halo-aware
    plain sweep, no K7 schedule), as tests/test_sharded_kernels.py checks
    for JAX."""
    _, h, b = _dg_problem()
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    want = v_cycle(h, _t(x0), _t(b)).numpy()
    got, runs = tg.check(group["v_cycle"])[0]  # every rank holds the gathered vector
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13 * np.abs(want).max())
    assert runs == 0


def test_float32_sharded_v_cycle_runs_k7_schedule(group):
    """A float32 sharded level smooths through K7's schedule, pre and post,
    on every sharded smoothed level, and the cycle equals the unsharded
    float32 one (K1/K2's plain versions) to float32 rounding."""
    _, h, b = _dg_problem()
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    h32 = make_low_precision_hierarchy(h)
    want = v_cycle(h32, _t(x0).float(), _t(b).float()).numpy()
    got, runs = tg.check(group["v_cycle32"])[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    n_sharded = sum(1 for lv in h.levels[:-1] if lv.a.n_blocks >= WORLD * 4 and lv.a.n_blocks % WORLD == 0)
    assert n_sharded > 0 and runs == 2 * n_sharded


def test_fused_multigrid_matches_jax(group):
    """f64 ``multigrid`` with ``shard=`` against the port's unsharded solve
    (equal iterations, histories to rtol 1e-9) and the JAX package's fused
    sharded solve on a 4-device mesh (equal iterations; histories to rtol
    1e-9 above the two packages' float64 floor, which the unsharded solves
    show too: on this problem they differ by 4.9e-12 = 7e-13 of the first
    residual and by 2.2e-13 = 3.9e-12 of the first error)."""
    jprob, h, b = _dg_problem()
    mesh = make_solver_mesh(WORLD)
    jh = jshard_hierarchy(jprob.hierarchy, mesh, min_blocks_per_device=4)
    jb = jshard_vector(jprob.b, mesh)
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, 50, 1e-10, shard=jfused_shard_spec(jh, mesh))
    got = tg.check(group["multigrid"])[0]
    ref = multigrid(h, torch.zeros_like(_t(b)), _t(b), 50, 1e-10)
    it = int(jres.iterations)
    assert got["iterations"] == ref.iterations == it
    for key, port, jax_h, floor in (
        ("res", ref.res_history, jres.res_history, 1e-12),
        ("err", ref.err_history, jres.err_history, 1e-11),
    ):
        np.testing.assert_allclose(got[key][:it], port.numpy()[:it], rtol=1e-9)
        want = np.asarray(jax_h)[:it]
        np.testing.assert_allclose(got[key][:it], want, rtol=1e-9, atol=floor * want[0])
    np.testing.assert_allclose(got["x"], ref.x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["x"], np.asarray(jres.x), rtol=0, atol=1e-9)
