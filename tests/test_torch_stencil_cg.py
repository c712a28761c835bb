"""The torch port's CG-topped stencil inflation and its float-float solves
against the JAX package's, on the CPU.

* ``build_xl_problem`` of the flagship chain at n = 2048 (CG p = 8, 4, 2, 1,
  the seam, 3 agglomerated levels, c_dir = 1000 n; Jacobi and hybrid
  Schwarz, Chebyshev off and on) against JAX's, leaf by leaf: float32
  leaves to 3e-7 of the leaf's max, the rhs (hi + lo) to 1e-12 relative,
  ``norm_b`` to 1e-12, the float-float fine band's hi + lo to 1e-11;
* the same build against the port's own host build (``build_problem`` +
  strip + cast + ``prepare_fast_smoothers`` + ``cg_band_split``), as JAX's
  ``test_inflated_flagship_matches_direct_build`` holds JAX's;
* the ``ff_levels`` bundle: every lo tail through hi + lo to 1e-11, None
  lo tails on the CG and seam transfers;
* node-axis extraction refusing a graded mesh, and inflating a uniform one
  exactly;
* ``_mixed_loop_ff`` against JAX's ``_mixed_loop_ff(use_pallas=False)`` on
  shared inputs (``xl_problem_from_numpy``), CG-topped (damped and
  Chebyshev), DG full and DG slim: within 1 outer step and 2 V-cycles, both
  below 1e-10.  These run at c_dir = 10 n and a CG chain p = 2, 1, where the
  float32 inner V-cycle contracts.  At the flagship's c_dir = 1000 n it is
  noise-dominated and the two packages' counts part by up to 2 outer steps,
  as JAX's own full and slim bundles of one problem do (ROADMAP queue 3,
  G13): the flagship spec itself is held there to 2 outer steps and 2
  V-cycles;
* ``multigrid_true`` on the CG-topped ``FFOps`` against JAX's, on shared
  inputs and on the port's own build: within 1 cycle, below tol.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.solvers import _mixed_loop_ff as jmixed_loop_ff
from agglomerationmultigrid1d_tpu.models.solvers import multigrid_true as jmultigrid_true
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.ops.df64 import FF as JFF
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.models import (
    FFOps,
    build_problem,
    build_xl_problem,
    multigrid_true,
    prepare_fast_smoothers,
    strip_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d_tpu_torch.models.stencil_setup import _extract_nodes, _inflate_nodes, _stencil_mesh
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, CgBandFF, cg_band_split, ff_join
from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import BlockProlong
from agglomerationmultigrid1d_tpu_torch.utils import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy
from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype, tree_map

N = 2048
F32_TOL = 3e-7  # of each float32 leaf's max: one ulp of jitter at rounding edges
FF_TOL = 1e-11  # hi + lo of a float-float leaf, of its max


def _flagship(smoother="jac", n=N):
    return dict(cg_orders=(8, 4, 2, 1), n_agg_levels=3, p_agg=1, c_dir=1000.0 * n, cg_smoother=smoother)


@functools.lru_cache(maxsize=None)
def _jax_xl(spec_items, n, kw_items):
    out = jbuild_xl_problem(JHierarchySpec(**dict(spec_items)), n, **dict(kw_items))
    return out, jax.tree_util.tree_map(np.asarray, out[:3])


@functools.lru_cache(maxsize=None)
def _port_xl(spec_items, n, kw_items):
    return build_xl_problem(HierarchySpec(**dict(spec_items)), n, device="cpu", **dict(kw_items))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-300), err_msg=what)


def _pair_sum(p) -> np.ndarray:
    hi, lo = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (p.hi, p.lo))
    return hi.astype(np.float64) + lo.astype(np.float64)


CASES = [("jac", False), ("jac", True), ("hybridSchwarz", False), ("hybridSchwarz", True)]


@pytest.mark.parametrize("smoother,cheb", CASES, ids=[f"{s}-{'cheb' if c else 'damped'}" for s, c in CASES])
def test_cg_xl_problem_matches_jax(smoother, cheb):
    spec, kw = tuple(_flagship(smoother).items()), (("chebyshev", cheb),)
    (_, _, _, jnb), (jh, jff, jb) = _jax_xl(spec, N, kw)
    h, a_ff, b, nb = _port_xl(spec, N, kw)
    assert isinstance(a_ff, CgBandFF)
    got = _leaves((h.levels, h.transfers, h.coarse, a_ff.hi))
    want = jax.tree_util.tree_leaves((jh.levels, jh.transfers, jh.coarse, jff.hi))
    assert len(got) == len(want) > 40
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and w.dtype == np.float32, i
        if w.size:
            _close(g, w, F32_TOL, f"leaf {i}")
    _close(torch.from_numpy(_pair_sum(a_ff)), _pair_sum(jff), FF_TOL, "a_ff hi + lo")
    _close(ff_join(b), _pair_sum(jb), 1e-12, "b")
    np.testing.assert_allclose(nb, jnb, rtol=1e-12)


@pytest.mark.parametrize("smoother", ["jac", "hybridSchwarz"])
def test_cg_xl_problem_matches_port_host_build(smoother):
    """The inflated hierarchy equals the direct full-size host build: CG
    windows and bands, Jacobi diagonals, Schwarz inverses and
    multiplicities, the seam's windows and lumped mass, the agglomerated
    levels, the CG band's float-float pair and the rhs."""
    spec = _flagship(smoother)
    h, a_ff, b, nb = _port_xl(tuple(spec.items()), N, (("chebyshev", False),))
    prob = build_problem(HierarchySpec(**spec), N, device="cpu")
    h64 = strip_hierarchy(prob.hierarchy)
    ref = prepare_fast_smoothers(hierarchy_astype(h64, torch.float32))
    got, want = _leaves((h.levels, h.transfers)), _leaves((ref.levels, ref.transfers))
    assert len(got) == len(want) > 30
    for i, (g, w) in enumerate(zip(got, want)):
        if w.numel():
            _close(g, w, F32_TOL, f"leaf {i}")
    ref_ff = cg_band_split(h64.levels[0].a.band)
    _close(a_ff.hi, ref_ff.hi, F32_TOL, "a_ff.hi")
    _close(torch.from_numpy(_pair_sum(a_ff)), _pair_sum(ref_ff), FF_TOL, "a_ff hi + lo")
    _close(ff_join(b), prob.b, 1e-12, "b")
    np.testing.assert_allclose(nb, float(torch.linalg.vector_norm(prob.b)), rtol=1e-12)


def test_cg_ff_levels_bundle():
    """``ff_levels=True`` on a CG-topped chain: per-level float-float
    operators (CG bands, then block pairs), lo tails through hi + lo against
    the JAX package's, None lo tails on the CG and seam transfers, the
    float64 coarse factorization."""
    spec, kw = tuple(_flagship().items()), (("chebyshev", False), ("ff_levels", True))
    (_, _, _, jnb), (jh, jff, jb) = _jax_xl(spec, N, kw)
    h, ff, b, nb = _port_xl(spec, N, kw)
    assert isinstance(ff, FFOps)
    assert [type(a).__name__ for a in ff.a_ffs] == ["CgBandFF"] * 4 + ["BlockTridiagFF"] * 3
    assert [t is None for t in ff.t_los] == [True] * 4 + [False] * 2
    assert all(t is None for t in jff.t_los[:4])
    for k, (a, ja) in enumerate(zip(ff.a_ffs, jff.a_ffs)):
        if isinstance(a, CgBandFF):
            _close(torch.from_numpy(_pair_sum(a)), _pair_sum(ja), FF_TOL, f"a_ffs[{k}]")
        else:
            for f in ("lower", "diag", "upper"):
                got = getattr(a.hi, f).double() + getattr(a.lo, f).double()
                want = np.asarray(getattr(ja.hi, f), np.float64) + np.asarray(getattr(ja.lo, f), np.float64)
                _close(got, want, FF_TOL, f"a_ffs[{k}].{f}")
    for k, (t, jt) in enumerate(zip(ff.t_los[4:], jff.t_los[4:])):
        assert isinstance(t, BlockProlong)
        h32 = h.transfers[4 + k].blocks.double()
        _close(h32 + t.blocks.double(), np.asarray(jh.transfers[4 + k].blocks, np.float64) + np.asarray(jt.blocks),
               FF_TOL, f"t_los[{4 + k}]")
    assert all(x.dtype == torch.float64 for x in _leaves(ff.coarse64) if x.is_floating_point())
    _close(ff_join(b), _pair_sum(jb), 1e-12, "b")


def test_node_extraction_rejects_graded_mesh():
    """A CG band on a graded mesh is not periodic: the node-axis extraction
    refuses it.  On a uniform mesh the band's stencil inflates back to the
    full-size band exactly."""
    from agglomerationmultigrid1d_tpu_torch.mesh.topology import create_graded_mesh

    spec = HierarchySpec(cg_orders=(4, 2), n_agg_levels=1, c_dir=1000.0 * 64)
    graded = build_problem(spec, 64, mesh=create_graded_mesh(64, 0.0, 1.0), device="cpu").hierarchy
    band = graded.levels[0].a.band
    with pytest.raises(ValueError, match="translation invariant"):
        _extract_nodes(band, 4, 4, "band")
    uniform = build_problem(spec, 64, device="cpu").hierarchy.levels[1]
    small = build_problem(spec, 16, mesh=_stencil_mesh(16, 1 / 64), device="cpu").hierarchy.levels[1]
    for arr in (small.a.band, small.smoother.inv_diag):
        big = _inflate_nodes(_extract_nodes(arr, 2, 4, "node"), 64, 2, 4, "cpu")
        want = uniform.a.band if arr is small.a.band else uniform.smoother.inv_diag
        _close(big, want, 1e-11, "inflated node axis")


LOOP_N = 2048
LOOP_CASES = {  # name: (spec, n, build keywords, (outer steps, V-cycles) allowed apart from JAX's)
    "cg-damped": (dict(cg_orders=(2, 1), n_agg_levels=3, p_agg=1, c_dir=10.0 * LOOP_N), LOOP_N, (("chebyshev", False),),
                  (1, 2)),
    "cg-cheb": (dict(cg_orders=(2, 1), n_agg_levels=3, p_agg=1, c_dir=10.0 * LOOP_N), LOOP_N, (("chebyshev", True),),
                (1, 2)),
    "dg-full": (dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=10.0 * 4096), 4096, (("z", 8),),
                (1, 2)),
    "dg-slim": (dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=10.0 * 4096), 4096,
                (("z", 8), ("slim_fine", True)), (1, 2)),
    # the flagship spec (CG p = 8, 4, 2, 1, c_dir = 1000 n): the inner cycle is noise-dominated (G13)
    "flagship-damped": (_flagship(), N, (("chebyshev", False),), (2, 2)),
    "flagship-cheb": (_flagship(), N, (("chebyshev", True),), (2, 2)),
}


@pytest.mark.parametrize("name", list(LOOP_CASES))
def test_mixed_loop_ff_matches_jax_on_shared_inputs(name):
    spec, n, kw, (d_outer, d_cycles) = LOOP_CASES[name]
    (jh, ja, jb, jnb), np_parts = _jax_xl(tuple(spec.items()), n, kw)
    h, a_ff, b, nb = xl_problem_from_numpy(*np_parts, jnb, device="cpu")
    loop = dict(maxiter=60, tol=1e-10, inner_tol=3.0e-5, max_inner=20)
    zero = jnp.zeros_like(jb.hi)
    jx, jouter, jcycles, jhist = jmixed_loop_ff(
        jh, ja, JFF(zero, zero), jb, jnp.asarray(1.0 / jnb, jnp.float32), n_pre=3, n_post=3, alpha=2.0 / 3.0,
        use_pallas=False, **loop)
    z = torch.zeros_like(b.hi)
    x, outer, cycles, hist = _mixed_loop_ff(h, a_ff, FF(z, z), b, np.float32(1.0 / nb), **loop)
    jouter, jcycles = int(jouter), int(jcycles)
    assert abs(outer - jouter) <= d_outer and abs(cycles - jcycles) <= d_cycles, (outer, cycles, jouter, jcycles)
    assert hist.dtype == np.float32 and hist[outer - 1] < 1e-10 and np.asarray(jhist)[jouter - 1] < 1e-10
    assert np.isnan(hist[outer:]).all()
    assert tuple(x.hi.shape) == tuple(jb.hi.shape)


@pytest.mark.parametrize("shared", [True, False], ids=["shared-inputs", "port-build"])
def test_multigrid_true_on_cg_topped_ffops_matches_jax(shared):
    spec, kw = tuple(_flagship().items()), (("chebyshev", False), ("ff_levels", True))
    (jh, jff, jb, jnb), np_parts = _jax_xl(spec, N, kw)
    jres = jmultigrid_true(jh, jff, jb, jnb, 40, 1e-8)
    args = xl_problem_from_numpy(*np_parts, jnb, device="cpu") if shared else _port_xl(spec, N, kw)
    res = multigrid_true(*args, 40, 1e-8)
    j_it = int(jres.iterations)
    assert abs(res.iterations - j_it) <= 1, (res.iterations, j_it)
    hist = res.res_history.numpy()
    assert hist[res.iterations - 1] < 1e-8 * jnb and np.isnan(hist[res.iterations:]).all()
    # the relative residual recomputed independently in float64 on the CG band
    from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import CgOperator, cg_matvec

    a_ff = args[1].a_ffs[0]
    band64 = torch.from_numpy(_pair_sum(a_ff))
    b64 = ff_join(args[2])
    rel = float(torch.linalg.vector_norm(b64 - cg_matvec(CgOperator(windows=args[0].levels[0].a.windows.double(),
                                                                     band=band64), res.x)) / torch.linalg.vector_norm(b64))
    assert rel < 1e-8
