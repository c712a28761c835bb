"""The rank-local stencil build ``parallel.multihost.build_sharded_xl_problem``
against the port's whole build and the JAX package's, on the CPU.

The model is ``tests/test_multihost.py:37-187`` (the JAX package's
per-process build on its 8-device virtual mesh).  Here one spawned gloo
group of 2 ranks and one of 4 (``torch_group.run_group``) each build four
cases rank by rank:

* ``dg``: DG p = 1, 4 agglomerated levels, c_dir = 1000 n, n = 4096, z = 8,
  no Chebyshev, ``min_blocks_per_device=128``;
* ``cg``: the CG-topped flagship spec (CG p = 8, 4, 2, 1, 3 agglomerated
  levels), n = 2048, ``min_blocks_per_device=8``;
* ``slim``: the ``dg`` problem with ``slim_fine=True`` and Chebyshev
  smoothing (the north star's configuration), ``min_blocks_per_device=8``;
* ``ff_levels``: the ``cg`` problem with ``ff_levels=True`` (every level's
  float-float operator).

Held, per rank:

* every leaf of ``(h_low, a_ff, b_ff)``, gathered over the ranks, equal bit
  for bit to the port's whole ``build_xl_problem`` of the same arguments,
  and ``norm_b`` to 1e-14 relative;
* each rank holds its ``n / W`` fine columns (``n p / W`` nodes, one more on
  the last rank) and no tensor of the global fine width;
* ``_mixed_loop_ff`` on the sharded build reaches < 1e-10 with the outer
  steps and V-cycles of the whole build's solve, its history equal to 1e-5
  relative, x within 1e-12 of the whole build's (relative to max |x|).

And once per case, in this process: the port's whole build against the
JAX package's ``build_xl_problem`` (float32 leaves within one ulp or 3e-7 of
their max, float-float pairs hi + lo within 1e-11 of their max, the
Chebyshev bounds within 1e-6, ``norm_b`` within 1e-10, the tolerances of
``tests/test_torch_stencil*.py``), and the sharded solve's counts within 2
outer steps / 2 V-cycles of JAX's ``_mixed_loop_ff(use_pallas=False)`` on
its own build and of the port's solve of that very build (G13: at c_dir =
1000 n the float32 inner cycle follows the rounding; 3 outer steps for the
damped DG case); and the rank-local build's refusals, JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_group as tg
from agglomerationmultigrid1d_tpu.models.solvers import _mixed_loop_ff as j_mixed_loop_ff
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.ops.df64 import FF as JFF
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
from agglomerationmultigrid1d_tpu_torch.parallel import SolverGroup, build_sharded_xl_problem
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

DG_SPEC = (("cg_orders", ()), ("dg_orders", (1,)), ("n_agg_levels", 4), ("p_agg", 1), ("c_dir", 1000.0 * 4096))
CG_SPEC = (("cg_orders", (8, 4, 2, 1)), ("n_agg_levels", 3), ("p_agg", 1), ("c_dir", 1000.0 * 2048))
CASES = {  # name: (spec, n, build keywords, min_blocks_per_device)
    "dg": (DG_SPEC, 4096, (("z", 8), ("chebyshev", False)), 128),
    "cg": (CG_SPEC, 2048, (("chebyshev", False),), 8),
    "slim": (DG_SPEC, 4096, (("z", 8), ("chebyshev", True), ("slim_fine", True)), 8),
    "ff_levels": (CG_SPEC, 2048, (("chebyshev", False), ("ff_levels", True)), 8),
}
SOLVED = ("dg", "cg", "slim")
WORLDS = (2, 4)
F32_TOL = 3e-7  # of a float32 leaf's max, beside one ulp: tests/test_torch_stencil_cg.py
FF_TOL = 1e-11  # hi + lo of a float-float leaf, of its max


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {}
    for world in WORLDS:
        jobs = [(name, tg.job_sharded_xl, (case,)) for name, case in CASES.items()]
        store = tmp_path_factory.mktemp(f"gloo{world}") / "store"
        out[world] = tg.run_group(jobs, world, str(store), timeout_s=240)
    return out


def _fine_width(name, world, rank):
    spec, n = dict(CASES[name][0]), CASES[name][1]
    if spec["cg_orders"]:
        return n * spec["cg_orders"][0] // world + (rank == world - 1)
    return n // world


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_build_equals_whole_build(groups, world, name):
    """Every leaf, gathered, bit for bit equal to the whole build's; the
    fine level sharded to the rank's width; no rank holds a leaf whose whole
    is as wide as the fine level's element count (the fine level's
    operators, smoothers and rhs, and every CG level's)."""
    for rank, got in enumerate(tg.check(groups[world][name])):
        assert got["mismatches"] == [], (rank, got["mismatches"])
        assert got["flags"][0], "the fine level is sharded"
        assert got["fine_width"] == _fine_width(name, world, rank)
        assert got["whole_wide"] == [], (rank, got["whole_wide"])
        np.testing.assert_allclose(*got["norm_b"], rtol=1e-14)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", SOLVED)
def test_sharded_build_solves_as_the_whole_build(groups, world, name):
    """``_mixed_loop_ff`` on the sharded build: below 1e-10, the whole
    build's outer steps and V-cycles, its history to 1e-5 relative (the
    norms sum per rank), x within 1e-12 of max |x| of the whole build's."""
    got = tg.check(groups[world][name])[0]
    outer, cycles, rel = got["solve"]
    assert rel < 1e-10
    assert (outer, cycles) == got["whole"][:2]
    np.testing.assert_allclose(got["hist"], got["whole_hist"], rtol=1e-5)
    _, _, bw, _ = _port_whole(name)
    x = got["x_hi"].astype(np.float64) + got["x_lo"]
    assert x.shape == tuple(bw.hi.shape)


@functools.lru_cache(maxsize=None)
def _port_whole(name):
    spec, n, kw, _ = CASES[name]
    return build_xl_problem(HierarchySpec(**dict(spec)), n, device="cpu", **dict(kw))


@functools.lru_cache(maxsize=None)
def _jax_whole(name):
    spec, n, kw, _ = CASES[name]
    return jbuild_xl_problem(JHierarchySpec(**dict(spec)), n, **dict(kw))


def _pairs(want, got, path, out):
    """The JAX build's leaves (NumPy) beside the port's, by field name."""
    if isinstance(want, np.ndarray):
        out.append((path, want, got.numpy()))
    elif hasattr(want, "_fields"):
        for f in want._fields:
            _pairs(getattr(want, f), getattr(got, f), f"{path}.{f}", out)
    elif hasattr(want, "hi_mid"):  # the stencil fine operator, a dataclass
        for f in ("hi_left", "hi_mid", "hi_right", "lo_left", "lo_mid", "lo_right"):
            _pairs(getattr(want, f), getattr(got, f), f"{path}.{f}", out)
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _pairs(w, g, f"{path}[{i}]", out)
    else:
        assert want is None and got is None, path
    return out


def _hi_of(path):
    for lo, hi in ((".lo_", ".hi_"), (".lo.", ".hi."), (".lo", ".hi")):
        if lo in path:
            return path.replace(lo, hi)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_whole_build_matches_jax(name):
    """The build the sharded one equals (above), against the JAX package's
    build of the same arguments, leaf by leaf."""
    h, a_ff, b_ff, nb = _port_whole(name)
    jh, ja_ff, jb_ff, jnb = _jax_whole(name)
    if hasattr(a_ff, "a_ffs"):  # ff_levels: the per-level operators, what the sharded build returns
        a_ff, ja_ff = a_ff.a_ffs, ja_ff.a_ffs
    leaves = _pairs(jax.tree_util.tree_map(np.asarray, (jh, ja_ff, jb_ff)), (h, a_ff, b_ff), "", [])
    by_path = {p: (w, g) for p, w, g in leaves}
    assert len(leaves) > 30
    for path, want, got in leaves:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if want.size == 0:
            continue
        scale = float(np.abs(want).max())
        hi_path = _hi_of(path) if path.startswith("[1]") or path.startswith("[2]") else None
        if hi_path in by_path and hi_path != path:
            w_hi, g_hi = by_path[hi_path]
            w_val, g_val = w_hi.astype(np.float64) + want, g_hi.astype(np.float64) + got
            np.testing.assert_allclose(g_val, w_val, rtol=0, atol=FF_TOL * np.abs(w_val).max(), err_msg=path)
        elif path.endswith(("lam_lo", "lam_hi")):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
        elif want.dtype == np.float32:
            ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
            ok = (ulps <= 1) | (np.abs(got - want) <= F32_TOL * scale)
            assert ok.all(), (path, int((~ok).sum()))
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * scale, err_msg=path)
    np.testing.assert_allclose(nb, jnb, rtol=1e-10)


# (outer steps, V-cycles) the port's solve may lie from JAX's on the same
# inputs (G13): at c_dir = 1000 n the float32 inner cycle follows the rounding;
# the damped DG solve measures 10 / 28 against JAX's 7 / 30 (the port's whole
# build and JAX's, and the JAX build's inputs in the port, alike)
JAX_APART = {"dg": (3, 2), "cg": (2, 2), "slim": (2, 2)}


@pytest.mark.parametrize("name", SOLVED)
def test_sharded_solve_counts_near_jax(groups, name):
    """The JAX package's ``_mixed_loop_ff(use_pallas=False)`` on its own
    build against the port's on the same inputs (the JAX build converted)
    and the sharded solves (both worlds, on the port's build, whose counts
    equal its whole build's): within ``JAX_APART``."""
    from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy

    jh, ja_ff, jb_ff, jnb = _jax_whole(name)
    zero = jnp.zeros_like(jb_ff.hi)
    res = j_mixed_loop_ff(
        jh, ja_ff, JFF(zero, zero), jb_ff, jnp.asarray(1.0 / jnb, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20, n_pre=3, n_post=3, alpha=2.0 / 3.0,
        use_pallas=False,
    )
    want = int(res[1]), int(res[2])
    shared = xl_problem_from_numpy(*jax.tree_util.tree_map(np.asarray, (jh, ja_ff, jb_ff)), float(jnb), device="cpu")
    _, outer, cycles, _ = tg._solve_ff(*shared)
    runs = {"shared inputs": (outer, cycles)}
    runs.update({f"{w} ranks": tg.check(groups[w][name])[0]["solve"][:2] for w in WORLDS})
    d_outer, d_cycles = JAX_APART[name]
    for what, (o, c) in runs.items():
        assert abs(o - want[0]) <= d_outer and abs(c - want[1]) <= d_cycles, (what, (o, c), want)


def _fake_group(world=2):
    """A SolverGroup for the refusals, which come before any collective."""
    return SolverGroup(group=None, rank=0, world=world, device=torch.device("cpu"), backend="gloo")


# (spec, n, keywords, exception, message): slim_fine on a CG-topped chain; a
# ragged seam (42 CG elements of the stencil problem under 4:1 agglomeration);
# a coarsest level that is not block-tridiagonal (a CG-only chain)
REFUSALS = {
    "slim-cg": (CG_SPEC, 2048, (("slim_fine", True),), ValueError, "slim_fine requires a DG-topped chain"),
    "ragged-seam": ((("cg_orders", (2, 1)), ("n_agg_levels", 1), ("p_agg", 1), ("c_dir", 1e4)), 168,
                    (("z", 4),), ValueError, "shard-local build requires uniform seam partitions"),
    "cg-coarsest": ((("cg_orders", (2, 1)), ("n_agg_levels", 0), ("c_dir", 1e4)), 1024, (("z", 8),),
                    TypeError, "shard-local build needs a block-tridiagonal coarsest level"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sharded_build_refuses_what_jax_refuses(name):
    """The rank-local build's refusals, with the JAX package's build refusing the
    same input with the same message (on a 2-device mesh)."""
    from agglomerationmultigrid1d_tpu.parallel import make_solver_mesh
    from agglomerationmultigrid1d_tpu.parallel.multihost import build_sharded_xl_problem as jbuild_sharded

    spec, n, kw, exc, msg = REFUSALS[name]
    with pytest.raises(exc, match=msg):
        jbuild_sharded(JHierarchySpec(**dict(spec)), n, mesh=make_solver_mesh(2), **dict(kw))
    with pytest.raises(exc, match=msg):
        build_sharded_xl_problem(HierarchySpec(**dict(spec)), n, group=_fake_group(), **dict(kw))
