"""The rank-local stencil build ``parallel.multihost.build_sharded_xl_problem``
against the port's whole build and the JAX package's, on the CPU.

The model is ``tests/test_multihost.py:37-187`` (the JAX package's
per-process build on its 8-device virtual mesh).  Here one spawned gloo
group of 2 ranks, one of 3 and one of 4 (``torch_group.run_group``) build
these cases rank by rank, the first four on 2 and 4 ranks:

* ``dg``: DG p = 1, 4 agglomerated levels, c_dir = 1000 n, n = 4096, z = 8,
  no Chebyshev, ``min_blocks_per_device=128``;
* ``cg``: the CG-topped flagship spec (CG p = 8, 4, 2, 1, 3 agglomerated
  levels), n = 2048, ``min_blocks_per_device=8``;
* ``slim``: the ``dg`` problem with ``slim_fine=True`` and Chebyshev
  smoothing (the north star's configuration), ``min_blocks_per_device=8``;
* ``ff_levels``: the ``cg`` problem with ``ff_levels=True`` (every level's
  float-float operator);

and three whose agglomerates straddle the ranks (a coarse count the world
does not divide stays whole under a sharded level), each on one world:

* ``s3-dg``: DG p = 1, 3:1 then 2:1 agglomeration, 4 agglomerated levels,
  c_dir = 1000 n, n = 3072, z = 8, no Chebyshev, on 3 ranks: the fine level
  sharded, 1024 blocks whole (transfer 0 straddles);
* ``s3-cg``: CG p = 2, 1, then the same agglomeration in 3 levels, on 3
  ranks: both CG levels sharded, the seam onto 1024 blocks straddles;
* ``z1``: DG p = 1, 4:1 then 2:1, n = 2080 on 4 ranks with the default
  stencil factor, 1 (the coarsest count, 65, is odd): 2080, 520, 260
  sharded, 130 whole (transfer 2 straddles).  The whole build refuses
  ``z = 1``, as the JAX package's does.

Held, per rank:

* every leaf of ``(h_low, a_ff, b_ff)``, gathered over the ranks, equal bit
  for bit to the port's whole ``build_xl_problem`` of the same arguments,
  and ``norm_b`` to 1e-14 relative;
* each rank holds its ``n / W`` fine columns (``n p / W`` nodes, one more on
  the last rank) and no tensor of the global fine width;
* ``_mixed_loop_ff`` on the sharded build reaches < 1e-10 with the outer
  steps and V-cycles of the whole build's solve, its history equal to 1e-5
  relative, x within 1e-12 of the whole build's (relative to max |x|).

The rank-local build of every case with a whole build also equals, leaf
for leaf and bit for bit on each rank, ``shard_hierarchy`` of the whole
build (the cut transfers' column plans included); no rank of a straddled
case holds a leaf as wide as the fine level.

And once per case, in this process: the port's whole build against the
JAX package's ``build_xl_problem`` (float32 leaves within one ulp or 3e-7 of
their max, float-float pairs hi + lo within 1e-11 of their max, the
Chebyshev bounds within 1e-6, ``norm_b`` within 1e-10, the tolerances of
``tests/test_torch_stencil*.py``), and the sharded solve's counts within 2
outer steps / 2 V-cycles of JAX's ``_mixed_loop_ff(use_pallas=False)`` on
its own build and of the port's solve of that very build (G13: at c_dir =
1000 n the float32 inner cycle follows the rounding; 3 outer steps for the
damped DG case); the straddled cases' gathered leaves against the JAX
package's own rank-local build on as many virtual CPU devices (the same
tolerances; a straddled transfer of JAX's, whole, cut as the port cuts it)
and their counts against its solve; and the rank-local build's refusals,
JAX's.
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
from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy
from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_map

DG_SPEC = (("cg_orders", ()), ("dg_orders", (1,)), ("n_agg_levels", 4), ("p_agg", 1), ("c_dir", 1000.0 * 4096))
CG_SPEC = (("cg_orders", (8, 4, 2, 1)), ("n_agg_levels", 3), ("p_agg", 1), ("c_dir", 1000.0 * 2048))
S3_DG_SPEC = (("cg_orders", ()), ("dg_orders", (1,)), ("n_agg_levels", 4), ("p_agg", 1), ("first_agg_factor", 3),
              ("agg_factor", 2), ("c_dir", 1000.0 * 3072))
S3_CG_SPEC = (("cg_orders", (2, 1)), ("n_agg_levels", 3), ("p_agg", 1), ("first_agg_factor", 3), ("agg_factor", 2),
              ("c_dir", 1000.0 * 3072))
Z1_SPEC = (("cg_orders", ()), ("dg_orders", (1,)), ("n_agg_levels", 4), ("p_agg", 1), ("first_agg_factor", 4),
           ("agg_factor", 2), ("c_dir", 1000.0 * 2080))
CASES = {  # name: (spec, n, build keywords, min_blocks_per_device, worlds)
    "dg": (DG_SPEC, 4096, (("z", 8), ("chebyshev", False)), 128, (2, 4)),
    "cg": (CG_SPEC, 2048, (("chebyshev", False),), 8, (2, 4)),
    "slim": (DG_SPEC, 4096, (("z", 8), ("chebyshev", True), ("slim_fine", True)), 8, (2, 4)),
    "ff_levels": (CG_SPEC, 2048, (("chebyshev", False), ("ff_levels", True)), 8, (2, 4)),
    "s3-dg": (S3_DG_SPEC, 3072, (("z", 8), ("chebyshev", False)), 8, (3,)),
    "s3-cg": (S3_CG_SPEC, 3072, (("z", 8), ("chebyshev", False)), 8, (3,)),
    "z1": (Z1_SPEC, 2080, (("chebyshev", False),), 8, (4,)),
}
STRADDLED = {"s3-dg": 0, "s3-cg": 1, "z1": 2}  # name: the transfer whose agglomerates straddle the ranks
WHOLE = [name for name in CASES if name != "z1"]  # the cases with a whole build (z >= 2)
SOLVED = ("dg", "cg", "slim")
WORLDS = (2, 3, 4)
RUNS = [(name, world) for name, case in CASES.items() for world in case[4]]
F32_TOL = 3e-7  # of a float32 leaf's max, beside one ulp: tests/test_torch_stencil_cg.py
FF_TOL = 1e-11  # hi + lo of a float-float leaf, of its max


@functools.lru_cache(maxsize=None)
def _jax_sharded(name):
    """The JAX package's rank-local build of a straddled case on as many
    virtual CPU devices as the case's ranks: its bundle, and the port's copy
    of it on the CPU with the CG levels' node padding cut off."""
    from agglomerationmultigrid1d_tpu.parallel.multihost import build_sharded_xl_problem as jbuild_sharded
    from agglomerationmultigrid1d_tpu.parallel.multihost import multihost_mesh

    spec, n, kw, min_blocks, (world,) = CASES[name]
    out = jbuild_sharded(JHierarchySpec(**dict(spec)), n, mesh=multihost_mesh(jax.devices()[:world]),
                         min_blocks_per_device=min_blocks, **dict(kw))
    h, a_ff, b_ff, norm_b = xl_problem_from_numpy(*jax.tree_util.tree_map(np.asarray, out[:3]), float(out[3]),
                                                  device="cpu")
    # a sharded CG level's node axis is padded to a device multiple (an inert identity tail)
    pads = {lv.a.band.shape[-1]: lv.a.n_el * lv.a.p + 1 for lv in h.levels if hasattr(lv.a, "band")}
    crop = tree_map(lambda t: t[..., : pads.get(t.shape[-1], t.shape[-1])] if t.dim() else t, (h, a_ff, b_ff))
    return out, crop + (norm_b,)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {}
    for world in WORLDS:
        jobs = [(name, tg.job_sharded_xl, (case[:4], _jax_sharded(name)[1][:3] if name in STRADDLED else None))
                for name, case in CASES.items() if world in case[4]]
        store = tmp_path_factory.mktemp(f"gloo{world}") / "store"
        out[world] = tg.run_group(jobs, world, str(store), timeout_s=240)
    return out


def _fine_width(name, world, rank):
    spec, n = dict(CASES[name][0]), CASES[name][1]
    if spec["cg_orders"]:
        return n * spec["cg_orders"][0] // world + (rank == world - 1)
    return n // world


@pytest.mark.parametrize("name,world", [run for run in RUNS if run[0] in WHOLE])
def test_sharded_build_equals_whole_build(groups, world, name):
    """Every leaf, gathered, bit for bit equal to the whole build's (a
    straddled transfer's, cut, is held by the next test); the fine level
    sharded to the rank's width; no rank holds a leaf whose whole is as wide
    as the fine level's element count (the fine level's operators, smoothers
    and rhs, and every CG level's)."""
    for rank, got in enumerate(tg.check(groups[world][name])):
        assert got["mismatches"] == [], (rank, got["mismatches"])
        assert got["flags"][0], "the fine level is sharded"
        assert got["fine_width"] == _fine_width(name, world, rank)
        assert got["whole_wide"] == [], (rank, got["whole_wide"])
        np.testing.assert_allclose(got["norm_b"], got["whole_norm_b"], rtol=1e-14)


@pytest.mark.parametrize("name,world", [run for run in RUNS if run[0] in WHOLE])
def test_sharded_build_equals_shard_hierarchy(groups, world, name):
    """On every rank, every leaf of the rank-local ``h_low`` bit for bit
    equal to ``shard_hierarchy`` of the whole build with the same
    ``min_blocks_per_device``: the sharded levels' columns, the whole levels,
    and a straddled transfer's rank part with its column plans, which the
    rank-local build derives from the level counts alone."""
    for rank, got in enumerate(tg.check(groups[world][name])):
        assert got["layout_mismatches"] == [], (rank, got["layout_mismatches"])
        assert (got["cut"] == [STRADDLED[name]]) if name in STRADDLED else not got["cut"], got["cut"]


@pytest.mark.parametrize("name", list(STRADDLED))
def test_straddled_build_holds_no_fine_width_leaf(groups, name):
    """Each rank holds its part of the fine level and no leaf as wide as the
    fine level's element count; the straddled transfer, and it alone, is cut
    to the rank's part; its coarse level is whole."""
    _, n, _, _, (world,) = CASES[name]
    for rank, got in enumerate(tg.check(groups[world][name])):
        k = STRADDLED[name]
        assert got["cut"] == [k] and got["flags"][k] and not got["flags"][k + 1], (got["cut"], got["flags"])
        assert got["fine_width"] == _fine_width(name, world, rank)
        assert got["widest"] < n, (rank, got["widest"])


@pytest.mark.parametrize("name,world", [run for run in RUNS if run[0] in SOLVED + ("s3-dg", "s3-cg")])
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
    spec, n, kw, _, _ = CASES[name]
    return build_xl_problem(HierarchySpec(**dict(spec)), n, device="cpu", **dict(kw))


@functools.lru_cache(maxsize=None)
def _jax_whole(name):
    spec, n, kw, _, _ = CASES[name]
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


def _hold_leaves(leaves, ff_roots):
    """``(path, want, got)`` NumPy leaves within the file's tolerances: a
    float-float lo leaf under one of ``ff_roots`` as hi + lo within FF_TOL
    of its max, the Chebyshev bounds within 1e-6, float32 within one ulp or
    F32_TOL of the leaf's max, float64 within 1e-13 of it, integers equal."""
    by_path = {p: (w, g) for p, w, g in leaves}
    for path, want, got in leaves:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if want.size == 0:
            continue
        scale = float(np.abs(want).max())
        hi_path = _hi_of(path) if path.startswith(ff_roots) else None
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
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", WHOLE)
def test_whole_build_matches_jax(name):
    """The build the sharded one equals (above), against the JAX package's
    build of the same arguments, leaf by leaf."""
    h, a_ff, b_ff, nb = _port_whole(name)
    jh, ja_ff, jb_ff, jnb = _jax_whole(name)
    if hasattr(a_ff, "a_ffs"):  # ff_levels: the per-level operators, what the sharded build returns
        a_ff, ja_ff = a_ff.a_ffs, ja_ff.a_ffs
    leaves = _pairs(jax.tree_util.tree_map(np.asarray, (jh, ja_ff, jb_ff)), (h, a_ff, b_ff), "", [])
    assert len(leaves) > 30
    _hold_leaves(leaves, ("[1]", "[2]"))
    np.testing.assert_allclose(nb, jnb, rtol=1e-10)


@pytest.mark.parametrize("name", list(STRADDLED))
def test_straddled_build_matches_jax_sharded_build(groups, name):
    """The rank-local build's leaves, gathered, against the JAX package's
    rank-local build of the same arguments (its global arrays) at the
    tolerances above, and ``norm_b`` within 1e-10; the straddled transfer,
    which the JAX build keeps whole and its partitioner moves, cut by
    ``parallel.transfers.shard_transfer`` on every rank and held to the
    rank's part (its index tensors equal)."""
    _, n, _, _, (world,) = CASES[name]
    (_, _, _, jnb), _ = _jax_sharded(name)
    ranks = tg.check(groups[world][name])
    ref = {p: w for p, w in tg.tensor_leaves(_uncut_ref(name))}
    leaves = [(p, ref[p].numpy(), got) for p, got in ranks[0]["jax_leaves"]]
    assert len(leaves) > 20 and len(leaves) == len(ref)
    _hold_leaves(leaves, ("[3]", "[4]"))
    for got in ranks:
        np.testing.assert_allclose(got["norm_b"], jnb, rtol=1e-10)
        (k, cut), = got["jax_cut"].items()
        assert k == STRADDLED[name] and len(cut) >= 8
        _hold_leaves([(p, want, mine) for p, mine, want in cut], ())


def _uncut_ref(name):
    """The port's copy of the JAX sharded build as ``(levels, transfers,
    coarse, a_ff, b_ff)``, its straddled transfer left out, as the job's."""
    h, a_ff, b_ff, _ = _jax_sharded(name)[1]
    return tg._uncut((h.levels, h.transfers, h.coarse, a_ff, b_ff), [STRADDLED[name]])


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
    jh, ja_ff, jb_ff, jnb = _jax_whole(name)
    want = _jax_counts(jh, ja_ff, jb_ff, jnb)
    shared = xl_problem_from_numpy(*jax.tree_util.tree_map(np.asarray, (jh, ja_ff, jb_ff)), float(jnb), device="cpu")
    _, outer, cycles, _ = tg._solve_ff(*shared)
    runs = {"shared inputs": (outer, cycles)}
    runs.update({f"{w} ranks": tg.check(groups[w][name])[0]["solve"][:2] for w in CASES[name][4]})
    d_outer, d_cycles = JAX_APART[name]
    for what, (o, c) in runs.items():
        assert abs(o - want[0]) <= d_outer and abs(c - want[1]) <= d_cycles, (what, (o, c), want)


def _jax_counts(jh, ja_ff, jb_ff, jnb) -> tuple:
    """(outer steps, V-cycles) of the JAX package's ``_mixed_loop_ff(use_pallas=False)``."""
    zero = jnp.zeros_like(jb_ff.hi)
    res = j_mixed_loop_ff(
        jh, ja_ff, JFF(zero, zero), jb_ff, jnp.asarray(1.0 / jnb, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20, n_pre=3, n_post=3, alpha=2.0 / 3.0,
        use_pallas=False,
    )
    return int(res[1]), int(res[2])


# the same, against the JAX package's rank-local build and its solve on as
# many virtual devices.  The damped DG cases are G13's again: the port's
# rank-local solve takes the counts of its own solve of the JAX build's
# inputs (8 / 20 on s3-dg, 8 / 29 on z1), so the sharding moves nothing;
# JAX's A-form CPU path takes 4 / 20 and 5 / 31; on s3-dg JAX's own M-form
# path (its Pallas kernels in interpret mode, as on its accelerator) lies
# on the port's side (held below): the count follows the float32 inner
# cycle's form
JAX_SHARDED_APART = {"s3-dg": (4, 2), "s3-cg": (1, 2), "z1": (3, 2)}
MFORM_APART = (1, 3)  # the port's counts from JAX's M-form loop on s3-dg's whole build


@pytest.mark.parametrize("name", list(STRADDLED))
def test_straddled_solve_counts_near_jax_sharded_build(groups, name, monkeypatch):
    """``_mixed_loop_ff`` on the rank-local build: below 1e-10 on every rank,
    every rank with the counts of the port's solve of the JAX rank-local
    build's inputs (whole, in this process), both within
    ``JAX_SHARDED_APART`` of the JAX package's solve of its own rank-local
    build, computed here; on s3-dg also within ``MFORM_APART`` of JAX's
    M-form loop on its whole build."""
    _, _, _, _, (world,) = CASES[name]
    out, port = _jax_sharded(name)
    want = _jax_counts(*out)
    _, outer, cycles, _ = tg._solve_ff(*port)
    runs = {"the JAX build's inputs": (outer, cycles)}
    for rank, got in enumerate(tg.check(groups[world][name])):
        assert got["solve"][2] < 1e-10, (rank, got["solve"])
        assert got["solve"][:2] == (outer, cycles), (rank, got["solve"], (outer, cycles))
        runs[f"rank {rank}"] = got["solve"][:2]
    d_outer, d_cycles = JAX_SHARDED_APART[name]
    for what, (o, c) in runs.items():
        assert abs(o - want[0]) <= d_outer and abs(c - want[1]) <= d_cycles, (what, (o, c), want)
    if name == "s3-dg":
        m_outer, m_cycles = _jax_mform_counts(_jax_whole(name), monkeypatch)
        assert abs(outer - m_outer) <= MFORM_APART[0] and abs(cycles - m_cycles) <= MFORM_APART[1], \
            ((outer, cycles), (m_outer, m_cycles))


def _jax_mform_counts(j, monkeypatch) -> tuple:
    """``_jax_counts`` with the JAX package's Pallas (M-form) smoothing, its
    kernels in interpret mode on the CPU, cut to 128-column tiles so that
    every level of two tiles or more takes them
    (``tests/test_torch_handover.py:_jax_mform_loop``)."""
    import agglomerationmultigrid1d_tpu.ops.pallas as jpallas
    from agglomerationmultigrid1d_tpu.ops.pallas import block_kernels as jblock_kernels

    def interpreted(kernel):
        return lambda *args, **kw: kernel(*args, interpret=True, **kw)

    for name in ("pallas_block_jacobi_multisweep", "pallas_block_jacobi_multisweep_residual",
                 "pallas_chebyshev_multisweep", "pallas_bt_matvec"):
        monkeypatch.setattr(jpallas, name, interpreted(getattr(jpallas, name)))
    monkeypatch.setattr(jblock_kernels, "_pick_tile",
                        functools.partial(jblock_kernels._pick_tile, vmem_budget=128 * (4 * 2 * 2 + 5 * 2) * 4 * 2))
    jh, ja_ff, jb_ff, jnb = j
    zero = jnp.zeros_like(jb_ff.hi)
    res = j_mixed_loop_ff(
        jh, ja_ff, JFF(zero, zero), jb_ff, jnp.asarray(1.0 / jnb, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20, n_pre=3, n_post=3, alpha=2.0 / 3.0,
        use_pallas=True,
    )
    return int(res[1]), int(res[2])


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


# (spec, n, z, world, message): ragged agglomerates of the stencil problem
# (1,006 or 1,010 elements under 4:1).  n = 8,048 makes levels of 8,048,
# 2,008 and 1,000 blocks: on 3 ranks none is sharded, on 2 every level lines
# up with the ranks; n = 8,080 makes 8,080, 2,016 and 1,008: on 3 ranks 2,016
# is sharded below the whole 8,080, the layout only ragged agglomerates make
RAGGED_SPEC = (("cg_orders", ()), ("dg_orders", (1,)), ("n_agg_levels", 2), ("p_agg", 1), ("first_agg_factor", 4),
               ("agg_factor", 2), ("c_dir", 1000.0 * 8048))
RAGGED_REFUSALS = {
    "whole": (RAGGED_SPEC, 8048, 8, 3, "shard-local build requires uniform agglomerates"),
    "below-whole": (RAGGED_SPEC, 8080, 8, 3, "would be sharded below the whole level 0"),
    "aligned": (RAGGED_SPEC, 8048, 8, 2, "shard-local build requires uniform agglomerates"),
}


@pytest.mark.parametrize("name", list(RAGGED_REFUSALS))
def test_ragged_transfers_refused_by_both_rank_local_builds(name):
    """Ragged agglomerates in the rank-local build: the JAX package's raises
    ``AssertionError`` (its ``parallel/multihost.py:427`` asserts that each
    transfer is a ``BlockProlong``, whatever the levels' flags), the port's a
    ``ValueError`` that names the layout: so the two refuse with different
    exceptions, and this case is held apart from ``REFUSALS``."""
    from agglomerationmultigrid1d_tpu.parallel.multihost import build_sharded_xl_problem as jbuild_sharded
    from agglomerationmultigrid1d_tpu.parallel.multihost import multihost_mesh

    spec, n, z, world, msg = RAGGED_REFUSALS[name]
    with pytest.raises(AssertionError):
        jbuild_sharded(JHierarchySpec(**dict(spec)), n, mesh=multihost_mesh(jax.devices()[:world]), z=z,
                       min_blocks_per_device=8)
    with pytest.raises(ValueError, match=msg):
        build_sharded_xl_problem(HierarchySpec(**dict(spec)), n, group=_fake_group(world), z=z,
                                 min_blocks_per_device=8)


def test_whole_build_refuses_z1():
    """The whole build refuses the stencil factor 1 that the rank-local
    build takes (``z1``'s default), with the JAX package's message."""
    spec, n, kw, _, _ = CASES["z1"]
    msg = "stencil factor z=1 must be >= 2"
    with pytest.raises(ValueError, match=msg):
        jbuild_xl_problem(JHierarchySpec(**dict(spec)), n, **dict(kw))
    with pytest.raises(ValueError, match=msg):
        build_xl_problem(HierarchySpec(**dict(spec)), n, device="cpu", **dict(kw))
