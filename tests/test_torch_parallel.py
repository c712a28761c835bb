"""The torch port's element-sharded solve (``parallel/``) against the JAX
package's on the CPU.

The JAX package runs on its virtual CPU mesh, cut to 4 devices; the port runs
one spawned 4-rank gloo group per module (``torch_group.run_group``, a
``FileStore`` under ``tmp_path`` and a time limit):

* ``halo_shift`` for d in {1, -1, 2} against the global shift, exactly;
* float64 ``multigrid`` on ``poisson_dg_hierarchy(n=128, max_p=4, n_dg=3)``
  sharded (``tests/test_distributed.py:41-55``): equal iterations; histories
  to rtol 1e-10 of the unsharded port's, and of JAX's sharded solve above the
  two packages' float64 floor;
* ``multigrid_mixed`` / ``multigrid_progressive`` on sharded hierarchies
  (``tests/test_distributed.py:102-139``, JAX with ``shard=``): within one
  outer step of JAX's sharded solves, x within 1e-9 ||b||;
* the same mixed solve with Chebyshev smoothing (one Chebyshev hierarchy
  handed to both packages), on the sharded smoother's schedule of packing,
  exchange, full-shard pass and one edge pair: the same bounds;
* K7's operator ghosts, exchanged once when a float32 level is sharded:
  exactly the neighbours' edge columns, and with them the level's edge plan;
* two smoothings in a row on one level through one edge plan, whose messages
  are reused, against plans built anew: exactly equal;

and in this process (no communication): ``shard_hierarchy``'s flags and local
sizes against JAX's, a CG-topped hierarchy's sharded layout, the shards of
the layouts ROADMAP item 15 (d) once refused, what it refuses, the
``initialize`` checks, and the entry points' default device (the card).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_group as tg
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models.hierarchy import chebyshev_hierarchy as jchebyshev_hierarchy
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.parallel import fused_shard_spec as jfused_shard_spec
from agglomerationmultigrid1d_tpu.parallel import make_solver_mesh
from agglomerationmultigrid1d_tpu.parallel import shard_hierarchy as jshard_hierarchy
from agglomerationmultigrid1d_tpu.parallel.distributed import shard_vector as jshard_vector
from agglomerationmultigrid1d_tpu_torch import models, parallel
from agglomerationmultigrid1d_tpu_torch.models import (
    chebyshev_hierarchy,
    multigrid,
    multigrid_true,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.ops.shifts import shift
from agglomerationmultigrid1d_tpu_torch.models.solvers import make_low_precision_hierarchy
from agglomerationmultigrid1d_tpu_torch.parallel import (
    SolverGroup,
    distributed_multigrid,
    initialize,
    shard_hierarchy,
    shard_vector,
)
from agglomerationmultigrid1d_tpu_torch.parallel.sharded_kernels import GHOST_W
from agglomerationmultigrid1d_tpu_torch.utils import convert
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

WORLD = 4
DG = dict(n=128, max_p=4, n_dg=3)
MIN_BLOCKS = 4


def _fake_group(rank=0, world=WORLD):
    """A SolverGroup for what needs no communication (shard_hierarchy's slicing)."""
    return SolverGroup(group=None, rank=rank, world=world, device=torch.device("cpu"), backend="gloo")


def _problem():
    jprob = jproblems.poisson_dg_hierarchy(**DG)
    h = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy), device="cpu")
    return jprob, h, np.array(jprob.b)


def _jax_sharded():
    jprob, _, _ = _problem()
    mesh = make_solver_mesh(WORLD)
    jh = jshard_hierarchy(jprob.hierarchy, mesh, min_blocks_per_device=MIN_BLOCKS)
    return jprob, mesh, jh, jshard_vector(jprob.b, mesh)


HALO_X = np.arange(64, dtype=np.float64).reshape(2, 32)
REUSE_CHEB = (0.2, 2.0)  # the Chebyshev interval of the plan-reuse job


def _cheb_problem():
    """The problem under JAX's ``chebyshev_hierarchy``, and that very
    hierarchy (its lambdas) converted for the port."""
    jprob = jproblems.poisson_dg_hierarchy(**DG)
    jh = jchebyshev_hierarchy(jprob.hierarchy)
    return jprob, jh, hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jh), device="cpu")


def _reuse_system(dtype=np.float32):
    """A diagonally dominant block-tridiagonal system over 4 x 24 columns
    and two different x."""
    rng = np.random.default_rng(11)
    bs, n = 2, WORLD * 24
    l, u = 0.3 * rng.standard_normal((bs, bs, n)), 0.3 * rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 6 * np.eye(bs)[:, :, None]
    inv = np.linalg.inv(np.moveaxis(d, -1, 0)).transpose(1, 2, 0)
    a = tuple(np.ascontiguousarray(m, dtype=dtype) for m in (l, d, u))
    xs = [rng.standard_normal((bs, n)).astype(dtype) for _ in range(2)]
    return a, np.ascontiguousarray(inv, dtype=dtype), xs, rng.standard_normal((bs, n)).astype(dtype)


REUSE_CASES = {
    "damped-residual": ("damped", dict(n_sweeps=3, alpha=2.0 / 3.0, emit_residual=True)),
    "cheb": ("cheb", dict(coef=bk.chebyshev_coefficients(*REUSE_CHEB, 3), degree=3)),
}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    _, h, b = _problem()
    jobs = [(f"halo{d}", tg.job_halo_shift, (HALO_X, d)) for d in (1, -1, 2)]
    jobs.append(("multigrid", tg.job_multigrid, (h, b, MIN_BLOCKS)))
    jobs += [(s, tg.job_low_precision, (h, b, MIN_BLOCKS, s)) for s in ("mixed", "progressive")]
    jobs.append(("op_ghosts", tg.job_operator_ghosts, (h, MIN_BLOCKS)))
    jobs.append(("mixed_cheb", tg.job_low_precision, (_cheb_problem()[2], b, MIN_BLOCKS, "mixed")))
    a, inv, xs, rhs = _reuse_system()
    jobs += [(f"reuse-{name}", tg.job_plan_reuse, (a, inv, xs, rhs, kind, kw)) for name, (kind, kw) in REUSE_CASES.items()]
    store = tmp_path_factory.mktemp("gloo") / "store"
    return tg.run_group(jobs, WORLD, str(store), timeout_s=180)


@pytest.mark.parametrize("d", [1, -1, 2])
def test_halo_shift_matches_global(group, d):
    got = np.concatenate(tg.check(group[f"halo{d}"]), axis=-1)
    np.testing.assert_array_equal(got, shift(torch.from_numpy(HALO_X), d).numpy())


def test_sharded_multigrid_matches_jax(group):
    """Equal iterations; histories to rtol 1e-10 of the unsharded port's (the
    sharding alone: x is the same, the norms sum per rank) and of JAX's
    sharded solve above the packages' float64 floor (the unsharded solves
    differ by 7e-13 of the first residual and 3.9e-12 of the first error on
    this problem)."""
    jprob, mesh, jh, jb = _jax_sharded()
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, 50, 1e-10)
    _, h, b = _problem()
    ref = multigrid(h, torch.zeros_like(torch.from_numpy(b)), torch.from_numpy(b), 50, 1e-10)
    got = tg.check(group["multigrid"])[0]
    it = int(jres.iterations)
    assert got["iterations"] == ref.iterations == it
    assert np.isnan(got["res"][it:]).all()
    for key, port, jax_h, floor in (
        ("res", ref.res_history, jres.res_history, 1e-12),
        ("err", ref.err_history, jres.err_history, 1e-11),
    ):
        np.testing.assert_allclose(got[key][:it], port.numpy()[:it], rtol=1e-10)
        want = np.asarray(jax_h)[:it]
        np.testing.assert_allclose(got[key][:it], want, rtol=1e-10, atol=floor * want[0])
    np.testing.assert_allclose(got["x"], np.asarray(jres.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("solver", ["mixed", "progressive"])
def test_sharded_low_precision_solves_match_jax(group, solver):
    """Float32 inner cycles on sharded levels: the port's M-form sweeps (K7's
    schedule, through the kernels' plain versions) against JAX's A-form
    sweeps (``shard=`` with ``use_pallas=False``), so the float32 rounding
    differs: one outer step either way."""
    jprob, mesh, jh, jb = _jax_sharded()
    jh32 = jshard_hierarchy(
        jsolvers.make_low_precision_hierarchy(jprob.hierarchy), mesh, min_blocks_per_device=MIN_BLOCKS
    )
    fn = jsolvers.multigrid_mixed if solver == "mixed" else jsolvers.multigrid_progressive
    jres = fn(jh, jh32, jnp.zeros_like(jb), jb, 60, 1e-10, use_pallas=False, shard=jfused_shard_spec(jh32, mesh))
    got = tg.check(group[solver])[0]
    nb = float(np.linalg.norm(np.asarray(jprob.b)))
    it, j_it = got["iterations"], int(jres.iterations)
    assert got["res"][it - 1] < 1e-10 * nb
    assert abs(it - j_it) <= 1, (it, j_it)
    np.testing.assert_allclose(got["x"], np.asarray(jres.x), rtol=0, atol=1e-9 * nb)


def test_sharded_chebyshev_solve_matches_jax(group):
    """``multigrid_mixed`` with Chebyshev smoothing on sharded hierarchies:
    the port's K5 / edge-pair schedule (plain versions) against JAX's sharded
    solve of the same Chebyshev hierarchy (``shard=``, ``use_pallas=False``)
    on its 4-device mesh: one outer step either way, x within 1e-9 ||b||, as
    the damped solves above; and the port's own unsharded solve: equal
    counts, x within 1e-9 ||b||."""
    jprob, jh_whole, h = _cheb_problem()
    mesh = make_solver_mesh(WORLD)
    jh = jshard_hierarchy(jh_whole, mesh, min_blocks_per_device=MIN_BLOCKS)
    jh32 = jshard_hierarchy(
        jsolvers.make_low_precision_hierarchy(jh_whole), mesh, min_blocks_per_device=MIN_BLOCKS
    )
    jb = jshard_vector(jprob.b, mesh)
    jres = jsolvers.multigrid_mixed(
        jh, jh32, jnp.zeros_like(jb), jb, 60, 1e-10, use_pallas=False, shard=jfused_shard_spec(jh32, mesh)
    )
    got = tg.check(group["mixed_cheb"])[0]
    b = torch.from_numpy(np.array(jprob.b))
    nb = float(torch.linalg.vector_norm(b))
    it, j_it = got["iterations"], int(jres.iterations)
    assert got["res"][it - 1] < 1e-10 * nb
    assert abs(it - j_it) <= 1, (it, j_it)
    np.testing.assert_allclose(got["x"], np.asarray(jres.x), rtol=0, atol=1e-9 * nb)
    ref = models.multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 60, 1e-10)
    assert (it, got["inner"]) == (ref.iterations, ref.inner_cycles)
    np.testing.assert_allclose(got["x"], ref.x.numpy(), rtol=0, atol=1e-9 * nb)


@pytest.mark.parametrize("name", list(REUSE_CASES))
def test_edge_plan_reuse_equals_fresh_buffers(group, name):
    """Two smoothings in a row on one level with different x: the plan's
    messages are rewritten by the second while nothing of the first may
    still read them.  Every rank's results equal those of plans (and so
    buffers) made anew for each call, exactly; and the two calls differ, so
    the second did not see the first's ghosts."""
    for reused, fresh in tg.check(group[f"reuse-{name}"]):
        for got, want in zip(reused, fresh):
            for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g_, w_)
        first, second = (r if isinstance(r, np.ndarray) else r[0] for r in reused)
        assert not np.array_equal(first, second)


def test_shard_hierarchy_flags_and_local_sizes():
    """The port's sharded levels (``layout.sharded``) are the ones JAX's
    ``fused_shard_spec`` flags, and each rank holds n / world columns of them
    (the coarsest level and the transfer onto it whole); a float64 level
    carries no operator ghosts."""
    jprob, mesh, jh, _ = _jax_sharded()
    _, h, b = _problem()
    want = jfused_shard_spec(jh, mesh)[2]
    for rank in range(WORLD):
        g = _fake_group(rank)
        hs = shard_hierarchy(h, g, min_blocks_per_device=MIN_BLOCKS)
        assert hs.layout.sharded == want and hs.layout.group is g
        for lv, full, sh in zip(hs.levels, h.levels, want):
            assert lv.smoother.ghosts is None
            n = full.a.n_blocks
            lo = rank * n // WORLD if sh else 0
            assert lv.a.n_blocks == (n // WORLD if sh else n)
            assert torch.equal(lv.a.diag, full.a.diag[..., lo : lo + lv.a.n_blocks])
            assert torch.equal(lv.smoother.inv, full.smoother.inv[..., lo : lo + lv.a.n_blocks])
        for k, (t, full) in enumerate(zip(hs.transfers, h.transfers)):
            assert t.n_coarse == (full.n_coarse // WORLD if want[k + 1] else full.n_coarse)
        x = shard_vector(torch.from_numpy(b), g)
        assert torch.equal(x, torch.from_numpy(b)[:, rank * 32 : (rank + 1) * 32])


def test_shard_hierarchy_refuses_what_it_cannot_shard():
    """A CG-topped hierarchy shards (its CG levels by element, each rank
    owning its elements' first nodes, the last rank also the last node), and
    so does a chain whose agglomerates straddle two ranks (24 -> 6 -> 3
    blocks on two: the 2:1 groups of the sharded 6 over the whole 3, each
    coarse column restricted by the rank of its group's first fine column,
    which reads the rest of the group from its neighbour); what stays
    refused: a second sharding, and Chebyshev bounds or the TRUE-precision
    solver on a sharded hierarchy."""
    from agglomerationmultigrid1d_tpu_torch.parallel.transfers import ShardBlock

    g = _fake_group()
    full = poisson_full_hierarchy(n=64, device="cpu").hierarchy
    hs = shard_hierarchy(full, g, min_blocks_per_device=2)
    assert hs.layout.sharded[:4] == (True,) * 4  # the four CG levels (p = 8, 4, 2, 1)
    for lv, whole in zip(hs.levels[:4], full.levels[:4]):
        p = whole.a.p
        assert lv.a.n_el == 64 // WORLD and lv.a.band.shape[-1] == 64 // WORLD * p
        assert torch.equal(lv.a.band, whole.a.band[:, : 64 // WORLD * p])
    h = poisson_dg_hierarchy(n=24, max_p=1, n_dg=1, n_agg=2, device="cpu").hierarchy  # 24 -> 6 -> 3 blocks
    for rank, mine, fine_need in ((0, [0, 1], [0, 1, 2, 3]), (1, [2], [4, 5])):
        hs = shard_hierarchy(h, _fake_group(rank=rank, world=2), min_blocks_per_device=1)
        assert hs.layout.sharded == (True, True, False)
        t = hs.transfers[1]
        assert isinstance(t, ShardBlock) and t.uniform and t.rplan.whole and t.rplan.n_local == 3
        assert t.rplan.need.tolist() == mine and t.fplan.need.tolist() == fine_need
        assert t.cplan.whole and t.cplan.need.tolist() == ([0, 1] if rank == 0 else [1, 2])
    _, h, _ = _problem()
    hs = shard_hierarchy(h, g, min_blocks_per_device=MIN_BLOCKS)
    with pytest.raises(ValueError, match="already sharded"):
        shard_hierarchy(hs, g)
    with pytest.raises(ValueError, match="unsharded"):
        chebyshev_hierarchy(hs)
    with pytest.raises(ValueError, match="unsharded.*item 15"):
        multigrid_true(hs, None, None, 1.0)


def _refused_chain(kind):
    from agglomerationmultigrid1d_tpu_torch.models import build_problem, poisson_scattered_hierarchy
    from agglomerationmultigrid1d_tpu_torch.models import poisson_switch_hierarchy
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    if kind == "penta":
        return poisson_switch_hierarchy(n=64, n_coarsen=1, device="cpu").hierarchy
    if kind == "block-coo":
        return poisson_scattered_hierarchy(n=64, device="cpu").hierarchy
    # 42 CG elements under 4:1 agglomeration: a ragged seam (SeamProlong.offsets)
    spec = HierarchySpec(cg_orders=(2, 1), n_agg_levels=1, p_agg=1, c_dir=1e4)
    return build_problem(spec, 42, device="cpu").hierarchy


@pytest.mark.parametrize("kind,what", [
    ("penta", r"holds a BlockPenta"), ("block-coo", r"(holds a BlockCOO|is a ScatteredProlong)"), ("ragged-seam", r"ragged seam"),
])
def test_shard_hierarchy_refuses_the_layouts_of_item_15d(kind, what):
    """The layouts ROADMAP item 15 (d) once refused now shard, on a fake
    two-rank group (no collective: every plan is built from the whole
    hierarchy): a block-pentadiagonal level holds its columns of all five
    streams; a block-COO level its block rows, numbered from 0, whose
    columns (global ones in its plan's ``need``) give the whole operator's
    rows of the rank on the gathered vector; a ragged seam under a sharded
    CG level (42 elements over a whole coarsest level of 11 agglomerates)
    the coarse columns of the rank's elements, their windows and its nodes'
    lumped mass."""
    from agglomerationmultigrid1d_tpu_torch.ops import bcoo_matvec
    from agglomerationmultigrid1d_tpu_torch.parallel.transfers import ShardScattered

    h = _refused_chain(kind)
    rng = np.random.default_rng(3)
    for rank in range(2):
        hs = shard_hierarchy(h, _fake_group(rank=rank, world=2), min_blocks_per_device=1)
        for k, (lv, whole, sh) in enumerate(zip(hs.levels, h.levels, hs.layout.sharded)):
            if not sh or kind == "ragged-seam":
                continue
            n = whole.a.n_blocks
            lo, hi = rank * n // 2, (rank + 1) * n // 2
            if kind == "penta":
                assert all(torch.equal(t, w[..., lo:hi]) for t, w in zip(lv.a, whole.a))
                continue
            if k == 0:
                continue
            a, x = lv.a, torch.from_numpy(rng.standard_normal((whole.a.block_size, n)))
            assert a.n_rows == hi - lo and a.halo.n_local == hi - lo and not a.halo.whole
            assert a.rows.dtype == a.cols.dtype == a.halo.need.dtype == torch.int64
            assert torch.equal(bcoo_matvec(a, x[:, a.halo.need]), bcoo_matvec(whole.a, x)[:, lo:hi])
        if kind == "ragged-seam":
            assert hs.layout.sharded == (True, True, False)
            t, w = hs.transfers[1], h.transfers[1]
            assert isinstance(t, ShardScattered) and t.plan.whole and w.offsets is not None
            owners = torch.searchsorted(w.offsets.long(), torch.arange(rank * 21, (rank + 1) * 21), right=True) - 1
            assert t.plan.need.tolist() == sorted(set(owners.tolist()))
            assert t.p.blocks.shape == (w.w_cg, w.bs_coarse, 21)
            n_lo = rank * 21 * 1
            assert torch.equal(t.inv_lump, w.inv_lump[n_lo : n_lo + 21 + rank])


def test_unsharded_hierarchies_have_no_layout():
    _, h, b = _problem()
    assert h.layout is None
    assert all(lv.smoother.ghosts is None for lv in make_low_precision_hierarchy(h).levels)
    with pytest.raises(ValueError, match="shard_hierarchy"):
        distributed_multigrid(h, torch.zeros_like(torch.from_numpy(b)), torch.from_numpy(b))
    res = multigrid(h, torch.zeros_like(torch.from_numpy(b)), torch.from_numpy(b), 3, 1e-16)
    assert res.iterations == 3


def test_operator_ghosts_are_the_neighbours_edge_columns(group):
    """Each sharded float32 level holds ML, MU, S^-1 of the ``min(GHOST_W,
    n_local)`` columns beyond its shard on either side (zeros past the ring
    ends), whether the float32 hierarchy was sharded or the sharded float64
    one cast; whole levels hold none."""
    _, h, _ = _problem()
    h32 = make_low_precision_hierarchy(h)
    flags = shard_hierarchy(h, _fake_group(), min_blocks_per_device=MIN_BLOCKS).layout.sharded
    per_rank = tg.check(group["op_ghosts"])
    for rank, (first, second, bound) in enumerate(per_rank):
        assert tuple(bound) == tuple(flags)  # an edge plan on every sharded level, bound to its tensors
        for k, (lv, sh) in enumerate(zip(h32.levels, flags)):
            if not sh:
                assert first[k] is None and second[k] is None
                continue
            s = lv.smoother
            ops = torch.stack([s.ml, s.mu, s.inv]).numpy()
            n = ops.shape[-1]
            lo, hi = rank * n // WORLD, (rank + 1) * n // WORLD
            w = min(GHOST_W, hi - lo)
            pad = np.zeros(ops.shape[:-1] + (w,), dtype=ops.dtype)
            left = ops[..., lo - w : lo] if rank > 0 else pad
            right = ops[..., hi : hi + w] if rank < WORLD - 1 else pad
            want = np.concatenate([left, right], axis=-1)
            np.testing.assert_array_equal(first[k], want)
            np.testing.assert_array_equal(second[k], want)


def test_initialize_checks_its_arguments(tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        initialize(0, 1, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        initialize(0, 1, store_path=str(tmp_path / "s"), init_method="tcp://localhost:1", device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        initialize(0, 1, store_path=str(tmp_path / "s"), device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize(0, 1, store_path=str(tmp_path / "s"))


ENTRY_POINTS = [
    models.build_problem, models.poisson_cg_hierarchy, models.poisson_dg_cg_hierarchy,
    models.poisson_dg_hierarchy, models.poisson_full_hierarchy, models.inflate_hierarchy,
    models.build_xl_problem, convert.hierarchy_from_numpy, convert.coarse_from_numpy,
    convert.xl_problem_from_numpy, parallel.initialize, parallel.build_sharded_xl_problem,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=[f.__name__ for f in ENTRY_POINTS])
def test_entry_points_default_to_the_card(fn):
    """The card unless the caller asks for the CPU (read from the signature:
    no card is touched).  The rank-local build has no device of its own:
    it builds on its required ``group``'s, which ``initialize`` makes on the
    card by default."""
    params = inspect.signature(fn).parameters
    if "device" not in params:
        assert params["group"].default is inspect.Parameter.empty and params["group"].kind == params["group"].KEYWORD_ONLY
        params = inspect.signature(parallel.initialize).parameters
    assert params["device"].default == "cuda"
