"""CG levels on a shard (``parallel/distributed.py``, ``parallel/cg_levels.py``)
against the JAX package's sharded CG-topped solve on the CPU.

The JAX package shards ``poisson_full_hierarchy(n=64)`` (CG p = 8, 4, 2, 1
on 64 elements, a seam onto agglomerates, 5 agglomerated levels) on its
virtual CPU mesh cut to 4 devices, padding each CG level's nodes to a device
multiple (``tests/test_distributed.py:58-100``).  The port shards the same
hierarchy (converted, so both solve the same inputs) over one spawned
4-rank gloo group (``torch_group.run_group``), with ``min_blocks_per_device=2``
and each rank owning the nodes of its own elements (the last rank also the
last node), for the Jacobi smoother, both Schwarz forms and Chebyshev
smoothing over Jacobi (JAX's ``chebyshev_hierarchy``, its bounds handed to
the port):

* float64 ``multigrid``: iterations equal to JAX's sharded and unsharded
  solves; x within 1e-12 ||b|| of the port's unsharded x; histories to rtol
  1e-10 of the port's unsharded ones, and of JAX's sharded ones above the
  two packages' float64 floor (as G10 holds the DG-topped solve);
* ``multigrid_mixed`` and ``multigrid_progressive``: counts equal to the
  port's unsharded solves;
* the CG levels really sharded: each rank's node and element counts;
* ``cg_matvec``, the smoothers (Jacobi, additive and hybrid Schwarz), and
  the CG and seam transfers on the shards, gathered, against the unsharded
  functions: exactly equal (every node is summed in the whole level's order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_group as tg
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.models.hierarchy import CgLevel as JCgLevel
from agglomerationmultigrid1d_tpu.models.hierarchy import chebyshev_hierarchy as jchebyshev_hierarchy
from agglomerationmultigrid1d_tpu.parallel import make_solver_mesh
from agglomerationmultigrid1d_tpu.parallel import shard_hierarchy as jshard_hierarchy
from agglomerationmultigrid1d_tpu.parallel.distributed import shard_vector as jshard_vector
from agglomerationmultigrid1d_tpu.parallel.distributed import unshard_vector as junshard_vector
from agglomerationmultigrid1d_tpu.smoothers.smoother import cg_smoother as jcg_smoother
from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid, multigrid_mixed
from agglomerationmultigrid1d_tpu_torch.models import multigrid_progressive
from agglomerationmultigrid1d_tpu_torch.models.hierarchy import CgLevel
from agglomerationmultigrid1d_tpu_torch.models.solvers import _prolong, _restrict, _smoother_apply, level_matvec
from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import cg_smoother
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

WORLD = 4
N = 64
MIN_BLOCKS = 2
KINDS = ("jac", "addSchwarz", "hybridSchwarz", "chebyshev")  # the last: Chebyshev over Jacobi
SEED = 3


def _jax_problem(kind):
    jprob = jproblems.poisson_full_hierarchy(n=N)
    jh = jprob.hierarchy
    if kind == "chebyshev":
        jh = jchebyshev_hierarchy(jh)
    elif kind != "jac":
        jh = jh._replace(levels=tuple(
            lv._replace(smoother=jcg_smoother(lv.a, kind)) if isinstance(lv, JCgLevel) else lv for lv in jh.levels
        ))
    return jprob, jh


def _port_problem(kind):
    jprob, jh = _jax_problem(kind)
    return hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jh), device="cpu"), np.array(jprob.b)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jobs = []
    for kind in KINDS:
        h, b = _port_problem(kind)
        jobs.append((f"solve-{kind}", tg.job_cg_solves, (h, b, MIN_BLOCKS)))
    jobs.append(("ops", tg.job_cg_ops, (_port_problem("jac")[0], MIN_BLOCKS, SEED)))
    store = tmp_path_factory.mktemp("gloo") / "store"
    return tg.run_group(jobs, WORLD, str(store), timeout_s=240)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_cg_multigrid_matches_jax(group, kind):
    """Equal iterations with JAX's sharded and unsharded solves; the port's
    x within 1e-12 ||b|| of its unsharded x; histories to rtol 1e-10 of the
    port's unsharded ones (the sharding alone: the norms sum per rank) and of
    JAX's sharded solve above the packages' float64 floor: their unsharded
    solves of these three problems differ by up to 9.7e-13 of the first
    residual and 1.2e-11 of the first error; the floors are 4e-12 and 1e-10
    of them."""
    jprob, jh = _jax_problem(kind)
    jref = jsolvers.multigrid(jh, jnp.zeros_like(jprob.b), jprob.b, 50, 1e-10)
    mesh = make_solver_mesh(WORLD)
    jhs = jshard_hierarchy(jh, mesh, min_blocks_per_device=MIN_BLOCKS)
    jb = jshard_vector(jprob.b, mesh, jhs)
    jres = jsolvers.multigrid(jhs, jnp.zeros_like(jb), jb, 50, 1e-10)
    h, b = _port_problem(kind)
    tb = torch.from_numpy(b)
    ref = multigrid(h, torch.zeros_like(tb), tb, 50, 1e-10)
    got = tg.check(group[f"solve-{kind}"])[0]
    it = int(jres.iterations)
    assert got["iterations"] == ref.iterations == it == int(jref.iterations)
    assert np.isnan(got["res"][it:]).all()
    nb = float(np.linalg.norm(b))
    np.testing.assert_allclose(got["x"], ref.x.numpy(), rtol=0, atol=1e-12 * nb)
    for key, port, jax_h, floor in (
        ("res", ref.res_history, jres.res_history, 4e-12),
        ("err", ref.err_history, jres.err_history, 1e-10),
    ):
        np.testing.assert_allclose(got[key][:it], port.numpy()[:it], rtol=1e-10)
        want = np.asarray(jax_h)[:it]
        np.testing.assert_allclose(got[key][:it], want, rtol=1e-10, atol=floor * want[0])
    np.testing.assert_allclose(got["x"], np.asarray(junshard_vector(jres.x, jhs)), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_cg_low_precision_counts_equal_unsharded(group, kind):
    """``multigrid_mixed`` (outer / inner) and ``multigrid_progressive``
    (cycles) on the sharded hierarchies take the unsharded port's counts."""
    h, b = _port_problem(kind)
    tb = torch.from_numpy(b)
    h32 = make_low_precision_hierarchy(h)
    got = tg.check(group[f"solve-{kind}"])[0]
    for name, fn in (("mixed", multigrid_mixed), ("progressive", multigrid_progressive)):
        ref = fn(h, h32, torch.zeros_like(tb), tb, 60, 1e-10)
        assert got[name] == (ref.iterations, ref.inner_cycles), name


def test_cg_levels_are_sharded_by_element(group):
    """Every CG level is sharded (its 64 elements give each of the 4 ranks
    16): rank r holds elements 16 r .. 16 r + 15 and their first p nodes
    each, the last rank also the last node; the seam's coarse level (16
    agglomerates) and the one below (8) are sharded too, the rest whole."""
    h, _ = _port_problem("jac")
    per_rank = tg.check(group["solve-jac"])
    want_flags = tuple(isinstance(lv, CgLevel) or lv.a.n_blocks >= 8 for lv in h.levels[:-1]) + (False,)
    for rank, got in enumerate(per_rank):
        assert got["flags"] == want_flags
        for lv, local, sh in zip(h.levels, got["local"], want_flags):
            if isinstance(lv, CgLevel):
                m = N // WORLD * lv.a.p
                assert local == (m + (rank == WORLD - 1), N // WORLD)
            else:
                assert local == ((lv.a.n_blocks // WORLD if sh else lv.a.n_blocks),)


def test_cg_operations_on_shards_equal_unsharded(group):
    """``cg_matvec``, Jacobi, additive and hybrid Schwarz, the CG and seam
    prolongations and restrictions on each rank's shards, gathered: equal to
    the unsharded functions exactly (the vertex two ranks share takes its
    owner's sum in the whole level's order, or the left element's value)."""
    h, _ = _port_problem("jac")
    got = tg.check(group["ops"])[0]
    assert len(got) == 4 + 6 + 2 * 4  # 4 CG levels' matvecs, their smoothers and both Schwarz forms on level 0, 4 transfers
    for name, (v, out) in got.items():
        t = torch.from_numpy(v)
        if name.startswith("matvec"):
            k = int(name[6:])
            want = level_matvec(h.levels[k], t)
        elif name.startswith("smoother"):
            k, kind = name[8:].split("-")
            lv = h.levels[int(k)]
            s = lv.smoother if kind == "own" else cg_smoother(lv.a, kind)
            want = _smoother_apply(s, t, 2.0 / 3.0)
        elif name.startswith("prolong"):
            want = _prolong(h, int(name[7:]), t)
        else:
            want = _restrict(h, int(name[8:]), t)
        np.testing.assert_array_equal(out, want.numpy(), err_msg=name)
