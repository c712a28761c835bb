"""The torch port's own DG-topped setup against the JAX package's: every
level's operators, smoother blocks and transfers, the coarse solver and the
right-hand side, to 1e-12 relative (both in float64 on the CPU)."""

import functools

import jax
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.problems import poisson_dg_hierarchy as jax_problem
from agglomerationmultigrid1d_tpu_torch.mesh import BoundaryCondition, create_uniform_mesh, make_dg_mesh
from agglomerationmultigrid1d_tpu_torch.models import (
    build_problem,
    poisson_dg_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d_tpu_torch.assembly import dg_flux_operators
from agglomerationmultigrid1d_tpu_torch.utils import HierarchySpec

RTOL = 1e-12

# the slice's shape at test size, the DG-topped configurations of
# tests/test_hierarchy.py and tests/test_pallas.py, and piecewise-constant
# agglomerated levels
CONFIGS = {
    "dg3-agg3": dict(n=64, max_p=3, n_dg=2, n_agg=3),
    "dg-default": dict(n=128),
    "dg4-mixed": dict(n=256, max_p=4, n_dg=3),
    "dg2-agg2-p0": dict(n=64, max_p=2, n_dg=2, n_agg=2, p_agg=0),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    kw = CONFIGS[name]
    jprob = jax_problem(**kw)
    jh = jax.tree_util.tree_map(np.asarray, jprob.hierarchy)
    return poisson_dg_hierarchy(**kw, device="cpu"), jh, np.asarray(jprob.b)


def _close(got: torch.Tensor, want, what):
    """1e-12 relative to each entry, or to the array's largest entry: entries
    that cancel to zero come out as rounding residue (~1e-16 of the scale)
    whose relative size means nothing."""
    want = np.asarray(want)
    atol = RTOL * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_level_count_and_shapes(name):
    prob, jh, _ = _pair(name)
    h = prob.hierarchy
    assert h.n_levels == len(jh.levels)
    for lv, jlv in zip(h.levels, jh.levels):
        assert tuple(lv.a.diag.shape) == jlv.a.diag.shape
        assert lv.a.diag.dtype == torch.float64


@pytest.mark.parametrize("name", list(CONFIGS))
def test_level_operators_match_jax(name):
    prob, jh, _ = _pair(name)
    for k, (lv, jlv) in enumerate(zip(prob.hierarchy.levels, jh.levels)):
        for op in ("a", "g", "d", "c"):
            for part in ("lower", "diag", "upper"):
                _close(getattr(getattr(lv, op), part), getattr(getattr(jlv, op), part), f"level {k} {op}.{part}")
        _close(lv.mass_inv, jlv.mass_inv, f"level {k} mass_inv")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoothers_match_jax(name):
    prob, jh, _ = _pair(name)
    for k, (lv, jlv) in enumerate(zip(prob.hierarchy.levels, jh.levels)):
        _close(lv.smoother.inv, jlv.smoother.inv, f"level {k} smoother.inv")
        assert lv.smoother.ml is None and jlv.smoother.ml is None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_transfers_match_jax(name):
    prob, jh, _ = _pair(name)
    for k, (tr, jtr) in enumerate(zip(prob.hierarchy.transfers, jh.transfers)):
        _close(tr.blocks, jtr.blocks, f"transfer {k}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_coarse_and_rhs_match_jax(name):
    prob, jh, jb = _pair(name)
    _close(prob.hierarchy.coarse.a_dense, jh.coarse.a_dense, "coarse a_dense")
    _close(prob.hierarchy.coarse.a_inv, jh.coarse.a_inv, "coarse a_inv")
    _close(prob.b, jb, "b")


def test_device_argument_places_everything():
    prob = poisson_dg_hierarchy(n=32, max_p=2, n_dg=2, n_agg=1, device="cpu")
    leaves = [prob.b]
    for lv in prob.hierarchy.levels:
        leaves += [*lv.a, lv.smoother.inv]
    assert all(t.device.type == "cpu" for t in leaves)


def test_unported_configurations_raise():
    """Ragged agglomerates are ported now (the ragged CG -> agg seam and
    ragged agglomerated levels build, their operators against the JAX
    package's in ``tests/test_torch_ragged.py``), and so is the mixed switch
    (a block-pentadiagonal Schur stiffness, against the JAX package's in
    ``tests/test_torch_penta.py``), and so is sharding a pentadiagonal
    level: by columns, all five streams (its halo exchanges against the
    unsharded operator in ``tests/test_torch_parallel_families.py``)."""
    from agglomerationmultigrid1d_tpu_torch.mesh import make_agg_mesh
    from agglomerationmultigrid1d_tpu_torch.models import build_dg_hierarchy
    from agglomerationmultigrid1d_tpu_torch.ops import BlockPenta
    from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import RaggedBlockProlong, SeamProlong
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy
    from agglomerationmultigrid1d_tpu_torch.parallel.multihost import SolverGroup

    seam = build_problem(HierarchySpec(cg_orders=(2, 1), n_agg_levels=1), 18, device="cpu")  # a ragged CG -> agg seam
    assert isinstance(seam.hierarchy.transfers[-1], SeamProlong) and seam.hierarchy.transfers[-1].offsets is not None
    ragged = poisson_dg_hierarchy(n=20, max_p=1, n_dg=1, n_agg=2, device="cpu")  # 20 -> 5 -> 2 agglomerates
    assert isinstance(ragged.hierarchy.transfers[-1], RaggedBlockProlong)
    assert [lv.a.n_blocks for lv in ragged.hierarchy.levels] == [20, 5, 2]
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1, switch=np.array([False, False, False, True, True, True, True]))
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    g, d, c = dg_flux_operators(dg, bc, 1.0)
    assert float(g.upper.abs().max()) > 0 and float(d.lower.abs().max()) > 0  # the flipped vertices' couplings
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    assert isinstance(a, BlockPenta)  # stored pentadiagonal; a non-trapping switch's distance-2 blocks are 0
    h = build_dg_hierarchy([dg, make_agg_mesh(1, mesh, 2, tables=False)], a, g, d, c)  # the fine level shards, the coarsest not
    for rank in range(2):
        group = SolverGroup(group=None, rank=rank, world=2, device=torch.device("cpu"), backend="gloo")
        hs = shard_hierarchy(h, group, min_blocks_per_device=2)
        assert hs.layout.sharded == (True, False)
        lo, hi = rank * 4, (rank + 1) * 4
        assert isinstance(hs.levels[0].a, BlockPenta)
        assert all(torch.equal(t, w[..., lo:hi]) for t, w in zip(hs.levels[0].a, a))


@pytest.mark.parametrize("name", ["dg3-agg3", "dg4-mixed"])
def test_low_precision_hierarchy_matches_jax(name):
    """float32 cast plus the M-form streams ``ml = S^-1 A_L``, ``mu = S^-1 A_U``
    that the multisweep kernels read; float32 products, so to 1e-6."""
    from agglomerationmultigrid1d_tpu.models.solvers import make_low_precision_hierarchy as jlow
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy

    prob, _, _ = _pair(name)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    jh32 = jax.tree_util.tree_map(np.asarray, jlow(jax_problem(**CONFIGS[name]).hierarchy))
    for k, (lv, jlv) in enumerate(zip(h32.levels, jh32.levels)):
        for got, want, what in (
            (lv.a.diag, jlv.a.diag, "a.diag"),
            (lv.smoother.inv, jlv.smoother.inv, "inv"),
            (lv.smoother.ml, jlv.smoother.ml, "ml"),
            (lv.smoother.mu, jlv.smoother.mu, "mu"),
        ):
            assert got.dtype == torch.float32 and got.is_contiguous()
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()),
                err_msg=f"level {k} {what}",
            )
