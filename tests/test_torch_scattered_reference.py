"""The benchmark's plain scattered-agglomeration reference
(``aggmg_bench/references/scattered_dg.py``) against the port's scattered
chain (``poisson_scattered_hierarchy`` with ``interleaved_pair_groups``) on
the CPU at two small sizes: the partition, the fine operator and
right-hand side, and every block-COO level's operator and prolongation
equal the reference's to 1e-12 of each column's largest entry; float64
``multigrid`` and ``multigrid_mixed`` reach 1e-10 on the reference's
operator and lie as near its direct solve as that residual allows; a
partition with two members swapped between two level-1 agglomerates fails
the comparison; and the reference loads neither package nor JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aggmg_bench import reference
from agglomerationmultigrid1d_tpu_torch.models import (
    interleaved_pair_groups,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    poisson_scattered_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_coo import bcoo_to_dense

ROOT = Path(__file__).resolve().parents[1]
REF = reference.load("scattered_dg")
SIZES = {"256-8": (256, 8), "1024-16": (1024, 16)}  # elements, coarsest agglomerates
TOL = 1e-12


def _disc(n):
    return dict(p=1, n_elements=n, domain=[0.0, 1.0], c_dir=1000.0 * n, left="neumann", right="dirichlet",
                mesh="vertices")


def _part(coarsest):
    return {"kind": "interleaved_pairs", "coarsest": coarsest}


def _port(n, coarsest, groups=None):
    groups = interleaved_pair_groups(n, coarsest) if groups is None else groups
    return poisson_scattered_hierarchy(n=n, p_dg=1, groups_per_level=groups, device="cpu")


def _ref(n, coarsest):
    prob = REF.Problem(_disc(n))
    return prob, REF.scattered_levels(prob, _part(coarsest))


def _prolong_dense(t):
    n_f = t.blocks.shape[2]
    return REF.block_sparse(torch.arange(n_f), t.cols, t.blocks, n_f, t.n_coarse).to_dense()


@pytest.mark.parametrize("size", SIZES)
def test_partition_equals_the_port(size):
    n, coarsest = SIZES[size]
    port = _port(n, coarsest)
    maps = REF.owner_maps(_part(coarsest), n)
    groups = interleaved_pair_groups(n, coarsest)
    assert len(maps) == len(groups) == port.hierarchy.n_levels - 1
    owner = np.arange(n)
    for k, (step, g) in enumerate(zip(maps, groups), 1):
        assert np.array_equal(REF.members(step), np.sort(np.asarray(g), axis=1)), k
        owner = step[owner]
        assert np.array_equal(port.meshes[k].assign, owner), k
    assert int(owner.max()) + 1 == coarsest


@pytest.mark.parametrize("size", SIZES)
def test_fine_operator_and_rhs_equal_the_reference(size):
    n, coarsest = SIZES[size]
    port = _port(n, coarsest)
    prob = REF.Problem(_disc(n))
    a = port.hierarchy.levels[0].a
    for got, want in zip((a.lower, a.diag, a.upper), prob.operator_columns(0, n)):
        assert reference.max_column_gap(got, want) < TOL
    want_b = prob.rhs_columns(torch.cos, -np.sin(0.0), np.cos(1.0), 0, n)
    assert reference.max_column_gap(port.b, want_b) < TOL


@pytest.mark.parametrize("size", SIZES)
def test_every_level_equals_the_reference(size):
    """Each block-COO level's ``A`` (``bcoo_to_dense``) and the
    prolongation onto the level above it."""
    n, coarsest = SIZES[size]
    h = _port(n, coarsest).hierarchy
    _, levels = _ref(n, coarsest)
    assert len(levels) == h.n_levels - 1
    for k, lv in enumerate(levels, 1):
        a = bcoo_to_dense(h.levels[k].a)
        assert a.shape == lv["a"].shape
        assert reference.max_column_gap(a, lv["a"].to_dense()) < TOL, k
        assert reference.max_column_gap(_prolong_dense(h.transfers[k - 1]), lv["p"].to_dense()) < TOL, k
        assert REF.column_gap(a.to_sparse(), lv["a"]) < TOL, k


def _dense_fine(prob):
    """The reference's fine operator, dense (dof ``k bs + i``)."""
    lower, diag, upper = prob.operator_columns(0, prob.n)
    e = torch.arange(prob.n)
    rows = torch.cat([e, e[1:], e[:-1]])
    cols = torch.cat([e, e[1:] - 1, e[:-1] + 1])
    blocks = torch.cat([diag, lower[..., 1:], upper[..., :-1]], dim=-1)
    return REF.block_sparse(rows, cols, blocks, prob.n, prob.n).to_dense()


@pytest.mark.parametrize("size", SIZES)
def test_solves_reach_the_reference(size):
    """``||b - A x|| / ||b||`` below 1e-10 on the reference's operator; the
    reference's direct solve reads ~1e-16 there, and each ``x`` lies as
    near it as the residual allows: ``||x - x_ref|| / ||x_ref|| <= cond(A)
    ||b - A x|| / ||b||`` (cond ~1e9 at 1,024 elements and c_dir = 1000 n,
    so a residual of 1e-10 pins ``x`` only to ~1e-1 in the worst case)."""
    n, coarsest = SIZES[size]
    port = _port(n, coarsest)
    h, b = port.hierarchy, port.b
    prob = REF.Problem(_disc(n))
    b_of = lambda lo, hi: b[:, lo:hi]  # noqa: E731
    x_ref = REF.direct_solve(prob.operator_columns(0, n), b)
    assert reference.relative_residual(prob, x_ref, b_of) < 1e-14
    cond = float(np.linalg.cond(_dense_fine(prob).numpy()))
    xs = {"multigrid": multigrid(h, torch.zeros_like(b), b, 80, 1e-10, compute_error=False).x,
          "multigrid_mixed": multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80,
                                             1e-10).x}
    for name, x in xs.items():
        res = reference.relative_residual(prob, x, b_of)
        assert res < 1e-10, (name, res)
        err = float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref))
        assert err <= cond * (res + 1e-14), (name, err, cond)


def test_swapped_members_fail_the_comparison():
    """Level-1 agglomerates 0 = {0, 2} and 1 = {1, 3} swap one member each
    ({0, 3}, {1, 2}): the port builds a valid chain, and its level-1
    operator and prolongation no longer match the reference's."""
    n, coarsest = SIZES["256-8"]
    groups = interleaved_pair_groups(n, coarsest)
    groups[0] = groups[0].copy()
    groups[0][0], groups[0][1] = [0, 3], [1, 2]
    h = _port(n, coarsest, groups).hierarchy
    _, levels = _ref(n, coarsest)
    assert reference.max_column_gap(bcoo_to_dense(h.levels[1].a), levels[0]["a"].to_dense()) > 1e-3
    assert reference.max_column_gap(_prolong_dense(h.transfers[0]), levels[0]["p"].to_dense()) > 1e-3


def test_reference_loads_neither_package():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from aggmg_bench import reference;"
            "m = reference.load('scattered_dg');"
            "p = m.Problem(dict(p=1, n_elements=64, domain=[0.0, 1.0], c_dir=64000.0, left='neumann',"
            " right='dirichlet', mesh='vertices'));"
            "m.scattered_levels(p, dict(kind='interleaved_pairs', coarsest=4));"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in"
            " ('jax', 'jaxlib', 'agglomerationmultigrid1d_tpu', 'agglomerationmultigrid1d_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
