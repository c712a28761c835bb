"""The torch port's ragged agglomerates (element counts the coarsening
factors do not divide) against the JAX package's, on the CPU in float64.

The counterparts of ``tests/test_ragged_agg.py``'s ten tests (the
partition API, ragged == uniform for equal sizes, the Galerkin identities,
prolongation and restriction against dense matrices, the ragged seam, the
convergence order, non-power-of-two hierarchies), each also held to the JAX
package's result on the same inputs; then ``build_problem`` at ragged sizes
(DG-topped n = 20 and 1000, the ragged CG -> agg seam of ``cg_orders=(2, 1)``
at n = 18) against JAX's to 1e-12 relative, with equal ``multigrid`` counts.
Dense references come from ``helpers.rbp_dense`` / ``helpers.seam_dense``
on the JAX package's transfers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rbp_dense, seam_dense

from agglomerationmultigrid1d_tpu.assembly import agg_assembly as jagg_asm
from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh.topology import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh.topology import create_uniform_mesh as jmesh
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models.solvers import multigrid as jmultigrid
from agglomerationmultigrid1d_tpu.ops import bt_to_dense as jbt_to_dense
from agglomerationmultigrid1d_tpu.transfer import interpolation as jint
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.assembly import agg_flux_operators, dg_flux_operators
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    build_problem,
    multigrid,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d_tpu_torch.ops import bd_matvec, bt_matvec, bt_to_dense
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import (
    RaggedBlockProlong,
    rbp_galerkin,
    rbp_prolong,
    rbp_restrict,
    seam_prolong,
    seam_restrict,
)
from agglomerationmultigrid1d_tpu_torch.transfer import interpolation as tint
from agglomerationmultigrid1d_tpu_torch.utils import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

RTOL = 1e-12
BC = (("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


def _close(got, want, what="", atol=None):
    """1e-12 of the array's largest entry (entries that cancel to zero come
    out as rounding residue), or ``atol``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = RTOL * float(np.abs(want).max()) if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=tol, err_msg=what)


def _meshes(n):
    return create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)


def _j(l):
    return jax.tree_util.tree_map(np.asarray, l)


def test_partition_api_matches_reference_form():
    """Explicit element-id lists (the reference's ``agg`` argument) equal the
    sizes form; out-of-order or mis-summing partitions raise."""
    mesh, jm = _meshes(12)
    a_ids = make_agg_mesh(1, mesh, partition=[[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10, 11]])
    a_sizes = make_agg_mesh(1, mesh, partition=[3, 4, 5])
    j_ids = jagg_mesh.make_agg_mesh(1, jm, partition=[[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10, 11]])
    np.testing.assert_array_equal(a_ids.sizes, a_sizes.sizes)
    _close(torch.from_numpy(a_ids.boxes), j_ids.boxes)
    _close(a_ids.mass.blocks, np.asarray(j_ids.mass.blocks))
    for bad in ([[0, 2, 1], [3, 4, 5, 6], [7, 8, 9, 10, 11]], [3, 4, 4]):
        with pytest.raises(ValueError):
            make_agg_mesh(1, mesh, partition=bad)


def test_ragged_matches_uniform_when_sizes_equal():
    mesh, _ = _meshes(16)
    bc = BoundaryCondition(*BC)
    a_u, a_r = make_agg_mesh(1, mesh, 4), make_agg_mesh(1, mesh, partition=[4, 4, 4, 4])
    for xu, xr in zip(agg_flux_operators(a_u, bc, 100.0), agg_flux_operators(a_r, bc, 100.0)):
        _close(bt_to_dense(xr), bt_to_dense(xu).numpy())


@pytest.mark.parametrize("p_agg", [0, 1])
def test_ragged_aggdg_dg_galerkin_consistency(p_agg):
    """Direct ragged assembly == L^T (DG flux operators) L, sizes 3/4/5; the
    transfer equals the JAX package's."""
    c_dir = 100.0
    mesh, jm = _meshes(12)
    bc = BoundaryCondition(*BC)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(p_agg, mesh, partition=[3, 4, 5])
    l = tint.aggdg_dg_interpolation(agg, dg)
    jl = _j(jint.aggdg_dg_interpolation(jagg_mesh.make_agg_mesh(p_agg, jm, partition=[3, 4, 5]),
                                        jdg_mesh.make_dg_mesh(jm, 1)))
    assert isinstance(l, RaggedBlockProlong)
    _close(l.blocks, jl.blocks)
    np.testing.assert_array_equal(l.sizes.numpy(), jl.sizes)
    np.testing.assert_array_equal(l.offsets.numpy(), jl.offsets)
    for x_f, x_a in zip(dg_flux_operators(dg, bc, c_dir), agg_flux_operators(agg, bc, c_dir)):
        _close(bt_to_dense(rbp_galerkin(l, x_f)), bt_to_dense(x_a).numpy(), atol=1e-11)
    ld = rbp_dense(jl)
    mass_f = torch.block_diag(*dg.mass.blocks.permute(2, 0, 1)).numpy()
    mass_c = torch.block_diag(*agg.mass.blocks.permute(2, 0, 1)).numpy()
    _close(torch.from_numpy(ld.T @ mass_f @ ld), mass_c, atol=1e-12)


def test_ragged_galerkin_matches_dense_triple_product(rng):
    """rbp_galerkin == dense L^T X L for a random block-tridiagonal X."""
    mesh, _ = _meshes(12)
    l = tint.aggdg_dg_interpolation(make_agg_mesh(1, mesh, partition=[3, 4, 5]), make_dg_mesh(mesh, 1))
    bs, n = 2, 12
    lo, di, up = (rng.standard_normal((bs, bs, n)) for _ in range(3))
    lo[:, :, 0] = up[:, :, -1] = 0.0
    x = BlockTridiag(*(torch.from_numpy(m) for m in (lo, di, up)))
    ld = rbp_dense(_RaggedView(l))
    _close(bt_to_dense(rbp_galerkin(l, x)), ld.T @ bt_to_dense(x).numpy() @ ld, atol=1e-12)


class _RaggedView:
    """A port transfer as NumPy fields, for ``helpers.rbp_dense``."""

    def __init__(self, l):
        self.blocks, self.sizes, self.offsets = (t.numpy() for t in (l.blocks, l.sizes, l.offsets))
        self.n_fine = l.n_fine


def test_ragged_prolong_restrict_match_dense(rng):
    """Prolongation (a gather through the owner table) and restriction
    against the dense L, and against the JAX package's scatter-add."""
    from agglomerationmultigrid1d_tpu.ops.transfer_ops import rbp_prolong as jprolong
    from agglomerationmultigrid1d_tpu.ops.transfer_ops import rbp_restrict as jrestrict

    mesh, jm = _meshes(12)
    l = tint.aggdg_dg_interpolation(make_agg_mesh(1, mesh, partition=[3, 4, 5]), make_dg_mesh(mesh, 1))
    jl = jint.aggdg_dg_interpolation(jagg_mesh.make_agg_mesh(1, jm, partition=[3, 4, 5]), jdg_mesh.make_dg_mesh(jm, 1))
    ld = rbp_dense(_RaggedView(l))
    xc = rng.standard_normal((2, 3))
    uf = rbp_prolong(l, torch.from_numpy(xc))
    _close(uf.T.reshape(-1), ld @ xc.T.reshape(-1), atol=1e-13)
    _close(uf, np.asarray(jprolong(jl, jnp.asarray(xc))), atol=1e-13)
    rf = rng.standard_normal((2, 12))
    rc = rbp_restrict(l, torch.from_numpy(rf))
    _close(rc.T.reshape(-1), ld.T @ rf.T.reshape(-1), atol=1e-13)
    _close(rc, np.asarray(jrestrict(jl, jnp.asarray(rf))), atol=1e-13)
    # each fine column is written once: the owner table covers every fine block exactly once
    assert sorted(zip(l.owner.tolist(), l.slot.tolist())) == [(c, j) for c, s in enumerate([3, 4, 5]) for j in range(s)]


def test_ragged_recursive_agglomeration_galerkin():
    """Ragged first level + ragged recursive grouping: rediscretization ==
    Galerkin through the L2 transfer (aggdg_interpolation_test.jl:53-63),
    and the transfer equals the JAX package's."""
    c_dir = 100.0
    mesh, jm = _meshes(12)
    bc = BoundaryCondition(*BC)
    a1 = make_agg_mesh(1, mesh, partition=[1, 2, 1, 2, 2, 1, 2, 1], tables=False)
    a2 = coarsen_agg_mesh(a1, partition=[3, 2, 3])
    np.testing.assert_array_equal(a2.sizes, [4, 4, 4])
    l = tint.aggdg_aggdg_interpolation(a2, a1)
    assert isinstance(l, RaggedBlockProlong)
    j1 = jagg_mesh.make_agg_mesh(1, jm, partition=[1, 2, 1, 2, 2, 1, 2, 1], tables=False)
    jl = _j(jint.aggdg_aggdg_interpolation(jagg_mesh.coarsen_agg_mesh(j1, partition=[3, 2, 3]), j1))
    _close(l.blocks, jl.blocks)
    for x_f, x_c in zip(agg_flux_operators(a1, bc, c_dir), agg_flux_operators(a2, bc, c_dir)):
        _close(bt_to_dense(rbp_galerkin(l, x_f)), bt_to_dense(x_c).numpy(), atol=1e-10)
    ld = rbp_dense(_RaggedView(l))
    mass1 = torch.block_diag(*a1.mass.blocks.permute(2, 0, 1)).numpy()
    mass2 = torch.block_diag(*a2.mass.blocks.permute(2, 0, 1)).numpy()
    _close(torch.from_numpy(ld.T @ mass1 @ ld), mass2, atol=1e-12)


def test_ragged_seam_reproduces_constants_and_dense(rng):
    mesh, jm = _meshes(12)
    agg, cg = make_agg_mesh(1, mesh, partition=[3, 4, 5]), make_cg_mesh(mesh, 2)
    l = tint.aggdg_cg_interpolation(agg, cg)
    assert l.offsets is not None
    jl = jint.aggdg_cg_interpolation(jagg_mesh.make_agg_mesh(1, jm, partition=[3, 4, 5]), jcg_mesh.make_cg_mesh(jm, 2), 1)
    for f in ("n_win", "inv_lump", "offsets"):
        _close(getattr(l, f).double(), np.asarray(getattr(jl, f), np.float64), f)
    u_agg = torch.stack([torch.ones(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)])
    _close(seam_prolong(l, u_agg), np.ones(cg.n_nodes), atol=1e-12)
    ld = seam_dense(jl)
    xc = rng.standard_normal((2, 3))
    _close(seam_prolong(l, torch.from_numpy(xc)), ld @ xc.T.reshape(-1), atol=1e-12)
    rf = rng.standard_normal((cg.n_nodes,))
    _close(seam_restrict(l, torch.from_numpy(rf)).T.reshape(-1), ld.T @ rf, atol=1e-12)


def test_ragged_convergence_order():
    """Direct flux solve on alternating 3/5 agglomerates: O(h^2) for p_agg = 1
    (aggdg_convergence_test.jl).  The port's ragged operators with the JAX
    package's load vector (the quadrature tables it needs are not ported:
    the hierarchy never reads them), the L2 error from the JAX package's."""
    from test_ragged_agg import _agg_l2_error  # the L2 error against the exact solution

    bc, jbc = BoundaryCondition(("dir", np.cos(0.0)), ("neu", -np.sin(1.0))), JBC(("dir", np.cos(0.0)), ("neu", -np.sin(1.0)))
    errs, ns = [], [16, 32, 64]
    for n in ns:
        mesh, jm = _meshes(n)
        part = [3, 5] * (n // 8)
        agg, jagg = make_agg_mesh(1, mesh, partition=part), jagg_mesh.make_agg_mesh(1, jm, partition=part)
        g, d, c = agg_flux_operators(agg, bc, 1.0 * n)
        for x, jx in zip((g, d, c), jagg_asm.agg_flux_operators(jagg, jbc, 1.0 * n)):
            _close(bt_to_dense(x), np.asarray(jbt_to_dense(jx)))
        f, rr = (torch.from_numpy(np.asarray(v)) for v in jagg_asm.agg_flux_rhs(jagg, jnp.cos, jbc, 1.0 * n))
        a = schur_stiffness(g, d, c, agg.mass_inv)
        b = f - bt_matvec(d, bd_matvec(agg.mass_inv, rr))
        u = np.linalg.solve(bt_to_dense(a).numpy(), b.T.reshape(-1).numpy()).reshape(agg.n_agg, 2).T
        errs.append(_agg_l2_error(jagg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    assert abs(slope - 2.0) < 0.35, (slope, errs)


def _multigrid_counts(prob, jprob, maxiter):
    res = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, maxiter, 1e-10)
    jres = jmultigrid(jprob.hierarchy, jnp.zeros_like(jprob.b), jprob.b, maxiter, 1e-10)
    return res, int(jres.iterations)


def test_non_power_of_two_full_hierarchy():
    """A full CG + agg hierarchy on n = 96 (not a power of two) builds via
    near-uniform ragged partitions and converges h-independently, in as
    many V-cycles as the JAX package's."""
    prob = poisson_full_hierarchy(n=96, n_agg=5, device="cpu")
    res, j_it = _multigrid_counts(prob, jproblems.poisson_full_hierarchy(n=96, n_agg=5), 50)
    nb = float(torch.linalg.vector_norm(prob.b))
    assert res.iterations <= 14 and res.iterations == j_it, (res.iterations, j_it)
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * nb * 1.01


def test_non_power_of_two_dg_agg_hierarchy():
    prob = poisson_dg_hierarchy(n=96, max_p=4, n_dg=3, n_agg=4, device="cpu")
    res, j_it = _multigrid_counts(prob, jproblems.poisson_dg_hierarchy(n=96, max_p=4, n_dg=3, n_agg=4), 80)
    nb = float(torch.linalg.vector_norm(prob.b))
    assert res.iterations <= 40 and res.iterations == j_it, (res.iterations, j_it)
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * nb * 1.01


RAGGED = {  # name: (port builder, JAX builder, multigrid maxiter)
    "dg-n20": (lambda: poisson_dg_hierarchy(n=20, max_p=1, n_dg=1, n_agg=2, device="cpu"),
               lambda: jproblems.poisson_dg_hierarchy(n=20, max_p=1, n_dg=1, n_agg=2), 80),
    "dg-n1000": (lambda: poisson_dg_hierarchy(n=1000, max_p=3, n_dg=2, n_agg=5, device="cpu"),
                 lambda: jproblems.poisson_dg_hierarchy(n=1000, max_p=3, n_dg=2, n_agg=5), 80),
    "cg21-seam-n18": (lambda: build_problem(HierarchySpec(cg_orders=(2, 1), n_agg_levels=1), 18, device="cpu"),
                      lambda: jproblems.build_problem(JHierarchySpec(cg_orders=(2, 1), n_agg_levels=1), 18), 80),
}


@functools.lru_cache(maxsize=None)
def _ragged_pair(name):
    build, jbuild, _ = RAGGED[name]
    return build(), jbuild()


@pytest.mark.parametrize("name", list(RAGGED))
def test_build_problem_at_ragged_sizes_matches_jax(name):
    """Every level's operator and smoother, every transfer, the coarse
    solver and the rhs against the JAX package's (carried across by
    ``hierarchy_from_numpy``) to 1e-12; equal ``multigrid`` counts."""
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_map

    prob, jprob = _ragged_pair(name)
    want = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy), device="cpu")
    assert any(isinstance(t, RaggedBlockProlong) or getattr(t, "offsets", None) is not None
               for t in prob.hierarchy.transfers)
    # the coarse operator to 1e-12; its explicit inverse (c_dir = 1000 n: ill
    # conditioned) amplifies the 1e-15 operator rounding, so it is held by
    # the identity it must satisfy
    got_leaves, want_leaves = [], []
    tree_map(got_leaves.append, (prob.hierarchy.levels, prob.hierarchy.transfers, prob.hierarchy.coarse.a_dense))
    tree_map(want_leaves.append, (want.levels, want.transfers, want.coarse.a_dense))
    c = prob.hierarchy.coarse
    eye = torch.eye(c.n, dtype=torch.float64)
    assert float((c.a_dense @ c.a_inv - eye).abs().max()) <= 10 * float((want.coarse.a_dense @ want.coarse.a_inv - eye).abs().max()) + 1e-12
    assert len(got_leaves) == len(want_leaves) > 10
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        if w.numel() == 0:
            continue
        if not w.is_floating_point():
            assert torch.equal(g, w.to(g.dtype)), i
            continue
        _close(g, w.numpy(), f"leaf {i}")
    _close(prob.b, np.asarray(jprob.b), "b")
    res, j_it = _multigrid_counts(prob, jprob, RAGGED[name][2])
    assert res.iterations == j_it and float(res.res_history[res.iterations - 1]) < 1e-10 * float(
        torch.linalg.vector_norm(prob.b)) * 1.01


def test_stencil_inflation_refuses_ragged_transfers():
    """Ragged transfers are position dependent: the stencil planner refuses
    them with the JAX package's messages (``stencil_setup.py:268-277``)."""
    from agglomerationmultigrid1d_tpu_torch.models.stencil_setup import _Plan, _plan_transfer

    dg = poisson_dg_hierarchy(n=20, max_p=1, n_dg=1, n_agg=2, device="cpu").hierarchy
    with pytest.raises(ValueError, match="RaggedBlockProlong transfers are position dependent"):
        _plan_transfer(_Plan(2, 4), dg.transfers[-1], 1, "cpu")
    seam = build_problem(HierarchySpec(cg_orders=(2, 1), n_agg_levels=1), 18, device="cpu").hierarchy
    with pytest.raises(ValueError, match="uniform seam partitions"):
        _plan_transfer(_Plan(2, 4), seam.transfers[-1], 1, "cpu")
