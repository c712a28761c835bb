"""The torch port's scattered (non-contiguous) agglomeration family against
the JAX package's, on the CPU in float64.

The counterparts of ``tests/test_scattered.py``: the block-COO algebra, a
contiguous partition through the scattered path against the contiguous
``AggMesh`` path, the mesh structure and the partition checks (the JAX
package's messages, word for word), rediscretization == Galerkin projection
for interleaved partitions, the switch, the scattered transfers, recursive
coarsening and end-to-end ``multigrid``.  Each holds the port to the JAX
package on the same seeded NumPy inputs: operators to 1e-12 of their largest
entry, float64 ``multigrid`` counts equal with histories to rtol 1e-9 (plus
1e-12 of the first entry).  Then the port's own: its linear-time partition
code against JAX's owner maps up to 4,096 elements, ``chip_smoke.py``'s
chain (interleaved pairs, then pairwise merges) at 2,048 elements with
float64, mixed and Chebyshev solves, the fused kernels launched at the fine
level's shape only, ``hierarchy_from_numpy`` on JAX's scattered and
pentadiagonal hierarchies, and ``shard_hierarchy`` refusing block-COO
levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import sp_dense

from agglomerationmultigrid1d_tpu import ops as jops
from agglomerationmultigrid1d_tpu.assembly import dg_assembly as jdg_asm
from agglomerationmultigrid1d_tpu.assembly import scattered_assembly as jsc_asm
from agglomerationmultigrid1d_tpu.mesh import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh import scattered_agg as jsc_mesh
from agglomerationmultigrid1d_tpu.mesh import topology as jtopo
from agglomerationmultigrid1d_tpu.models import hierarchy as jhier
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.transfer import scattered_transfer as jsc_tr
from agglomerationmultigrid1d_tpu_torch.assembly import (
    agg_flux_operators,
    dg_flux_operators,
    dg_flux_rhs,
    scattered_flux_operators,
    scattered_flux_rhs,
    scattered_schur,
)
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    coarsen_scattered_agg_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_dg_mesh,
    make_scattered_agg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    build_dg_hierarchy,
    chebyshev_hierarchy,
    interleaved_pair_groups,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    multigrid_progressive,
    poisson_scattered_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d_tpu_torch.models import solvers as tsolvers
from agglomerationmultigrid1d_tpu_torch.ops import (
    BlockCOO,
    BlockTridiag,
    bcoo_add,
    bcoo_coalesce,
    bcoo_diag_blocks,
    bcoo_from_bt,
    bcoo_matvec,
    bcoo_matvec_t,
    bcoo_scale_cols,
    bcoo_spgemm,
    bcoo_to_dense,
    bd_matvec,
    bt_matvec,
    bt_to_dense,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag
from agglomerationmultigrid1d_tpu_torch.parallel.multihost import SolverGroup
from agglomerationmultigrid1d_tpu_torch.transfer import (
    ScatteredProlong,
    aggdg_dg_interpolation,
    scattered_dg_interpolation,
    scattered_galerkin,
    scattered_scattered_interpolation,
    sp_prolong,
    sp_restrict,
)
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy
from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype

RTOL = 1e-12
BC = (("dir", 0.0), ("dir", 0.0))
C_DIR = 100.0
INTERLEAVED = [[0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11]]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", scale=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    s = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * s, err_msg=what)


def _close_coo(got: BlockCOO, want, what=""):
    """Same coordinates, blocks to 1e-12 of their largest entry."""
    np.testing.assert_array_equal(_np(got.rows), _np(want.rows), err_msg=what)
    np.testing.assert_array_equal(_np(got.cols), _np(want.cols), err_msg=what)
    assert (got.n_rows, got.n_cols) == (int(want.n_rows), int(want.n_cols))
    _close(got.blocks, want.blocks, what)


def _meshes(n):
    return create_uniform_mesh(n, 0.0, 1.0), jtopo.create_uniform_mesh(n, 0.0, 1.0)


def _history_close(got, want, it):
    got, want = _np(got)[:it], _np(want)[:it]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * abs(want[0]))


def _rand_coo_inputs(rng, n, bs, density):
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    rows, cols = np.nonzero(mask)
    return rows, cols, rng.standard_normal((bs, bs, rows.size))


# ---------------------------------------------------------------------------
# BlockCOO algebra
# ---------------------------------------------------------------------------


def test_bcoo_algebra_vs_dense(rng):
    n, bs = 7, 2
    ia, ib = _rand_coo_inputs(rng, n, bs, 0.3), _rand_coo_inputs(rng, n, bs, 0.4)
    a, b = bcoo_coalesce(*ia, n, n, device="cpu"), bcoo_coalesce(*ib, n, n, device="cpu")
    ja, jb = jops.bcoo_coalesce(*ia, n, n), jops.bcoo_coalesce(*ib, n, n)
    _close_coo(a, ja, "coalesce")
    ad, bd = _np(bcoo_to_dense(a)), _np(bcoo_to_dense(b))
    _close(ad, jops.bcoo_to_dense(ja))
    x = rng.standard_normal((bs, n))
    xf = x.T.reshape(-1)
    y = bcoo_matvec(a, torch.from_numpy(x))
    _close(_np(y).T.reshape(-1), ad @ xf)
    _close(y, jops.bcoo_matvec(ja, jnp.asarray(x)))
    yt = bcoo_matvec_t(a, torch.from_numpy(x))
    _close(_np(yt).T.reshape(-1), ad.T @ xf)
    _close(yt, jops.bcoo_matvec_t(ja, jnp.asarray(x)))
    prod = bcoo_spgemm(a, b)
    _close(bcoo_to_dense(prod), ad @ bd)
    _close_coo(prod, jops.bcoo_spgemm(ja, jb), "spgemm")
    s = bcoo_add(a, b, beta=-2.0)
    _close(bcoo_to_dense(s), ad - 2.0 * bd)
    _close_coo(s, jops.bcoo_add(ja, jb, beta=-2.0), "add")
    d = _np(bcoo_diag_blocks(a))
    for k in range(n):
        np.testing.assert_array_equal(d[:, :, k], ad[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs])
    m = rng.standard_normal((bs, bs, n))
    md = np.zeros((n * bs, n * bs))
    for k in range(n):
        md[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = m[:, :, k]
    sc = bcoo_scale_cols(a, BlockDiag(torch.from_numpy(m)))
    _close(bcoo_to_dense(sc), ad @ md)
    _close_coo(sc, jops.bcoo_scale_cols(ja, jops.BlockDiag(jnp.asarray(m))), "scale_cols")
    assert a.rows.dtype == torch.int64 and a.block_size == bs and a.n_dof == n * bs
    # the row sums through the entry table equal index_add_'s on the CPU, bit for bit
    contrib = a.blocks[:, 0, :] * torch.from_numpy(x)[0, a.cols] + a.blocks[:, 1, :] * torch.from_numpy(x)[1, a.cols]
    assert torch.equal(y, torch.zeros_like(y).index_add_(1, a.rows, contrib))


def test_bcoo_from_bt_roundtrip():
    mesh, jmesh = _meshes(8)
    g, _, _ = dg_flux_operators(make_dg_mesh(mesh, 2), BoundaryCondition(*BC), C_DIR)
    coo = bcoo_from_bt(g)
    np.testing.assert_array_equal(_np(bcoo_to_dense(coo)), _np(bt_to_dense(g)))
    jg, _, _ = jdg_asm.dg_flux_operators(jdg_mesh.make_dg_mesh(jmesh, 2), JBC(*BC), C_DIR)
    _close_coo(coo, jops.bcoo_from_bt(jg))


# ---------------------------------------------------------------------------
# contiguous partitions: the scattered path == the AggMesh path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_agg", [0, 1])
def test_contiguous_scattered_matches_agg(p_agg):
    n = 12
    mesh, jmesh = _meshes(n)
    groups = [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9, 10, 11]]
    agg = make_agg_mesh(p_agg, mesh, partition=[3, 2, 4, 3])
    sa = make_scattered_agg_mesh(p_agg, mesh, groups)
    jsa = jsc_mesh.make_scattered_agg_mesh(p_agg, jmesh, groups)
    np.testing.assert_allclose(sa.boxes, agg.boxes, atol=1e-14)
    _close(sa.mass.blocks, agg.mass.blocks)
    _close(sa.mass_inv.blocks, jsa.mass_inv.blocks)
    bc = BoundaryCondition(("neu", 1.0), ("dir", 2.0))
    jbc = JBC(("neu", 1.0), ("dir", 2.0))
    ga, da, ca = agg_flux_operators(agg, bc, C_DIR)
    gs, ds, cs = scattered_flux_operators(sa, bc, C_DIR)
    for s, t, j in zip((gs, ds, cs), (ga, da, ca), jsc_asm.scattered_flux_operators(jsa, jbc, C_DIR)):
        np.testing.assert_allclose(_np(bcoo_to_dense(s)), _np(bt_to_dense(t)), atol=1e-13)
        _close_coo(s, j)
    func = lambda x: torch.sin(3.0 * x)  # noqa: E731
    fs, rs = scattered_flux_rhs(sa, func, bc, C_DIR)
    jfs, jrs = jsc_asm.scattered_flux_rhs(jsa, lambda x: jnp.sin(3.0 * x), jbc, C_DIR)
    _close(fs, jfs)
    _close(rs, jrs)
    a_s = scattered_schur(gs, ds, cs, sa.mass_inv)
    np.testing.assert_allclose(_np(bcoo_to_dense(a_s)), _np(bt_to_dense(schur_stiffness(ga, da, ca, agg.mass_inv))),
                               atol=1e-11)
    _close_coo(a_s, jsc_asm.scattered_schur(*jsc_asm.scattered_flux_operators(jsa, jbc, C_DIR), jsa.mass_inv))


def test_contiguous_scattered_prolong_matches_agg():
    mesh, jmesh = _meshes(12)
    dg = make_dg_mesh(mesh, 3)
    groups = [list(range(3 * c, 3 * c + 3)) for c in range(4)]
    l_sc = scattered_dg_interpolation(make_scattered_agg_mesh(1, mesh, groups), dg)
    l_agg = aggdg_dg_interpolation(make_agg_mesh(1, mesh, 3), dg)
    dense_agg = np.zeros((12 * 4, 4 * 2))
    for c in range(4):
        for j in range(3):
            f = 3 * c + j
            dense_agg[f * 4 : (f + 1) * 4, c * 2 : (c + 1) * 2] = _np(l_agg.blocks)[j, :, :, c]
    np.testing.assert_allclose(sp_dense(l_sc), dense_agg, atol=1e-13)
    jl = jsc_tr.scattered_dg_interpolation(jsc_mesh.make_scattered_agg_mesh(1, jmesh, groups),
                                           jdg_mesh.make_dg_mesh(jmesh, 3))
    _close(l_sc.blocks, jl.blocks)
    np.testing.assert_array_equal(_np(l_sc.cols), _np(jl.cols))


# ---------------------------------------------------------------------------
# non-contiguous partitions
# ---------------------------------------------------------------------------


def test_scattered_mesh_structure():
    mesh, jmesh = _meshes(12)
    sa = make_scattered_agg_mesh(1, mesh, INTERLEAVED)
    jsa = jsc_mesh.make_scattered_agg_mesh(1, jmesh, INTERLEAVED)
    assert sa.n_agg == 3 and not sa.is_contiguous
    np.testing.assert_allclose(sa.boxes[0], [0.0, 8.0 / 12.0], atol=1e-14)
    np.testing.assert_allclose(_np(sa.mass.blocks)[0, 0], 4.0 / 12.0, atol=1e-14)
    assert sa.n_interfaces == 5
    np.testing.assert_array_equal(sa.iface_left, [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(sa.iface_right, [1, 2, 0, 1, 2])
    for f in ("assign", "sub_assign", "boxes", "basis_q", "x_quad", "deriv_vals", "iface_x",
              "trace_left", "trace_right"):
        _close(getattr(sa, f), getattr(jsa, f), f)
    _close(sa.mass.blocks, jsa.mass.blocks)
    _close(sa.mass_inv.blocks, jsa.mass_inv.blocks)


@pytest.mark.parametrize(
    "n,groups",
    [
        (6, [[0, 1, 2], [2, 3, 4, 5]]),  # in two agglomerates
        (6, [[0, 1, 2], [4, 5]]),  # element 3 in none
        (6, [[0, 1, 2, 3, 4, 5], []]),  # empty
        (6, [[0, 1, 7], [2, 3, 4, 5]]),  # out of range
        (6, [[0, 1, 1, 2], [3, 4, 5]]),  # twice in one agglomerate
        (8, [[0, 1], [2, 3, 0, 1], [9], []]),  # the first offending group wins
        (8, [[0, 1, 2], [3, 3, 2], [4, 5, 6, 7]]),  # a group's own repeat is found before the overlap
    ],
)
def test_groups_validation(n, groups):
    """Invalid partitions raise the JAX package's ValueError, word for word."""
    mesh, jmesh = _meshes(n)
    with pytest.raises(ValueError) as want:
        jsc_mesh.make_scattered_agg_mesh(1, jmesh, groups)
    with pytest.raises(ValueError) as got:
        make_scattered_agg_mesh(1, mesh, groups)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("p_agg", [0, 1])
@pytest.mark.parametrize("bc", [BC, (("neu", 1.0), ("dir", 2.0))], ids=["dir-dir", "neu-dir"])
def test_noncontiguous_rediscretization_equals_galerkin(p_agg, bc):
    """Interface-list assembly == P^T (DG operator) P for G, D, C and the
    mass; both equal JAX's."""
    n = 12
    mesh, jmesh = _meshes(n)
    dg = make_dg_mesh(mesh, p_agg)
    sa = make_scattered_agg_mesh(p_agg, mesh, INTERLEAVED)
    jsa = jsc_mesh.make_scattered_agg_mesh(p_agg, jmesh, INTERLEAVED)
    jdg = jdg_mesh.make_dg_mesh(jmesh, p_agg)
    l, jl = scattered_dg_interpolation(sa, dg), jsc_tr.scattered_dg_interpolation(jsa, jdg)
    fine = dg_flux_operators(dg, BoundaryCondition(*bc), C_DIR)
    jfine = jdg_asm.dg_flux_operators(jdg, JBC(*bc), C_DIR)
    direct = scattered_flux_operators(sa, BoundaryCondition(*bc), C_DIR)
    for x_d, x_f, j_f in zip(direct, fine, jfine):
        proj = scattered_galerkin(l, x_f)
        np.testing.assert_allclose(_np(bcoo_to_dense(x_d)), _np(bcoo_to_dense(proj)), atol=1e-11)
        _close_coo(proj, jsc_tr.scattered_galerkin(jl, j_f))
    z = torch.zeros_like(dg.mass.blocks)
    m_proj = scattered_galerkin(l, bcoo_from_bt(BlockTridiag(z, dg.mass.blocks, z)))
    np.testing.assert_allclose(_np(bcoo_diag_blocks(m_proj)), _np(sa.mass.blocks), atol=1e-12)
    assert bool((m_proj.rows == m_proj.cols).all())


def test_scattered_switch_flip_matches_mirror():
    """Flipping every interface gives the mirror problem's spectrum; the
    flipped operators equal JAX's."""
    n = 8
    mesh, jmesh = _meshes(n)
    groups = [[0, 1, 4, 5], [2, 3, 6, 7]]
    sa_def = make_scattered_agg_mesh(1, mesh, groups)
    sw = np.zeros(sa_def.n_interfaces, dtype=bool)
    sa_flip = make_scattered_agg_mesh(1, mesh, groups, switch=sw)
    bc = BoundaryCondition(*BC)
    a0 = scattered_schur(*scattered_flux_operators(sa_def, bc, C_DIR), sa_def.mass_inv)
    a1 = scattered_schur(*scattered_flux_operators(sa_flip, bc, C_DIR), sa_flip.mass_inv)
    jsa = jsc_mesh.make_scattered_agg_mesh(1, jmesh, groups, switch=sw)
    _close_coo(a1, jsc_asm.scattered_schur(*jsc_asm.scattered_flux_operators(jsa, JBC(*BC), C_DIR), jsa.mass_inv))
    ev0 = np.sort_complex(np.linalg.eigvals(_np(bcoo_to_dense(a0))))
    ev1 = np.sort_complex(np.linalg.eigvals(_np(bcoo_to_dense(a1))))
    np.testing.assert_allclose(ev0, ev1, rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="one entry per interface"):
        make_scattered_agg_mesh(1, mesh, groups, switch=np.zeros(2, dtype=bool))


def test_scattered_prolong_restrict_adjoint(rng):
    mesh, jmesh = _meshes(12)
    l = scattered_dg_interpolation(make_scattered_agg_mesh(1, mesh, INTERLEAVED), make_dg_mesh(mesh, 2))
    jl = jsc_tr.scattered_dg_interpolation(jsc_mesh.make_scattered_agg_mesh(1, jmesh, INTERLEAVED),
                                           jdg_mesh.make_dg_mesh(jmesh, 2))
    pd = sp_dense(l)
    xc, rf = rng.standard_normal((2, 3)), rng.standard_normal((3, 12))
    up, down = sp_prolong(l, torch.from_numpy(xc)), sp_restrict(l, torch.from_numpy(rf))
    np.testing.assert_allclose(_np(up).T.reshape(-1), pd @ xc.T.reshape(-1), atol=1e-13)
    np.testing.assert_allclose(_np(down).T.reshape(-1), pd.T @ rf.T.reshape(-1), atol=1e-13)
    _close(up, jsc_tr.sp_prolong(jl, jnp.asarray(xc)))
    _close(down, jsc_tr.sp_restrict(jl, jnp.asarray(rf)))
    rft = torch.from_numpy(rf)
    contrib = sum(l.blocks[a, :, :] * rft[a] for a in range(3))
    assert torch.equal(down, torch.zeros_like(down).index_add_(1, l.cols, contrib))


def test_recursive_scattered_coarsening():
    mesh, jmesh = _meshes(12)
    pairs = [[2 * c, 2 * c + 1] for c in range(6)]
    sa1 = make_scattered_agg_mesh(1, mesh, pairs)
    sa2 = coarsen_scattered_agg_mesh(sa1, [[0, 3], [1, 4], [2, 5]])
    assert sa2.n_agg == 3
    np.testing.assert_array_equal(np.nonzero(sa2.assign == 0)[0], [0, 1, 6, 7])
    l = scattered_scattered_interpolation(sa2, sa1)
    jsa1 = jsc_mesh.make_scattered_agg_mesh(1, jmesh, pairs)
    jl = jsc_tr.scattered_scattered_interpolation(jsc_mesh.coarsen_scattered_agg_mesh(jsa1, [[0, 3], [1, 4], [2, 5]]),
                                                  jsa1)
    _close(l.blocks, jl.blocks)
    pd = sp_dense(l)
    for c in range(3):
        h = sa2.boxes[c, 1] - sa2.boxes[c, 0]
        xcen = 0.5 * (sa2.boxes[c, 0] + sa2.boxes[c, 1])
        coef = np.zeros((3, 2))
        coef[c] = [0.0, 1.0]
        fine_coef = (pd @ coef.reshape(-1)).reshape(6, 2)
        for f in np.nonzero(sa2.sub_assign == c)[0]:
            hf = sa1.boxes[f, 1] - sa1.boxes[f, 0]
            cf = 0.5 * (sa1.boxes[f, 0] + sa1.boxes[f, 1])
            x_test = cf + 0.3 * hf
            got = fine_coef[f, 0] + fine_coef[f, 1] * 2.0 * (x_test - cf) / hf
            np.testing.assert_allclose(got, 2.0 * (x_test - xcen) / h, atol=1e-13)
    with pytest.raises(ValueError, match="sub_assign does not index"):
        scattered_scattered_interpolation(sa2, make_scattered_agg_mesh(1, mesh, INTERLEAVED))


@pytest.mark.parametrize("n", [64, 4096])
def test_linear_time_coarsening_equals_jax(n):
    """The port's owner maps (one gather and one stable sort, no loop over
    agglomerates) equal the JAX package's for a random scattered first level,
    an interleaved merge and a merge from a contiguous ``AggMesh``."""
    rng = np.random.default_rng(n)
    mesh, jmesh = _meshes(n)
    perm = rng.permutation(n)
    first = [sorted(perm[i : i + 4].tolist()) for i in range(0, n, 4)]
    sa, jsa = make_scattered_agg_mesh(1, mesh, first), jsc_mesh.make_scattered_agg_mesh(1, jmesh, first)
    np.testing.assert_array_equal(sa.assign, jsa.assign)
    m = n // 4
    merge = rng.permutation(m).reshape(-1, 2).tolist()
    sa2, jsa2 = coarsen_scattered_agg_mesh(sa, merge), jsc_mesh.coarsen_scattered_agg_mesh(jsa, merge)
    for f in ("assign", "sub_assign", "iface_left", "iface_right"):
        np.testing.assert_array_equal(getattr(sa2, f), getattr(jsa2, f), err_msg=f)
    _close(sa2.mass.blocks, jsa2.mass.blocks)
    from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh

    agg = make_agg_mesh(1, mesh, 2, tables=False)
    merge_c = rng.permutation(n // 2).reshape(-1, 4).tolist()
    sa3 = coarsen_scattered_agg_mesh(agg, merge_c)
    jsa3 = jsc_mesh.coarsen_scattered_agg_mesh(jagg_mesh.make_agg_mesh(1, jmesh, 2, tables=False), merge_c)
    np.testing.assert_array_equal(sa3.assign, jsa3.assign)
    np.testing.assert_array_equal(sa3.sub_assign, jsa3.sub_assign)
    # a 2-d array of groups is the same partition as the lists
    np.testing.assert_array_equal(coarsen_scattered_agg_mesh(sa, np.asarray(merge)).assign, sa2.assign)


# ---------------------------------------------------------------------------
# end-to-end multigrid
# ---------------------------------------------------------------------------


def _interleaved_groups(n, run, m):
    groups = [[] for _ in range(m)]
    for start in range(0, n, run):
        groups[(start // run) % m].extend(range(start, min(start + run, n)))
    return groups


def _dg_problem(n=32):
    """Both packages' DG p = 1 problem of ``tests/test_scattered.py``."""
    mesh, jmesh = _meshes(n)
    bc, jbc = BoundaryCondition(*BC), JBC(*BC)
    c_dir = 10.0 * n
    dg, jdg = make_dg_mesh(mesh, 1), jdg_mesh.make_dg_mesh(jmesh, 1)
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    jg, jd, jc = jdg_asm.dg_flux_operators(jdg, jbc, c_dir)
    a, ja = schur_stiffness(g, d, c, dg.mass_inv), jhier.schur_stiffness(jg, jd, jc, jdg.mass_inv)
    f, r = dg_flux_rhs(dg, lambda x: torch.sin(2.0 * np.pi * x) * (2.0 * np.pi) ** 2, bc, c_dir)
    jf, jr = jdg_asm.dg_flux_rhs(jdg, lambda x: jnp.sin(2.0 * jnp.pi * x) * (2.0 * jnp.pi) ** 2, jbc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    jb = jf - jops.bt_matvec(jd, jops.bd_matvec(jdg.mass_inv, jr))
    _close(b, jb)
    return (mesh, dg, (a, g, d, c), b), (jmesh, jdg, (ja, jg, jd, jc), jb)


def _solve_pair(h, b, jh, jb, maxiter):
    """Float64 ``multigrid`` in both packages: equal counts, residual
    histories to rtol 1e-9 (plus 1e-12 of the first entry); the error
    histories, each against its own package's banded direct solve, to 1e-11
    of ``||A^-1 b||`` (at c_dir = 1000 n the iterates' rounding is
    amplified by the operator's conditioning; the two direct solutions
    differ by a few 1e-13 of their norm)."""
    from agglomerationmultigrid1d_tpu.ops.banded_solve import fine_direct_solve as jdirect

    from agglomerationmultigrid1d_tpu_torch.ops.banded_solve import fine_direct_solve

    res = multigrid(h, torch.zeros_like(b), b, maxiter, 1e-10)
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, maxiter, 1e-10)
    it = res.iterations
    assert it == int(jres.iterations), (it, int(jres.iterations))
    _history_close(res.res_history, jres.res_history, it)
    b_flat = _np(b).T.reshape(-1)
    u, ju = fine_direct_solve(h.levels[0], b_flat), jdirect(jh.levels[0], b_flat)
    assert np.linalg.norm(u - ju) <= 1e-12 * np.linalg.norm(u)
    got, want = _np(res.err_history)[:it], _np(jres.err_history)[:it]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11 * np.linalg.norm(u))
    return res


def test_contiguous_scattered_multigrid_iteration_parity():
    """A contiguous partition through the scattered machinery gives the
    AggMesh path's count and solution; both equal JAX's."""
    n = 32
    (mesh, dg, ops, b), (jmesh, jdg, jops_, jb) = _dg_problem(n)
    groups = [list(range(4 * i, 4 * i + 4)) for i in range(8)]
    h_ref = build_dg_hierarchy([dg, make_agg_mesh(1, mesh, 4, tables=False)], *ops)
    h_sc = build_dg_hierarchy([dg, make_scattered_agg_mesh(1, mesh, groups)], *ops)
    assert isinstance(h_sc.levels[1].a, BlockCOO) and isinstance(h_sc.transfers[0], ScatteredProlong)
    jh_sc = jhier.build_dg_hierarchy([jdg, jsc_mesh.make_scattered_agg_mesh(1, jmesh, groups)], *jops_)
    r_ref = multigrid(h_ref, torch.zeros_like(b), b, 100, 1e-10)
    r_sc = _solve_pair(h_sc, b, jh_sc, jb, 100)
    assert r_sc.iterations == r_ref.iterations
    np.testing.assert_allclose(_np(r_sc.x), _np(r_ref.x), rtol=1e-9, atol=1e-11)


def test_scattered_hierarchy_multigrid_converges():
    n = 32
    (mesh, dg, ops, b), (jmesh, jdg, jops_, jb) = _dg_problem(n)
    g1, g2 = _interleaved_groups(n, 2, 8), [[0, 1, 2, 3], [4, 5, 6, 7]]
    sa1 = make_scattered_agg_mesh(1, mesh, g1)
    sa2 = coarsen_scattered_agg_mesh(sa1, g2)
    assert not sa2.is_contiguous
    h = build_dg_hierarchy([dg, sa1, sa2], *ops)
    jsa1 = jsc_mesh.make_scattered_agg_mesh(1, jmesh, g1)
    jh = jhier.build_dg_hierarchy([jdg, jsa1, jsc_mesh.coarsen_scattered_agg_mesh(jsa1, g2)], *jops_)
    for k in (1, 2):
        _close_coo(h.levels[k].a, jh.levels[k].a, f"level {k}")
    res = _solve_pair(h, b, jh, jb, 150)
    assert res.iterations < 150
    x_dense = np.linalg.solve(_np(bt_to_dense(ops[0])), _np(b).T.reshape(-1))
    np.testing.assert_allclose(_np(res.x).T.reshape(-1), x_dense, rtol=1e-6, atol=1e-8)


def test_contiguous_below_scattered_rejected():
    n = 16
    mesh, _ = _meshes(n)
    dg = make_dg_mesh(mesh, 1)
    g, d, c = dg_flux_operators(dg, BoundaryCondition(*BC), C_DIR)
    a = schur_stiffness(g, d, c, dg.mass_inv)
    sa1 = make_scattered_agg_mesh(1, mesh, _interleaved_groups(n, 2, 4))
    with pytest.raises(TypeError, match="cannot follow a scattered"):
        build_dg_hierarchy([dg, sa1, make_agg_mesh(1, mesh, 8, tables=False)], a, g, d, c)


def test_poisson_scattered_hierarchy_factory():
    """The one-call constructor with its default interleaved partition: the
    JAX package's operators, count and history; the dense solution."""
    prob = poisson_scattered_hierarchy(n=64, device="cpu")
    jprob = jproblems.poisson_scattered_hierarchy(n=64, to_device=False)
    assert len(prob.meshes) == 2 and not prob.meshes[1].is_contiguous
    _close(prob.b, jprob.b)
    _close_coo(prob.hierarchy.levels[1].a, jprob.hierarchy.levels[1].a)
    res = _solve_pair(prob.hierarchy, prob.b, jprob.hierarchy, jprob.b, 200)
    x_dense = np.linalg.solve(_np(bt_to_dense(prob.hierarchy.levels[0].a)), _np(prob.b).T.reshape(-1))
    np.testing.assert_allclose(_np(res.x).T.reshape(-1), x_dense, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# chip_smoke.py's chain at a small size, and what only the port has
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,coarsest", [(16, 4), (2048, 256)])
def test_interleaved_pair_groups_partition_each_level(n, coarsest):
    """Interleaved pairs {4b, 4b+2}, {4b+1, 4b+3} of the elements, then
    merges {2c, 2c+1}: every level a partition of the one above, halving
    down to ``coarsest`` agglomerates."""
    groups = interleaved_pair_groups(n, coarsest)
    np.testing.assert_array_equal(groups[0][:2], [[0, 2], [1, 3]])
    m = n
    for g in groups:
        assert g.shape == (m // 2, 2)
        np.testing.assert_array_equal(np.sort(g.reshape(-1)), np.arange(m))
        m //= 2
    assert m == coarsest
    np.testing.assert_array_equal(groups[1][:2], [[0, 1], [2, 3]])


@pytest.fixture(scope="module")
def chain():
    """n = 2,048 DG p = 1 elements, interleaved pairs then two merges: three
    scattered levels down to 256 agglomerates; the port's problem and the
    JAX package's on the same partitions."""
    groups = interleaved_pair_groups(2048, 256)
    prob = poisson_scattered_hierarchy(n=2048, p_dg=1, groups_per_level=groups, device="cpu")
    jprob = jproblems.poisson_scattered_hierarchy(n=2048, p_dg=1, groups_per_level=[g.tolist() for g in groups],
                                                  to_device=False)
    return prob, jprob


def test_chain_float64_matches_jax(chain):
    prob, jprob = chain
    h = prob.hierarchy
    assert [type(lv.a).__name__ for lv in h.levels] == ["BlockTridiag"] + ["BlockCOO"] * 3
    for k in (1, 2, 3):
        _close_coo(h.levels[k].a, jprob.hierarchy.levels[k].a, f"level {k}")
    _solve_pair(h, prob.b, jprob.hierarchy, jprob.b, 100)


@pytest.mark.parametrize("cheb", [False, True], ids=["damped", "chebyshev"])
def test_chain_mixed_matches_jax(chain, cheb, monkeypatch):
    """``multigrid_mixed`` reaches 1e-10.  Smoothed as the JAX package's CPU
    branch smooths (A-form sweeps, ``u += S (b - A u)``: the fused kernels
    off) its counts are JAX's within 1 outer / 2 inner.  Through the kernels'
    M-form the inner count stays within 2, while the outer count follows the
    float32 rounding of the inner cycle (ROADMAP G16)."""
    prob, jprob = chain
    h, jh = prob.hierarchy, jprob.hierarchy
    if cheb:
        h, jh = chebyshev_hierarchy(h), jhier.chebyshev_hierarchy(jh)
    b, nb = prob.b, float(torch.linalg.vector_norm(prob.b))
    jres = jsolvers.multigrid_mixed(jh, jsolvers.make_low_precision_hierarchy(jh), jnp.zeros_like(jprob.b),
                                    jprob.b, 80, 1e-10, use_pallas=False)
    j_it, j_cyc = int(jres.iterations), int(jres.inner_cycles)
    h32 = make_low_precision_hierarchy(h)
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    assert float(torch.linalg.vector_norm(tsolvers.level_matvec(h.levels[0], res.x) - b)) < 1e-10 * nb
    assert abs(res.inner_cycles - j_cyc) <= 2, (res.inner_cycles, j_cyc)
    monkeypatch.setattr(tsolvers, "_on_kernels", lambda level, u: False)
    monkeypatch.setattr(tsolvers, "_level_matvec_opt", lambda level, x, group=None: tsolvers.level_matvec(level, x))
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    assert float(torch.linalg.vector_norm(tsolvers.level_matvec(h.levels[0], res.x) - b)) < 1e-10 * nb
    assert abs(res.iterations - j_it) <= 1 and abs(res.inner_cycles - j_cyc) <= 2, (
        (res.iterations, res.inner_cycles), (j_it, j_cyc))


def test_chain_kernels_only_at_the_fine_level(chain, monkeypatch):
    """In float32 the fused kernels' wrappers see the fine DG level's shape
    only; no block-COO level carries M-form streams or reaches a wrapper."""
    prob, _ = chain
    h32 = make_low_precision_hierarchy(chebyshev_hierarchy(prob.hierarchy))
    for lv in h32.levels[1:-1]:
        assert isinstance(lv.a, BlockCOO) and lv.smoother.base.ml is None
        assert lv.a.rows.dtype == torch.int64 and lv.a.blocks.dtype == torch.float32
    assert h32.transfers[1].cols.dtype == torch.int64
    seen = set()
    for name in ("multisweep", "multisweep_residual", "chebyshev_multisweep",
                 "chebyshev_multisweep_residual", "fused_bt_matvec"):
        def spy(*args, _fn=getattr(tsolvers, name), _name=name, **kw):
            seen.update((_name, tuple(t.shape)) for t in args if isinstance(t, torch.Tensor) and t.dim() == 2)
            return _fn(*args, **kw)

        monkeypatch.setattr(tsolvers, name, spy)
    b = prob.b.to(torch.float32)
    tsolvers.v_cycle(h32, torch.zeros_like(b), b)
    names = {n for n, _ in seen}
    assert {"chebyshev_multisweep", "chebyshev_multisweep_residual"} <= names
    assert {shape for _, shape in seen} == {(2, 2048)}


def test_chain_progressive_refuses_block_coo(chain):
    """The progressive cycles need float-float level operators, which a
    block-COO level does not have (nor in the JAX package): a clear error."""
    prob, _ = chain
    h = prob.hierarchy
    with pytest.raises(TypeError, match="block-COO"):
        multigrid_progressive(h, make_low_precision_hierarchy(h), torch.zeros_like(prob.b), prob.b, 5, 1e-10)


def test_hierarchy_from_numpy_carries_scattered_and_penta_levels(chain):
    """``hierarchy_from_numpy`` on the JAX package's scattered hierarchy (and
    on a pentadiagonal one with a padded coarse solver) equals the port's
    own build, leaf for leaf."""
    from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh

    from agglomerationmultigrid1d_tpu_torch.models import build_dg_hierarchy as tbuild
    from agglomerationmultigrid1d_tpu_torch.ops import PaddedBTCoarseSolver, bp5_to_dense, coarse_solve
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_map

    prob, jprob = chain
    conv = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jprob.hierarchy), device="cpu")

    def leaves(tree):
        out = []
        tree_map(out.append, tree)
        return out

    def same(x, y):
        got, want = leaves(x), leaves(y)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.numel():
                _close(g, w)

    same(conv, prob.hierarchy)
    # pentadiagonal levels and an odd coarsest level of 1,025 blocks (padded)
    n = 4100
    s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
    bcs = (("neu", 0.0), ("dir", 1.0))
    mesh, jmesh = _meshes(n)
    tm = [make_dg_mesh(mesh, 1, switch=s), make_agg_mesh(1, mesh, 4, tables=False)]
    jm = [jdg_mesh.make_dg_mesh(jmesh, 1, switch=s), jagg_mesh.make_agg_mesh(1, jmesh, 4, tables=False)]
    g, d, c = dg_flux_operators(tm[0], BoundaryCondition(*bcs), 1000.0 * n)
    h = tbuild(tm, schur_stiffness(g, d, c, tm[0].mass_inv, mixed_switch=True), g, d, c)
    jg, jd, jc = jdg_asm.dg_flux_operators(jm[0], JBC(*bcs), 1000.0 * n)
    jh = jhier.build_dg_hierarchy(jm, jhier.schur_stiffness(jg, jd, jc, jm[0].mass_inv, mixed_switch=True),
                                  jg, jd, jc)
    conv = hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jh), device="cpu")
    same(conv._replace(coarse=None), h._replace(coarse=None))
    assert isinstance(conv.coarse, PaddedBTCoarseSolver) and conv.coarse.n_dof == 2050
    # the factors are held through the solve they perform: the converted
    # ones, the port's own and JAX's (outside jit) against the dense solve,
    # to its own test's 1e-8 (the penalty's conditioning amplifies the
    # rounding of the factorization), and to each other to 1e-10 of max|x|
    rhs = np.random.default_rng(3).standard_normal(2050)
    x_ref = np.linalg.solve(_np(bp5_to_dense(h.levels[-1].a)), rhs)
    x = coarse_solve(conv.coarse, torch.from_numpy(rhs))
    for got in (x, coarse_solve(h.coarse, torch.from_numpy(rhs)), jops.coarse_solve(jh.coarse, jnp.asarray(rhs))):
        np.testing.assert_allclose(_np(got), x_ref, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(_np(got), _np(x), rtol=0, atol=1e-10 * np.abs(x_ref).max())


def test_precision_keeps_index_tensors(chain):
    prob, _ = chain
    h32 = hierarchy_astype(prob.hierarchy, torch.float32)
    lv = h32.levels[1]
    assert lv.a.rows.dtype == torch.int64 and lv.g.cols.dtype == torch.int64
    assert lv.a.blocks.dtype == torch.float32 and lv.a.n_rows == prob.hierarchy.levels[1].a.n_rows
    assert h32.transfers[0].cols.dtype == torch.int64 and h32.transfers[0].n_coarse == 1024


def test_shard_hierarchy_refuses_block_coo_levels(chain):
    """A block-COO level shards by block rows: on a fake two-rank group each
    rank holds its rows' entries, numbered from 0, with the plan of the
    columns they read (global ones in ``halo.need``, the rest of the rank's
    own first), so its matvec on the gathered columns is the whole
    operator's rows of the rank; the plans' index tensors stay int64 through
    ``hierarchy_astype``."""
    from agglomerationmultigrid1d_tpu_torch.ops import bcoo_matvec
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy
    from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype

    prob, _ = chain
    h = prob.hierarchy
    rng = np.random.default_rng(7)
    for rank in range(2):
        g = SolverGroup(group=None, rank=rank, world=2, device=torch.device("cpu"), backend="gloo")
        hs = shard_hierarchy(h, g)
        assert hs.layout.sharded == (True, True, True, True)[: h.n_levels - 1] + (False,)
        h32 = hierarchy_astype(hs, torch.float32)
        for k in range(1, h.n_levels - 1):
            a, whole = hs.levels[k].a, h.levels[k].a
            n = whole.n_rows
            lo, hi = rank * n // 2, (rank + 1) * n // 2
            x = torch.from_numpy(rng.standard_normal((whole.block_size, n)))
            assert a.n_rows == hi - lo and a.n_cols == a.halo.n_need
            assert torch.equal(a.halo.need[a.halo.own_pos] - lo, a.halo.own_idx)
            assert torch.equal(bcoo_matvec(a, x[:, a.halo.need]), bcoo_matvec(whole, x)[:, lo:hi])
            a32 = h32.levels[k].a
            assert a32.blocks.dtype == torch.float32
            assert all(t.dtype == torch.int64 for t in (a32.rows, a32.cols, a32.ell, a32.halo.need, *a32.halo.send))
