"""The torch port's mixed-switch (block-pentadiagonal) family and graded
meshes against the JAX package's, on the CPU in float64.

The counterparts of ``tests/test_penta.py`` (the pentadiagonal product,
matvec, pair-merge, the pair-merged cyclic-reduction coarse solve, trapping
switches, the truncation guard, the agglomerated switch, the float-float
defect, the mixed-switch hierarchies and their solvers), of the switch tests
of ``tests/test_nonuniform.py`` and of its graded-mesh builds and solves.
Each holds the port to the JAX package on the same seeded NumPy inputs:
operators to 1e-12 of their largest entry, float64 ``multigrid`` counts
equal with histories to rtol 1e-9 (plus 1e-12 of the first entry), mixed and
progressive counts within 1 outer / 2 inner.  Then what only the port has: a
float32 pentadiagonal chain that never reaches a fused kernel, an odd-count
pentadiagonal coarsest level above the dense cap
(``PaddedBTCoarseSolver``) against the banded direct solve, and
``shard_hierarchy`` refusing pentadiagonal levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu import ops as jops
from agglomerationmultigrid1d_tpu.assembly import agg_assembly as jagg_asm
from agglomerationmultigrid1d_tpu.assembly import cg_assembly as jcg_asm
from agglomerationmultigrid1d_tpu.assembly import dg_assembly as jdg_asm
from agglomerationmultigrid1d_tpu.mesh import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh import topology as jtopo
from agglomerationmultigrid1d_tpu.models import hierarchy as jhier
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.ops import df64 as jdf64
from agglomerationmultigrid1d_tpu.transfer import interpolation as jint
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.assembly import agg_flux_operators, dg_flux_operators, dg_flux_rhs
from agglomerationmultigrid1d_tpu_torch.assembly.agg_assembly import _closed_form_traces
from agglomerationmultigrid1d_tpu_torch.assembly.cg_assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.assembly.dg_assembly import _volume_ref
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_graded_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    build_dg_hierarchy,
    build_hierarchy,
    build_problem,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    multigrid_progressive,
    poisson_switch_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d_tpu_torch.models import solvers as tsolvers
from agglomerationmultigrid1d_tpu_torch.ops import (
    BlockPenta,
    BlockTridiag,
    PaddedBTCoarseSolver,
    bd_matvec,
    bd_mul_bt,
    bp5_matvec,
    bp5_pair_merge,
    bp5_to_dense,
    bt_matvec,
    bt_mul_bt,
    bt_mul_bt_full,
    bt_sub,
    bt_to_dense,
    cg_to_dense,
    coarse_solve,
    make_penta_coarse_solver,
)
from agglomerationmultigrid1d_tpu_torch.ops import df64 as tdf64
from agglomerationmultigrid1d_tpu_torch.ops.banded_solve import (
    _banded_matvec,
    _inv_norm1_estimate,
    fine_banded_ab,
    fine_direct_solve,
    fine_refined_solve,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag
from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
from agglomerationmultigrid1d_tpu_torch.parallel.multihost import SolverGroup
from agglomerationmultigrid1d_tpu_torch.transfer import interpolation as tint
from agglomerationmultigrid1d_tpu_torch.utils import HierarchySpec

RTOL = 1e-12
BC_NEU_DIR = (("neu", 0.0), ("dir", 1.0))
BC_GRADED = (("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what="", scale=None):
    """To 1e-12 of ``want``'s largest entry (or of ``scale``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    s = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * s, err_msg=what)


def _close_ops(got, want, what=""):
    for k, (x, y) in enumerate(zip(got, want)):
        _close(x, y, f"{what}[{k}]", scale=max(float(np.abs(_np(y)).max()), 1e-300))


def _random_bt_np(bs: int, n: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    lower = rng.standard_normal((bs, bs, n))
    diag = rng.standard_normal((bs, bs, n)) + 3.0 * bs * np.eye(bs)[:, :, None]
    upper = rng.standard_normal((bs, bs, n))
    lower[:, :, 0] = 0.0
    upper[:, :, -1] = 0.0
    return lower, diag, upper


def _bt_pair(bs, n, seed):
    arrs = _random_bt_np(bs, n, seed)
    return BlockTridiag(*(torch.from_numpy(a) for a in arrs)), jops.BlockTridiag(*(jnp.asarray(a) for a in arrs))


def _penta_pair(bs, n, s1, s2):
    (ta, ja), (tb, jb) = _bt_pair(bs, n, s1), _bt_pair(bs, n, s2)
    return bt_mul_bt_full(ta, tb), jops.bt_mul_bt_full(ja, jb)


def _history_close(got, want, it):
    got, want = _np(got)[:it], _np(want)[:it]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * abs(want[0]))


# ---------------------------------------------------------------------------
# the pentadiagonal algebra (tests/test_penta.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,n", [(1, 5), (2, 8), (4, 13)])
def test_bt_mul_bt_full_matches_dense(bs, n):
    (ta, ja), (tb, jb) = _bt_pair(bs, n, 1), _bt_pair(bs, n, 2)
    p = bt_mul_bt_full(ta, tb)
    _close(bp5_to_dense(p), _np(bt_to_dense(ta)) @ _np(bt_to_dense(tb)))
    _close_ops(p, jops.bt_mul_bt_full(ja, jb), "bt_mul_bt_full")


@pytest.mark.parametrize("bs,n", [(2, 9), (4, 12)])
def test_bp5_matvec_matches_dense(bs, n):
    p, jp = _penta_pair(bs, n, 3, 4)
    x = np.random.default_rng(5).standard_normal((bs, n))
    y = bp5_matvec(p, torch.from_numpy(x))
    _close(y, (_np(bp5_to_dense(p)) @ x.T.reshape(-1)).reshape(n, bs).T)
    _close(y, jops.bp5_matvec(jp, jnp.asarray(x)))


@pytest.mark.parametrize("n", [8, 13])  # even and odd block counts
def test_bp5_pair_merge_matches_dense(n):
    p, jp = _penta_pair(2, n, 6, 7)
    merged = bp5_pair_merge(p)
    dense = _np(bt_to_dense(merged))
    nd = n * 2
    _close(dense[:nd, :nd], bp5_to_dense(p))
    if dense.shape[0] > nd:  # odd n: inert identity padding
        np.testing.assert_array_equal(dense[nd:, nd:], np.eye(dense.shape[0] - nd))
        np.testing.assert_array_equal(dense[nd:, :nd], 0.0)
        np.testing.assert_array_equal(dense[:nd, nd:], 0.0)
    for got, want in zip(merged, jops.bp5_pair_merge(jp)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("n", [64, 65, 1001])  # even, odd (PaddedBTCoarseSolver), odd and wide
def test_penta_coarse_solver(n):
    p, jp = _penta_pair(2, n, 8, 9)
    s = make_penta_coarse_solver(p)
    assert isinstance(s, PaddedBTCoarseSolver) == bool(n % 2)
    b = np.random.default_rng(10).standard_normal(2 * n)
    x = coarse_solve(s, torch.from_numpy(b))
    x_ref = np.linalg.solve(_np(bp5_to_dense(p)), b)
    np.testing.assert_allclose(_np(x), x_ref, rtol=1e-8, atol=1e-8)
    # JAX's solver, outside jit as its own test calls it
    jx = jops.coarse_solve(jops.make_penta_coarse_solver(jp), jnp.asarray(b))
    _close(x, jx)


def _mixed_problem(n=32, p=3):
    """The False-run then True-run switch of ``tests/test_penta.py``: mixed
    and nonsingular (no (True, False) pair, so no element is u-trapped and
    the distance-2 blocks come out zero; the trapped case below has them);
    both packages' operators."""
    switch = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2), dtype=bool)
    c_dir = 1000.0 * n
    mesh, jmesh = create_uniform_mesh(n, 0.0, 1.0), jtopo.create_uniform_mesh(n, 0.0, 1.0)
    dg, jdg = make_dg_mesh(mesh, p, switch=switch), jdg_mesh.make_dg_mesh(jmesh, p, switch=switch)
    bc, jbc = BoundaryCondition(*BC_NEU_DIR), JBC(*BC_NEU_DIR)
    ops = dg_flux_operators(dg, bc, c_dir)
    jops_ = jdg_asm.dg_flux_operators(jdg, jbc, c_dir)
    for k, (x, y) in enumerate(zip(ops, jops_)):
        _close_ops(x, y, f"flux operator {k}")
    return (mesh, dg, bc, ops), (jmesh, jdg, jbc, jops_), c_dir


def test_trapping_switch_rejected():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    switch = np.array([True, True, True, False, True, True, True])
    with pytest.raises(ValueError, match="u-traps element"):
        make_dg_mesh(mesh, 2, switch=switch)
    assert make_dg_mesh(mesh, 2, switch=switch, allow_trapped=True).u_hat_left is not None


def test_trapped_switch_schur_matches_dense_and_is_singular():
    n, p = 16, 3
    switch = np.array([True] * 7 + [False] + [True] * 7)
    mesh, jmesh = create_uniform_mesh(n, 0.0, 1.0), jtopo.create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, p, switch=switch, allow_trapped=True)
    jdg = jdg_mesh.make_dg_mesh(jmesh, p, switch=switch, allow_trapped=True)
    g, d, c = dg_flux_operators(dg, BoundaryCondition(*BC_NEU_DIR), 1000.0 * n)
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    assert isinstance(a, BlockPenta)
    jg, jd, jc = jdg_asm.dg_flux_operators(jdg, JBC(*BC_NEU_DIR), 1000.0 * n)
    _close_ops(a, jhier.schur_stiffness(jg, jd, jc, jdg.mass_inv, mixed_switch=True), "penta A")
    m_inv = np.zeros((n * (p + 1),) * 2)
    for k in range(n):
        m_inv[k * (p + 1) : (k + 1) * (p + 1), k * (p + 1) : (k + 1) * (p + 1)] = _np(dg.mass_inv.blocks)[:, :, k]
    dense_ref = _np(bt_to_dense(c)) - _np(bt_to_dense(d)) @ (m_inv @ _np(bt_to_dense(g)))
    a_dense = _np(bp5_to_dense(a))
    scale = np.abs(dense_ref).max()
    np.testing.assert_allclose(a_dense, dense_ref, atol=1e-12 * scale)
    assert float(a.lower2.abs().max() + a.upper2.abs().max()) > 1e-6 * scale
    ev = np.linalg.eigvalsh(0.5 * (a_dense + a_dense.T))
    assert abs(ev).min() < 1e-10 * scale


def test_mixed_switch_hierarchy_rejects_truncated_a():
    (mesh, dg, bc, (g, d, c)), _, _ = _mixed_problem()
    a_truncated = bt_sub(c, bt_mul_bt(d, bd_mul_bt(dg.mass_inv, g)))
    meshes = [dg, make_dg_mesh(mesh, 1, switch=dg.u_hat_left)]
    with pytest.raises(ValueError, match="PENTA"):
        build_dg_hierarchy(meshes, a_truncated, g, d, c)


def test_agg_explicit_switch_entrywise():
    """The agglomerated level's explicit switch mirrors the flux couplings at
    flipped vertices; every operator equals the JAX package's."""
    n, m = 16, 8
    mesh, jmesh = create_uniform_mesh(n, 0.0, 1.0), jtopo.create_uniform_mesh(n, 0.0, 1.0)
    bc, jbc = BoundaryCondition(*BC_NEU_DIR), JBC(*BC_NEU_DIR)
    sw = np.array([False] * 4 + [True] * 3)
    agg_def, agg_mix = make_agg_mesh(1, mesh, 2), make_agg_mesh(1, mesh, 2, switch=sw)
    assert agg_mix.u_hat_left is not None
    assert make_agg_mesh(1, mesh, 2, switch=np.ones(m - 1, bool)).u_hat_left is None
    with pytest.raises(ValueError, match="u-traps"):
        make_agg_mesh(1, mesh, 2, switch=np.array([True] * 3 + [False] * 4))
    g0, d0, _ = agg_flux_operators(agg_def, bc, 100.0)
    gm, dm, cm = agg_flux_operators(agg_mix, bc, 100.0)
    jgm, jdm, jcm = jagg_asm.agg_flux_operators(jagg_mesh.make_agg_mesh(1, jmesh, 2, switch=sw), jbc, 100.0)
    for x, y, nm in ((gm, jgm, "G"), (dm, jdm, "D"), (cm, jcm, "C")):
        _close_ops(x, y, nm)
    _, bl, br = _closed_form_traces(agg_def)
    gl, gu, dl, du = (_np(t) for t in (gm.lower, gm.upper, dm.lower, dm.upper))
    for v in range(m - 1):
        if sw[v]:
            np.testing.assert_array_equal(gl[:, :, v + 1], _np(g0.lower)[:, :, v + 1])
            np.testing.assert_array_equal(du[:, :, v], _np(d0.upper)[:, :, v])
            assert np.all(gu[:, :, v] == 0.0)
        else:
            np.testing.assert_allclose(gu[:, :, v], -np.outer(br[v], bl[v + 1]))
            np.testing.assert_allclose(dl[:, :, v + 1], np.outer(bl[v + 1], br[v]))
            assert np.all(gl[:, :, v + 1] == 0.0) and np.all(du[:, :, v] == 0.0)


def test_agg_mixed_switch_solves_to_direct():
    """A CG -> agg hierarchy whose agglomerated seam has a mixed switch:
    pentadiagonal there, the float64 ``multigrid`` count and history equal
    to the JAX package's, converged to 1e-10."""
    n = 32
    m = n // 4
    sw = np.array([False] * (m // 2) + [True] * (m - 1 - m // 2))
    mesh, jmesh = create_uniform_mesh(n, 0.0, 1.0), jtopo.create_uniform_mesh(n, 0.0, 1.0)
    bc, jbc = BoundaryCondition(*BC_NEU_DIR), JBC(*BC_NEU_DIR)
    cg, jcg = make_cg_mesh(mesh, 1), jcg_mesh.make_cg_mesh(jmesh, 1)
    a, b = cg_stiffness_and_rhs(cg, torch.cos, bc)
    h = build_hierarchy([cg, make_agg_mesh(1, mesh, 4, switch=sw, tables=False)], bc, a, c_dir=1000.0 * n)
    assert isinstance(h.levels[1].a, BlockPenta)
    ja, jb = jcg_asm.cg_stiffness_and_rhs(jcg, jnp.cos, jbc)
    jh = jhier.build_hierarchy([jcg, jagg_mesh.make_agg_mesh(1, jmesh, 4, switch=sw, tables=False)], jbc, ja,
                               c_dir=1000.0 * n)
    _close_ops(h.levels[1].a, jh.levels[1].a, "seam A")
    res = multigrid(h, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, 100, 1e-10, compute_error=False)
    assert res.iterations == int(jres.iterations)
    _history_close(res.res_history, jres.res_history, res.iterations)
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * float(torch.linalg.vector_norm(b))


def test_penta_ff_defect_matches_f64():
    """``ff_bp5_defect`` equals the JAX package's (run op by op, as its
    fenced chain runs on the TPU) bit for bit, and is ~2^-48-accurate
    against the float64 defect."""
    p, jp = _penta_pair(4, 300, 11, 12)
    rng = np.random.default_rng(13)
    x, b = rng.standard_normal((4, 300)), rng.standard_normal((4, 300))
    r64 = b - _np(bp5_matvec(p, torch.from_numpy(x)))
    r = tdf64.ff_defect(tdf64.bp5_split(p), tdf64.ff_split(torch.from_numpy(x)), tdf64.ff_split(torch.from_numpy(b)))
    jr = jdf64.ff_defect(jdf64.bp5_split(jp), jdf64.ff_split(jnp.asarray(x)), jdf64.ff_split(jnp.asarray(b)))
    np.testing.assert_array_equal(_np(r.hi), _np(jr.hi))
    np.testing.assert_array_equal(_np(r.lo), _np(jr.lo))
    scale = np.abs(r64).max() + np.abs(b).max()
    assert np.abs(_np(tdf64.ff_join(r)) - r64).max() < 1e-12 * scale


def _mixed_hierarchies(n=32):
    (mesh, dg, bc, (g, d, c)), (jmesh, jdg, jbc, (jg, jd, jc)), c_dir = _mixed_problem(n)
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    h = build_dg_hierarchy([dg, make_dg_mesh(mesh, 1, switch=dg.u_hat_left)], a, g, d, c)
    ja = jhier.schur_stiffness(jg, jd, jc, jdg.mass_inv, mixed_switch=True)
    jh = jhier.build_dg_hierarchy([jdg, jdg_mesh.make_dg_mesh(jmesh, 1, switch=jdg.u_hat_left)], ja, jg, jd, jc)
    f, r = dg_flux_rhs(dg, torch.cos, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    jf, jr = jdg_asm.dg_flux_rhs(jdg, jnp.cos, jbc, c_dir)
    jb = jf - jops.bt_matvec(jd, jops.bd_matvec(jdg.mass_inv, jr))
    _close(b, jb)
    for k, (lv, jlv) in enumerate(zip(h.levels, jh.levels)):
        _close_ops(lv.a, jlv.a, f"level {k} A")
    return h, b, jh, jb


@pytest.mark.parametrize("solver", ["mixed", "progressive"])
def test_mixed_switch_progressive_and_mixed_solvers(solver):
    """Both mixed-precision solvers take a pentadiagonal fine level end to
    end, with the JAX package's counts (within 1 outer / 2 inner)."""
    h, b, jh, jb = _mixed_hierarchies()
    port = {"mixed": multigrid_mixed, "progressive": multigrid_progressive}[solver]
    jfn = {"mixed": jsolvers.multigrid_mixed, "progressive": jsolvers.multigrid_progressive}[solver]
    res = port(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    jres = jfn(jh, jsolvers.make_low_precision_hierarchy(jh), jnp.zeros_like(jb), jb, 80, 1e-10, use_pallas=False)
    nb = float(torch.linalg.vector_norm(b))
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * nb
    assert float(torch.linalg.vector_norm(bp5_matvec(h.levels[0].a, res.x) - b)) < 1e-10 * nb
    assert abs(res.iterations - int(jres.iterations)) <= 1, (res.iterations, int(jres.iterations))
    assert abs(res.inner_cycles - int(jres.inner_cycles)) <= 2, (res.inner_cycles, int(jres.inner_cycles))


def test_mixed_switch_hierarchy_solves_to_direct():
    """p 3 -> 1 with a mixed switch: float64 ``multigrid`` equal to the JAX
    package's (count, residual and error histories), the solution equal to
    the dense direct solve of the pentadiagonal A."""
    h, b, jh, jb = _mixed_hierarchies()
    res = multigrid(h, torch.zeros_like(b), b, 100, 1e-10)
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, 100, 1e-10)
    it = res.iterations
    assert it == int(jres.iterations)
    _history_close(res.res_history, jres.res_history, it)
    _history_close(res.err_history, jres.err_history, it)
    nb = float(torch.linalg.vector_norm(b))
    assert float(res.res_history[it - 1]) < 1e-10 * nb
    x_direct = np.linalg.solve(_np(bp5_to_dense(h.levels[0].a)), _np(b).T.reshape(-1))
    np.testing.assert_allclose(_np(res.x).T.reshape(-1), x_direct, atol=1e-8 * np.abs(x_direct).max())
    err = _np(res.err_history)[:it]
    assert np.all(np.isfinite(err)) and err[-1] <= err[0]


# ---------------------------------------------------------------------------
# the explicit switch on graded meshes (tests/test_nonuniform.py)
# ---------------------------------------------------------------------------


def _graded(n, ratio=2.0):
    return create_graded_mesh(n, 0.0, 1.0, ratio=ratio), jtopo.create_graded_mesh(n, 0.0, 1.0, ratio=ratio)


def test_switch_all_default_matches_plain():
    mesh, jmesh = _graded(8)
    d0 = make_dg_mesh(mesh, 2)
    d1 = make_dg_mesh(mesh, 2, switch=np.ones(7, dtype=bool))
    assert d1.u_hat_left is None
    bc = BoundaryCondition(*BC_GRADED)
    jops_ = jdg_asm.dg_flux_operators(jdg_mesh.make_dg_mesh(jmesh, 2), JBC(*BC_GRADED), 8.0)
    for x0, x1, jx in zip(dg_flux_operators(d0, bc, 8.0), dg_flux_operators(d1, bc, 8.0), jops_):
        np.testing.assert_array_equal(_np(bt_to_dense(x0)), _np(bt_to_dense(x1)))
        _close_ops(x1, jx)


def test_switch_flip_swaps_g_and_d_interior():
    """Flipping every vertex swaps the interior couplings of G and D."""
    mesh, jmesh = _graded(8)
    bc_nn = BoundaryCondition(("neu", 0.0), ("neu", 0.0))
    p = 2
    d0, d1 = make_dg_mesh(mesh, p), make_dg_mesh(mesh, p, switch=np.zeros(7, dtype=bool))
    g0, dd0, _ = dg_flux_operators(d0, bc_nn, 0.0)
    g1, dd1, _ = dg_flux_operators(d1, bc_nn, 0.0)
    jg1, jdd1, _ = jdg_asm.dg_flux_operators(
        jdg_mesh.make_dg_mesh(jmesh, p, switch=np.zeros(7, dtype=bool)), JBC(("neu", 0.0), ("neu", 0.0)), 0.0)
    _close_ops(g1, jg1, "G")
    _close_ops(dd1, jdd1, "D")
    vol = np.zeros((p + 1, p + 1, 8)) + _volume_ref(d0)[:, :, None]
    gb = vol.copy()
    gb[0, 0, 0] += 1.0
    gb[1, 1, -1] += -1.0
    z = torch.zeros_like(g0.diag)
    dense = lambda blocks: _np(bt_to_dense(BlockTridiag(z, torch.from_numpy(blocks), z)))  # noqa: E731
    np.testing.assert_allclose(_np(bt_to_dense(g1)) - dense(gb), _np(bt_to_dense(dd0)) - dense(vol), atol=1e-14)
    np.testing.assert_allclose(_np(bt_to_dense(dd1)) - dense(vol), _np(bt_to_dense(g0)) - dense(gb), atol=1e-14)


def _dense_dg_solution(dg, g, d, c, f, r):
    md = np.zeros((dg.n_elements * (dg.p + 1),) * 2)
    bs = dg.p + 1
    for k in range(dg.n_elements):
        md[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = _np(dg.mass.blocks)[:, :, k]
    gd, dd, cd = (_np(bt_to_dense(t)) for t in (g, d, c))
    a = cd - dd @ np.linalg.solve(md, gd)
    rhs = _np(f).T.reshape(-1) - dd @ np.linalg.solve(md, _np(r).T.reshape(-1))
    return np.linalg.solve(a, rhs).reshape(dg.n_elements, bs).T


def _dg_l2_error(dg, u):
    from agglomerationmultigrid1d_tpu_torch.numerics import evaluate_nodal_basis, gauss_quad

    qx, qw = gauss_quad(2 * dg.p + 2)
    basis = np.asarray(evaluate_nodal_basis(dg.ref.basis_coeff, qx))
    err2 = 0.0
    for k in range(dg.mesh.n_elements):
        xq = dg.mesh.centers[k] + dg.mesh.jacobians[k] * qx
        err2 += dg.mesh.jacobians[k] * np.sum(qw * (np.cos(xq) - basis @ u[:, k]) ** 2)
    return np.sqrt(err2)


def test_switch_flipped_solution_converges():
    """The uniformly flipped switch is the mirror LDG scheme: the same
    convergence order, and the JAX package's operators and rhs."""
    errs, ns = [], [8, 16, 32]
    bc, jbc = BoundaryCondition(*BC_GRADED), JBC(*BC_GRADED)
    for n in ns:
        mesh, jmesh = _graded(n)
        flip = np.zeros(n - 1, dtype=bool)
        dg, jdg = make_dg_mesh(mesh, 2, switch=flip), jdg_mesh.make_dg_mesh(jmesh, 2, switch=flip)
        g, d, c = dg_flux_operators(dg, bc, 1.0 * n)
        f, r = dg_flux_rhs(dg, torch.cos, bc, 1.0 * n)
        for x, y in zip((g, d, c), jdg_asm.dg_flux_operators(jdg, jbc, 1.0 * n)):
            _close_ops(x, y)
        jf, jr = jdg_asm.dg_flux_rhs(jdg, jnp.cos, jbc, 1.0 * n)
        _close(f, jf)
        _close(r, jr)
        errs.append(_dg_l2_error(dg, _dense_dg_solution(dg, g, d, c, f, r)))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 3.0) < 0.5, (slope, errs)


def test_switch_mixed_entrywise():
    """Every interior-vertex coupling of the mixed operators is the default
    (True) or the flipped (False) scalar stencil, and equals JAX's."""
    n, p = 8, 1
    mesh, jmesh = _graded(n)
    bc_nn = BoundaryCondition(("neu", 0.0), ("neu", 0.0))
    sw = (np.arange(n - 1) % 2).astype(bool)
    g, d, _ = dg_flux_operators(make_dg_mesh(mesh, p, switch=sw, allow_trapped=True), bc_nn, 0.0)
    jg, jd, _ = jdg_asm.dg_flux_operators(
        jdg_mesh.make_dg_mesh(jmesh, p, switch=sw, allow_trapped=True), JBC(("neu", 0.0), ("neu", 0.0)), 0.0)
    _close_ops(g, jg, "G")
    _close_ops(d, jd, "D")
    gl, gdg, gu, dl, ddg, du = (_np(t) for t in (g.lower, g.diag, g.upper, d.lower, d.diag, d.upper))
    vol = _volume_ref(make_dg_mesh(mesh, p))
    for v in range(n - 1):
        if sw[v]:
            assert gl[0, 1, v + 1] == 1.0 and gdg[1, 1, v] - vol[1, 1] == -1.0
            assert ddg[0, 0, v + 1] - vol[0, 0] == 1.0 and du[1, 0, v] == -1.0
            assert gu[1, 0, v] == 0.0 and dl[0, 1, v + 1] == 0.0
        else:
            assert gdg[0, 0, v + 1] - vol[0, 0] == 1.0 and gu[1, 0, v] == -1.0
            assert ddg[1, 1, v] - vol[1, 1] == -1.0 and dl[0, 1, v + 1] == 1.0
            assert gl[0, 1, v + 1] == 0.0 and du[1, 0, v] == 0.0


# ---------------------------------------------------------------------------
# graded meshes: builds and solves (tests/test_nonuniform.py, ROADMAP 14 (d))
# ---------------------------------------------------------------------------


def test_cg_convergence_on_graded_mesh():
    """CG p = 3 on meshes stretched 4x: order ~4, and the port's operator,
    rhs and solution equal JAX's."""
    from agglomerationmultigrid1d_tpu_torch.numerics import evaluate_nodal_basis, gauss_quad

    bc, jbc = BoundaryCondition(*BC_GRADED), JBC(*BC_GRADED)
    errs, ns, p = [], [8, 16, 32, 64], 3
    for n in ns:
        mesh, jmesh = _graded(n, 4.0)
        cg = make_cg_mesh(mesh, p)
        a, b = cg_stiffness_and_rhs(cg, torch.cos, bc)
        ja, jb = jcg_asm.cg_stiffness_and_rhs(jcg_mesh.make_cg_mesh(jmesh, p), jnp.cos, jbc)
        _close(cg_to_dense(a), jops.cg_to_dense(ja))
        _close(b, jb)
        u = np.linalg.solve(_np(cg_to_dense(a)), _np(b))
        qx, qw = gauss_quad(2 * p + 2)
        basis = np.asarray(evaluate_nodal_basis(cg.ref.basis_coeff, qx))[:, cg.ref.pos_to_slot]
        err2 = sum(
            mesh.jacobians[k] * np.sum(qw * (np.cos(mesh.centers[k] + mesh.jacobians[k] * qx)
                                             - basis @ u[k * p : k * p + p + 1]) ** 2)
            for k in range(n)
        )
        errs.append(np.sqrt(err2))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 4.0) < 0.4, (slope, errs)


def test_dg_convergence_on_graded_mesh():
    bc, jbc = BoundaryCondition(*BC_GRADED), JBC(*BC_GRADED)
    errs, ns = [], [8, 16, 32, 64]
    for n in ns:
        mesh, jmesh = _graded(n, 4.0)
        dg, jdg = make_dg_mesh(mesh, 3), jdg_mesh.make_dg_mesh(jmesh, 3)
        g, d, c = dg_flux_operators(dg, bc, 1.0 * n)
        a = schur_stiffness(g, d, c, dg.mass_inv)
        jg, jd, jc = jdg_asm.dg_flux_operators(jdg, jbc, 1.0 * n)
        _close_ops(a, jhier.schur_stiffness(jg, jd, jc, jdg.mass_inv), f"A n={n}")
        f, r = dg_flux_rhs(dg, torch.cos, bc, 1.0 * n)
        errs.append(_dg_l2_error(dg, _dense_dg_solution(dg, g, d, c, f, r)))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 4.0) < 0.4, (slope, errs)


def test_agg_galerkin_consistency_on_graded_mesh():
    """Rediscretization == Galerkin for the agg <-> DG pair on a graded mesh,
    and the transfer equals JAX's."""
    bc = BoundaryCondition(*BC_GRADED)
    mesh, jmesh = _graded(16, 3.0)
    dg, agg = make_dg_mesh(mesh, 1), make_agg_mesh(1, mesh, 2)
    l = tint.aggdg_dg_interpolation(agg, dg)
    jl = jint.aggdg_dg_interpolation(jagg_mesh.make_agg_mesh(1, jmesh, 2), jdg_mesh.make_dg_mesh(jmesh, 1))
    _close(l.blocks, jl.blocks)
    from agglomerationmultigrid1d_tpu_torch.ops import bp_galerkin

    for x_f, x_a in zip(dg_flux_operators(dg, bc, 100.0), agg_flux_operators(agg, bc, 100.0)):
        np.testing.assert_allclose(_np(bt_to_dense(bp_galerkin(l, x_f))), _np(bt_to_dense(x_a)), atol=1e-11)
    mass = BlockTridiag(torch.zeros_like(dg.mass.blocks), dg.mass.blocks, torch.zeros_like(dg.mass.blocks))
    np.testing.assert_allclose(_np(bp_galerkin(l, mass).diag), _np(agg.mass.blocks), atol=1e-12)


@pytest.mark.parametrize(
    "spec_kw,maxiter,limit",
    [
        (dict(cg_orders=(8, 4, 2, 1), n_agg_levels=5, p_agg=1), 60, 20),
        (dict(cg_orders=(), dg_orders=(4, 2, 1)), 80, 40),
    ],
    ids=["full-cg-agg", "dg"],
)
def test_hierarchy_on_graded_mesh(spec_kw, maxiter, limit):
    """The flagship CG + agg hierarchy and a DG-topped one on a mesh stretched
    4x: float64 ``multigrid`` to 1e-10 with the JAX package's count and
    history."""
    n = 64
    mesh, jmesh = _graded(n, 4.0)
    prob = build_problem(HierarchySpec(**spec_kw, c_dir=1000.0 * n), n, mesh=mesh, device="cpu")
    jprob = jproblems.build_problem(JHierarchySpec(**spec_kw, c_dir=1000.0 * n), n, mesh=jmesh)
    _close(prob.b, jprob.b)
    res = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, maxiter, 1e-10)
    jres = jsolvers.multigrid(jprob.hierarchy, jnp.zeros_like(jprob.b), jprob.b, maxiter, 1e-10)
    it = res.iterations
    assert it == int(jres.iterations) and it <= limit, (it, int(jres.iterations))
    _history_close(res.res_history, jres.res_history, it)
    assert float(res.res_history[it - 1]) < 1e-10 * float(torch.linalg.vector_norm(prob.b))


# ---------------------------------------------------------------------------
# what only the port has
# ---------------------------------------------------------------------------


def _switch_chain(n, n_coarsen):
    """``chip_smoke.py``'s mixed-switch chain at a small size: DG p = 3 ->
    DG p = 1 -> agg r = 2 -> ``n_coarsen`` x 2:1, every level pentadiagonal."""
    s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    meshes = [make_dg_mesh(mesh, 3, switch=s), make_dg_mesh(mesh, 1, switch=s), make_agg_mesh(1, mesh, 2, tables=False)]
    for _ in range(n_coarsen):
        meshes.append(coarsen_agg_mesh(meshes[-1], 2))
    bc, c_dir = BoundaryCondition(*BC_NEU_DIR), 1000.0 * n
    g, d, c = dg_flux_operators(meshes[0], bc, c_dir)
    h = build_dg_hierarchy(meshes, schur_stiffness(g, d, c, meshes[0].mass_inv, mixed_switch=True), g, d, c)
    f, r = dg_flux_rhs(meshes[0], torch.cos, bc, c_dir)
    return h, f - bt_matvec(d, bd_matvec(meshes[0].mass_inv, r))


def test_float32_penta_chain_reaches_no_kernel(monkeypatch):
    """A float32 pentadiagonal level must not reach the tridiagonal kernels
    (their M-form streams hold no distance-2 couplings): no wrapper is
    called, no launch is counted, no level carries M-form streams, and
    ``multigrid_mixed`` still converges."""
    h, b = _switch_chain(256, 3)
    h32 = make_low_precision_hierarchy(h)
    assert all(isinstance(lv.a, BlockPenta) and lv.smoother.ml is None for lv in h32.levels)

    def refuse(*a, **k):
        raise AssertionError("a pentadiagonal level reached a fused kernel wrapper")

    for name in ("multisweep", "multisweep_residual", "chebyshev_multisweep",
                 "chebyshev_multisweep_residual", "fused_bt_matvec"):
        monkeypatch.setattr(tsolvers, name, refuse)
    before = dict(bk.LAUNCHES)
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    assert bk.LAUNCHES == before
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * float(torch.linalg.vector_norm(b))


def test_padded_penta_coarsest_level_matches_banded_solve():
    """An odd pentadiagonal coarsest level above the dense cap (1,025 blocks,
    2,050 DoF) gets a ``PaddedBTCoarseSolver``; float64 ``multigrid``
    reaches the banded direct solution to 1e-8 of its max (the JAX
    package's jitted solvers cannot run this coarse solver)."""
    h, b = _switch_chain(4100, 1)
    assert isinstance(h.coarse, PaddedBTCoarseSolver) and h.levels[-1].a.n_blocks == 1025
    res = multigrid(h, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
    x_direct = fine_direct_solve(h.levels[0], _np(b).T.reshape(-1))
    assert float(res.res_history[res.iterations - 1]) < 1e-10 * float(torch.linalg.vector_norm(b))
    np.testing.assert_allclose(_np(res.x).T.reshape(-1), x_direct, atol=1e-8 * np.abs(x_direct).max())


def _jax_switch_chain(n, n_coarsen):
    """The JAX package's build of ``poisson_switch_hierarchy``'s chain."""
    func, u_ex, ux_ex = jproblems.default_model_problem()
    bc, c_dir = jproblems._default_bc(u_ex, ux_ex), 1000.0 * n
    s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
    mesh = jtopo.create_uniform_mesh(n, 0.0, 1.0)
    meshes = [jdg_mesh.make_dg_mesh(mesh, 3, switch=s), jdg_mesh.make_dg_mesh(mesh, 1, switch=s),
              jagg_mesh.make_agg_mesh(1, mesh, 2, tables=False)]
    for _ in range(n_coarsen):
        meshes.append(jagg_mesh.coarsen_agg_mesh(meshes[-1], 2))
    g, d, c = jdg_asm.dg_flux_operators(meshes[0], bc, c_dir)
    h = jhier.build_dg_hierarchy(meshes, jhier.schur_stiffness(g, d, c, meshes[0].mass_inv, mixed_switch=True),
                                 g, d, c)
    f, r = jdg_asm.dg_flux_rhs(meshes[0], func, bc, c_dir)
    return h, f - jops.bt_matvec(d, jops.bd_matvec(meshes[0].mass_inv, r))


def test_poisson_switch_hierarchy_matches_jax():
    """``poisson_switch_hierarchy`` against the same chain built by the JAX
    package: every pentadiagonal level and b to 1e-12, float64
    ``multigrid`` with the same count and residual history (rtol 1e-9)."""
    prob = poisson_switch_hierarchy(256, 3, device="cpu")
    jh, jb = _jax_switch_chain(256, 3)
    h = prob.hierarchy
    assert h.n_levels == jh.n_levels == 6 and all(isinstance(lv.a, BlockPenta) for lv in h.levels)
    for k, (lv, jlv) in enumerate(zip(h.levels, jh.levels)):
        _close_ops(lv.a, jlv.a, f"level {k}")
    _close(prob.b, jb, "b")
    res = multigrid(h, torch.zeros_like(prob.b), prob.b, 100, 1e-10, compute_error=False)
    jres = jsolvers.multigrid(jh, jnp.zeros_like(jb), jb, 100, 1e-10, compute_error=False)
    assert res.iterations == int(jres.iterations), (res.iterations, int(jres.iterations))
    _history_close(res.res_history, jres.res_history, res.iterations)


def test_refined_solve_condition_and_witness():
    """``fine_refined_solve``: its condition estimate lies within a factor
    of 3 below the exact 1-norm condition number (dense, 256 DoF), and at
    4,100 elements (a padded coarsest level) its refined solution has a far
    smaller extended-precision residual than the float64 banded solve and
    sides with ``multigrid`` at 1e-14, which the banded solve misses by
    ~1e-8 of max|x| (c_dir = 1000 n)."""
    h = poisson_switch_hierarchy(64, 1, device="cpu").hierarchy
    cond, _, _ = fine_refined_solve(h.levels[0], np.ones(256))
    exact = np.linalg.cond(_np(bp5_to_dense(h.levels[0].a)), 1)
    assert exact / 3 <= cond <= exact * (1 + 1e-9), (cond, exact)

    prob = poisson_switch_hierarchy(4100, 1, device="cpu")
    h, b = prob.hierarchy, prob.b
    b_flat = _np(b).T.reshape(-1)
    _, x_ref, last = fine_refined_solve(h.levels[0], b_flat)
    x_banded = fine_direct_solve(h.levels[0], b_flat)
    x_mg = _np(multigrid(h, torch.zeros_like(b), b, 100, 1e-14, compute_error=False).x).T.reshape(-1)
    u, ab = fine_banded_ab(h.levels[0])
    ab_ld, b_ld = ab.astype(np.longdouble), b_flat.astype(np.longdouble)

    def residual(x):
        return float(np.abs(b_ld - _banded_matvec(u, ab_ld, np.asarray(x, dtype=np.longdouble))).max())

    def gap(x):
        return float(np.abs(np.asarray(x, dtype=np.longdouble) - x_ref).max() / np.abs(x_ref).max())

    assert last < 1e-12 and residual(x_ref) < 1e-2 * residual(x_banded), (last, residual(x_ref), residual(x_banded))
    assert gap(x_mg) < 1e-9 < gap(x_banded), (gap(x_mg), gap(x_banded))


@pytest.mark.parametrize("n", [1000, 1_200_000])  # below and above 2^20 unknowns
def test_inv_norm1_estimate_exact_on_m_matrix(n):
    """Hager's estimate of ``||A^-1||_1`` on a symmetric tridiagonal
    M-matrix, where ``A^-1 >= 0`` makes the exact norm ``max(A^-1 1)``:
    equal to 1e-9."""
    from scipy.linalg import lapack

    ab = np.zeros((4, n))
    ab[1, 1:], ab[2], ab[3, :-1] = -1.0, 2.0001, -1.0
    lu, piv, _ = lapack.dgbtrf(ab, 1, 1)

    def solve(r, trans=0):
        return lapack.dgbtrs(lu, 1, 1, np.asarray(r, dtype=np.float64).reshape(n, -1), piv, trans=trans)[0][:, 0]

    exact = float(solve(np.ones(n)).max())
    assert abs(_inv_norm1_estimate(solve, n) - exact) <= 1e-9 * exact


def test_shard_hierarchy_refuses_penta_levels():
    """A pentadiagonal level shards by columns like a tridiagonal one (its
    matvec reads two columns a side from the neighbours): on a fake
    two-rank group every sharded level holds the rank's columns of all five
    streams and of its smoother's inverse blocks; no M-form streams, so no
    kernel takes it."""
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy

    h, _ = _switch_chain(64, 1)
    for rank in range(2):
        g = SolverGroup(group=None, rank=rank, world=2, device=torch.device("cpu"), backend="gloo")
        hs = shard_hierarchy(h, g, min_blocks_per_device=4)
        assert hs.layout.sharded == (True, True, True, False)
        for lv, whole, sh in zip(hs.levels, h.levels, hs.layout.sharded):
            n = whole.a.n_blocks
            lo, hi = (rank * n // 2, (rank + 1) * n // 2) if sh else (0, n)
            assert isinstance(lv.a, BlockPenta) and lv.smoother.ml is None
            assert all(torch.equal(t, w[..., lo:hi]) for t, w in zip(lv.a, whole.a))
            assert torch.equal(lv.smoother.inv, whole.smoother.inv[..., lo:hi])


def test_precision_casts_keep_penta_structure():
    """``hierarchy_astype`` casts every pentadiagonal field and a padded
    coarse solver's factors, leaving its DoF count an int."""
    from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype

    h, _ = _switch_chain(4100, 1)
    h32 = hierarchy_astype(h, torch.float32)
    assert all(t.dtype == torch.float32 for t in h32.levels[0].a)
    assert isinstance(h32.coarse, PaddedBTCoarseSolver) and h32.coarse.n_dof == 2050
    assert h32.coarse.inner.root_inv.dtype == torch.float32
    assert isinstance(BlockDiag(h32.levels[0].mass_inv).blocks, torch.Tensor)
