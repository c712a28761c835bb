"""The rest of the torch port's surface against the JAX package, on the CPU
in float64: ``models.solve``, ``iterative_smoother_solve``, the smoother
analysis, the checkpoint files (each package reads the other's), the
profiling helpers, the block-format helpers and ``banded_solve``, and the
standalone DG and CG assembly forms.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the analysis matrices and spectra to ``1e-10`` relative;
``iterative_smoother_solve`` with equal iteration counts and histories to
``1e-9`` relative (plus ``1e-12`` of the first entry, G2's floor for sums of
round-off); ``solve`` with ``multigrid``'s counts and results exactly;
block helpers and assembly to ``1e-12`` relative; checkpoints bit for bit."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.assembly import cg_assembly as jcg_asm
from agglomerationmultigrid1d_tpu.assembly import dg_assembly as jdg_asm
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh.topology import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh.topology import create_uniform_mesh as juniform
from agglomerationmultigrid1d_tpu.models import analysis as janalysis
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.models.hierarchy import BlockLevel as JBlockLevel
from agglomerationmultigrid1d_tpu.models.hierarchy import CgLevel as JCgLevel
from agglomerationmultigrid1d_tpu.ops import banded_solve as jbanded
from agglomerationmultigrid1d_tpu.ops import block_diag as jbd
from agglomerationmultigrid1d_tpu.ops import block_tridiag as jbt
from agglomerationmultigrid1d_tpu.smoothers import smoother as jsm
from agglomerationmultigrid1d_tpu.utils import checkpoint as jckpt
from agglomerationmultigrid1d_tpu.utils.config import CycleParams as JCycleParams
from agglomerationmultigrid1d_tpu.utils.config import SolveParams as JSolveParams
from agglomerationmultigrid1d_tpu_torch import ops as tops
from agglomerationmultigrid1d_tpu_torch.assembly import (
    c_matrix,
    cg_rhs,
    cg_stiffness,
    cg_stiffness_and_rhs,
    dg_flux_operators,
    divergence,
    f_vector,
    gradient,
    r_vector,
)
from agglomerationmultigrid1d_tpu_torch.mesh import (
    DIRICHLET,
    NEUMANN,
    BoundaryCondition,
    create_uniform_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    BlockLevel,
    CgLevel,
    iterative_smoother_solve,
    level_dense_operator,
    mode_damping,
    multigrid,
    poisson_dg_hierarchy,
    smoother_dense_matrix,
    smoother_iteration_matrix,
    smoother_spectrum,
    solve,
)
from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag
from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
from agglomerationmultigrid1d_tpu_torch.smoothers import Smoother, cg_smoother, dg_smoother
from agglomerationmultigrid1d_tpu_torch.utils import (
    CycleParams,
    SolveParams,
    device_trace,
    load_solver_state,
    save_solver_state,
    span,
    sync,
    tree_astype,
)

RTOL = 1e-12
BC = (("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
SMOOTHERS = [("jac", 2 / 3), ("addSchwarz", 1 / 3), ("hybridSchwarz", 2 / 3)]  # examples/smoother_study.py


def _close(got, want, what="", rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - want).ravel())
    assert err <= rtol * np.linalg.norm(want.ravel()), (what, err, np.linalg.norm(want.ravel()))


def _cg_levels(p, kind, n=16, bc=(("dir", 0.0), ("dir", 0.0))):
    """``examples/smoother_study.py``'s level: -u'' = 1 on CG p with ``kind`` smoothing."""
    cg, jcg = make_cg_mesh(create_uniform_mesh(n, 0.0, 1.0), p), jcg_mesh.make_cg_mesh(juniform(n, 0.0, 1.0), p)
    a, f = cg_stiffness_and_rhs(cg, torch.ones_like, BoundaryCondition(*bc))
    ja, jf = jcg_asm.cg_stiffness_and_rhs(jcg, jnp.ones_like, JBC(*bc))
    return CgLevel(a=a, smoother=cg_smoother(a, kind)), f, JCgLevel(a=ja, smoother=jsm.cg_smoother(ja, kind)), jf


def _block_levels(p=2, n=6):
    """A DG p level with block-Jacobi smoothing, both packages."""
    dg, jdg = make_dg_mesh(create_uniform_mesh(n, 0.0, 1.0), p), jdg_mesh.make_dg_mesh(juniform(n, 0.0, 1.0), p)
    prob = poisson_dg_hierarchy(n=n, max_p=p, n_dg=1, device="cpu")
    jprob = jproblems.poisson_dg_hierarchy(n=n, max_p=p, n_dg=1)
    lv, jlv = prob.hierarchy.levels[0], jprob.hierarchy.levels[0]
    assert dg.n_elements == jdg.n_elements == n
    return lv, prob.b, jlv, jprob.b


def test_solve_runs_multigrid_with_the_config_dataclasses():
    """``solve`` is ``multigrid`` with the dataclasses' parameters: the same
    counts and results as the port's ``multigrid``, and JAX's ``solve``'s
    counts on the same problem."""
    kw = dict(n=32, max_p=2, n_dg=2, n_agg=1)
    prob = poisson_dg_hierarchy(**kw, device="cpu")
    sp, cp = SolveParams(maxiter=40, tol=1e-10), CycleParams(n_pre=2, n_post=2, alpha=0.6)
    res = solve(prob, solve_params=sp, cycle_params=cp)
    ref = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 40, 1e-10, n_pre=2, n_post=2, alpha=0.6)
    assert res.iterations == ref.iterations
    assert torch.equal(res.x, ref.x)
    torch.testing.assert_close(res.res_history, ref.res_history, rtol=0, atol=0, equal_nan=True)
    jres = jproblems.solve(jproblems.poisson_dg_hierarchy(**kw), solve_params=JSolveParams(maxiter=40, tol=1e-10),
                           cycle_params=JCycleParams(n_pre=2, n_post=2, alpha=0.6))
    it = res.iterations
    assert it == int(jres.iterations)
    want = np.asarray(jres.res_history)[:it]
    np.testing.assert_allclose(res.res_history[:it].numpy(), want, rtol=1e-9, atol=1e-12 * want[0])
    # from a given x0, and without the error history
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(tuple(prob.b.shape)))
    res0 = solve(prob, x0, SolveParams(maxiter=3, tol=1e-30, compute_error=False))
    assert res0.iterations == 3 and torch.isnan(res0.err_history).all()


@pytest.mark.parametrize("kind,alpha", SMOOTHERS)
def test_iterative_smoother_solve_matches_jax(kind, alpha):
    lv, f, jlv, jf = _cg_levels(2, kind)
    res = iterative_smoother_solve(lv, torch.zeros_like(f), f, maxiter=20000, tol=1e-8, alpha=alpha)
    jres = jsolvers.iterative_smoother_solve(jlv, jnp.zeros_like(jf), jf, maxiter=20000, tol=1e-8, alpha=alpha)
    it = res.iterations
    assert it == int(jres.iterations) and 1 < it < 20000
    for name in ("res_history", "err_history"):
        got, want = getattr(res, name).numpy(), np.asarray(getattr(jres, name))
        np.testing.assert_allclose(got[:it], want[:it], rtol=1e-9, atol=1e-12 * want[0], err_msg=name)
        assert np.isnan(got[it:]).all()
    _close(res.x, jres.x, "x", rtol=1e-9)


def test_iterative_smoother_solve_on_a_block_level_matches_jax():
    lv, b, jlv, jb = _block_levels()
    res = iterative_smoother_solve(lv, torch.zeros_like(b), b, maxiter=400, tol=1e-30, alpha=0.7)
    jres = jsolvers.iterative_smoother_solve(jlv, jnp.zeros_like(jb), jb, maxiter=400, tol=1e-30, alpha=0.7)
    assert res.iterations == int(jres.iterations) == 400
    want = np.asarray(jres.res_history)
    np.testing.assert_allclose(res.res_history.numpy(), want, rtol=1e-9, atol=1e-12 * want[0])


@pytest.mark.parametrize("kind,alpha", SMOOTHERS)
def test_cg_smoother_analysis_matches_jax(kind, alpha):
    lv, _, jlv, _ = _cg_levels(2, kind, n=8)
    _close(level_dense_operator(lv), janalysis.level_dense_operator(jlv), "A", rtol=1e-10)
    _close(smoother_dense_matrix(lv), janalysis.smoother_dense_matrix(jlv), "S", rtol=1e-10)
    _close(smoother_iteration_matrix(lv, alpha), janalysis.smoother_iteration_matrix(jlv, alpha), "E", rtol=1e-10)
    ev, jev = smoother_spectrum(lv, alpha), janalysis.smoother_spectrum(jlv, alpha)
    _close(np.sort(np.abs(ev)), np.sort(np.abs(jev)), "|spectrum|", rtol=1e-10)
    _close(np.sort_complex(ev.round(12)), np.sort_complex(jev.round(12)), "spectrum", rtol=1e-10)
    _close(mode_damping(lv, 6, 10, alpha), janalysis.mode_damping(jlv, 6, 10, alpha), "damping", rtol=1e-10)


def test_block_smoother_analysis_matches_jax():
    lv, _, jlv, _ = _block_levels()
    _close(level_dense_operator(lv), janalysis.level_dense_operator(jlv), "A", rtol=1e-10)
    _close(smoother_dense_matrix(lv), janalysis.smoother_dense_matrix(jlv), "S", rtol=1e-10)
    _close(mode_damping(lv, 4, 5), janalysis.mode_damping(jlv, 4, 5), "damping", rtol=1e-10)
    ev, jev = smoother_spectrum(lv), janalysis.smoother_spectrum(jlv)
    _close(np.sort(np.abs(ev)), np.sort(np.abs(jev)), "|spectrum|", rtol=1e-10)
    assert isinstance(lv, BlockLevel) and isinstance(jlv, JBlockLevel)


def _history(rng, n, k):
    h = np.full(n, np.nan)
    h[:k] = rng.standard_normal(k)
    return h


def test_checkpoints_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 17))
    res_h, err_h = _history(rng, 20, 7), _history(rng, 20, 7)
    # the port writes, JAX reads
    save_solver_state(str(tmp_path / "port.npz"), torch.from_numpy(x), 7, torch.from_numpy(res_h), torch.from_numpy(err_h))
    jx, jit, jres, jerr = jckpt.load_solver_state(str(tmp_path / "port.npz"))
    assert jit == 7
    for got, want in ((jx, x), (jres, res_h), (jerr, err_h)):
        np.testing.assert_array_equal(np.asarray(got), want)
    # JAX writes, the port reads
    jckpt.save_solver_state(str(tmp_path / "jax.npz"), jnp.asarray(x), 7, jnp.asarray(res_h), jnp.asarray(err_h))
    tx, tit, tres, terr = load_solver_state(str(tmp_path / "jax.npz"), device="cpu")
    assert tit == 7 and tx.dtype == torch.float64
    for got, want in ((tx, x), (tres, res_h), (terr, err_h)):
        np.testing.assert_array_equal(got.numpy(), want)
    # no histories, a float32 iterate
    save_solver_state(str(tmp_path / "bare.npz"), torch.from_numpy(x.astype(np.float32)), 2)
    bx, bit, bres, berr = jckpt.load_solver_state(str(tmp_path / "bare.npz"))
    assert bit == 2 and np.asarray(bx).dtype == np.float32 and np.asarray(bres).size == np.asarray(berr).size == 0
    np.testing.assert_array_equal(np.asarray(bx), x.astype(np.float32))


def test_profiling_helpers(tmp_path):
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.float64)
    assert sync((a, [b])) == 15.0 + 4.0
    seen, totals = [], {}
    with span("aggmg.setup.step", sink=lambda name, dt: seen.append((name, dt))) as t:
        torch.linalg.inv(torch.eye(64) * 2.0)
    assert seen and seen[0][0] == "aggmg.setup.step" and seen[0][1] == t.seconds >= 0.0
    for _ in range(2):  # a dict sink adds up under the name's last part
        with span("aggmg.setup.step", totals):
            torch.linalg.inv(torch.eye(64) * 2.0)
    assert list(totals) == ["step"] and totals["step"] >= 0.0
    assert not isinstance(span("aggmg.x"), span)  # no sink: the profiler's record function itself
    prob = poisson_dg_hierarchy(n=16, max_p=2, n_dg=2, device="cpu")
    with device_trace(str(tmp_path / "trace")) as prof:
        multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 1, 1e-10, compute_error=False)
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any("einsum" in e.get("name", "") for e in events)
    assert {"aggmg.solve.multigrid", "aggmg.vcycle.f64", "aggmg.coarse"} <= {e.get("name") for e in events}
    assert prof.key_averages()


def test_block_diag_helpers_match_jax(rng):
    bs, n = 3, 9
    blocks = rng.standard_normal((n, bs, bs)) + 4.0 * np.eye(bs)
    x = rng.standard_normal((bs, n))
    rhs = rng.standard_normal((n, bs, 2))
    bd, jbdd = tops.bd_from_dense_blocks(torch.from_numpy(blocks)), jbd.bd_from_dense_blocks(jnp.asarray(blocks))
    _close(bd.blocks, jbdd.blocks, "from dense blocks")
    _close(tops.bd_to_dense_blocks(bd), jbd.bd_to_dense_blocks(jbdd), "to dense blocks")
    _close(tops.bd_inverse(bd).blocks, jbd.bd_inverse(jbdd).blocks, "inverse")
    _close(tops.bd_solve(bd, torch.from_numpy(x)), jbd.bd_solve(jbdd, jnp.asarray(x)), "solve")
    _close(tops.bd_solve_mat(bd, torch.from_numpy(rhs)), jbd.bd_solve_mat(jbdd, jnp.asarray(rhs)), "solve_mat")
    _close(tops.bd_to_dense(bd), jbd.bd_to_dense(jbdd), "dense")
    _close(tops.bd_matvec(bd, torch.from_numpy(x)), jbd.bd_matvec(jbdd, jnp.asarray(x)), "matvec")
    assert (bd.block_size, bd.n_blocks, bd.n_dof) == (jbdd.block_size, jbdd.n_blocks, jbdd.n_dof)


def test_block_tridiag_helpers_match_jax(rng):
    bs, n = 2, 7
    arrs = [rng.standard_normal((bs, bs, n)) for _ in range(6)]
    a, b = BlockTridiag(*map(torch.from_numpy, arrs[:3])), BlockTridiag(*map(torch.from_numpy, arrs[3:]))
    ja, jb = jbt.BlockTridiag(*map(jnp.asarray, arrs[:3])), jbt.BlockTridiag(*map(jnp.asarray, arrs[3:]))
    for name, got, want in (("add", tops.bt_add(a, b), jbt.bt_add(ja, jb)),
                            ("scale", tops.bt_scale(a, -1.5), jbt.bt_scale(ja, -1.5))):
        for f in ("lower", "diag", "upper"):
            _close(getattr(got, f), getattr(want, f), f"{name}.{f}")
    _close(tops.bt_distance2_residual(a, b), jbt.bt_distance2_residual(ja, jb), "distance-2")
    dense = jbt.bt_to_dense(ja)
    _close(tops.bt_to_dense(a), dense, "to dense")
    back, jback = tops.bt_from_dense(torch.from_numpy(np.array(dense)), bs), jbt.bt_from_dense(dense, bs)
    for f in ("lower", "diag", "upper"):
        _close(getattr(back, f), getattr(jback, f), f"from dense {f}")
    z, jz = tops.bt_zeros(bs, n, device="cpu"), jbt.bt_zeros(bs, n)
    assert z.diag.dtype == torch.float64 and z.diag.shape == tuple(jz.diag.shape) and not z.diag.any()
    assert tops.bt_zeros(bs, n, torch.float32, device="cpu").lower.dtype == torch.float32


def test_banded_solve_matches_jax(rng):
    lv, b, jlv, jb = _block_levels(p=3, n=5)
    u, ab = tops.banded_solve.__globals__["bt_banded_ab"](lv.a)
    ju, jab = jbanded.bt_banded_ab(jlv.a)
    assert u == ju
    rhs = rng.standard_normal(ab.shape[1])
    _close(tops.banded_solve(u, ab, rhs), jbanded.banded_solve(ju, jab, rhs), "banded solve")
    _close(tops.fine_direct_solve(lv, rhs), jbanded.fine_direct_solve(jlv, rhs), "fine direct solve")


@pytest.mark.parametrize("p", [0, 1, 3])
@pytest.mark.parametrize("bc", [BC, (("dir", 0.3), ("dir", -0.7)), (("dir", 1.0), ("neu", 0.25))])
def test_standalone_dg_operators_match_jax(p, bc):
    dg, jdg = make_dg_mesh(create_uniform_mesh(9, 0.0, 1.0), p), jdg_mesh.make_dg_mesh(juniform(9, 0.0, 1.0), p)
    tbc, jbc = BoundaryCondition(*bc), JBC(*bc)
    g, d, c = dg_flux_operators(dg, tbc, 41.0)
    for name, got, want in (("gradient", gradient(dg, tbc), jdg_asm.gradient(jdg, jbc)),
                            ("divergence", divergence(dg, tbc), jdg_asm.divergence(jdg, jbc)),
                            ("c_matrix", c_matrix(dg, tbc, 41.0), jdg_asm.c_matrix(jdg, jbc, 41.0))):
        for f in ("lower", "diag", "upper"):
            _close(getattr(got, f), getattr(want, f), f"{name}.{f}")
    _close(gradient(dg, tbc).diag, g.diag, "gradient against the flux operators")
    _close(c_matrix(dg, tbc, 41.0).diag, c.diag, "c_matrix against the flux operators")
    _close(r_vector(dg, tbc), jdg_asm.r_vector(jdg, jbc), "r_vector")
    _close(f_vector(dg, torch.sin, tbc, 41.0), jdg_asm.f_vector(jdg, jnp.sin, jbc, 41.0), "f_vector")


@pytest.mark.parametrize("p", [1, 2, 8])
def test_standalone_cg_forms_match_jax(p):
    cg, jcg = make_cg_mesh(create_uniform_mesh(7, 0.0, 1.0), p), jcg_mesh.make_cg_mesh(juniform(7, 0.0, 1.0), p)
    for bc in (BC, (("dir", 0.3), ("dir", -0.7))):
        tbc, jbc = BoundaryCondition(*bc), JBC(*bc)
        a, ja = cg_stiffness(cg, tbc), jcg_asm.cg_stiffness(jcg, jbc)
        _close(a.windows, ja.windows, "stiffness windows")
        _close(a.band, ja.band, "stiffness band")
        _close(a.band, cg_stiffness_and_rhs(cg, torch.cos, tbc)[0].band, "against the pair")
        _close(cg_rhs(cg, torch.cos, tbc), jcg_asm.cg_rhs(jcg, jnp.cos, jbc), "rhs")


def test_small_exports():
    assert (DIRICHLET, NEUMANN) == ("dir", "neu")
    assert BoundaryCondition((DIRICHLET, 0.0), (NEUMANN, 1.0)).dir_left
    assert jsm.Smoother.__args__ and {t.__name__ for t in Smoother.__args__} >= {
        t.__name__ for t in jsm.Smoother.__args__}
    h = poisson_dg_hierarchy(n=16, max_p=2, n_dg=2, device="cpu").hierarchy
    h32 = tree_astype(h, torch.float32)
    assert h32.levels[0].a.diag.dtype == torch.float32 and isinstance(h32.levels[0].mass_inv, torch.Tensor)
    assert os.path.basename(tops.__file__) == "__init__.py"
    assert isinstance(BlockDiag(torch.zeros(2, 2, 3)).n_dof, int)
