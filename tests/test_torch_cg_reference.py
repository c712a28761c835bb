"""The benchmark's plain CG reference (``aggmg_bench/references/cg_band.py``)
against the port on the CPU at small sizes: its band and right-hand side
equal the port's assembly (``assembly.cg_assembly.cg_stiffness_and_rhs``)
and the fine level of the CG-topped stencil build (``build_xl_problem``, the
``CgBandFF``'s hi + lo, as the ``xl_cg_problem`` builder snapshots it); its
blocked reads join to the whole; its direct solve (static condensation,
then cyclic reduction on the vertices) solves what a dense float64 solve
solves; and the ``flagship_16m.handover_cg`` cell's builder and entry,
at n = 16,384, give an answer below the mix's tol on the reference's
operator.  The reference loads neither package nor JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aggmg_bench import harness, reference
from agglomerationmultigrid1d_tpu_torch.assembly.cg_assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.mesh.cg_mesh import make_cg_mesh
from agglomerationmultigrid1d_tpu_torch.mesh.topology import BoundaryCondition, create_uniform_mesh
from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import CgOperator, cg_to_dense

ROOT = Path(__file__).resolve().parents[1]
CG = reference.load("cg_band")
ORDERS = {1: (1,), 2: (2, 1), 8: (8, 4, 2, 1)}  # a CG-topped chain's orders from p down
KINDS = {"neu-dir": ("neumann", "dirichlet"), "dir-neu": ("dirichlet", "neumann"), "dir-dir": ("dirichlet", "dirichlet")}
G_LEFT, G_RIGHT = 0.3, -0.7
SEED = 2**31 + 11


def _disc(p, n, kinds=("neumann", "dirichlet")):
    return dict(p=p, n_elements=n, domain=[0.0, 1.0], left=kinds[0], right=kinds[1], mesh="width",
                nodes="chebyshev_lobatto")


def _whole(prob):
    (band,) = prob.operator_columns(0, prob.n_nodes)
    return band


@pytest.mark.parametrize("kinds", KINDS)
@pytest.mark.parametrize("p", ORDERS)
def test_band_and_rhs_equal_the_port_assembly(p, kinds):
    """1e-12 of each column's largest entry; the port's uniform mesh puts
    its vertices at ``k / n``, the reference every element ``1 / n`` wide,
    which the last digits of ``1 / J`` show (~1e-14)."""
    n = 300
    k = KINDS[kinds]
    bc = BoundaryCondition(*((("neu" if kind == "neumann" else "dir"), g) for kind, g in zip(k, (G_LEFT, G_RIGHT))))
    a, f = cg_stiffness_and_rhs(make_cg_mesh(create_uniform_mesh(n, 0.0, 1.0), p), torch.cos, bc)
    prob = CG.Problem(_disc(p, n, k))
    assert reference.max_column_gap(a.band, _whole(prob)) < 1e-12
    assert reference.max_column_gap(f[None], prob.rhs_columns(torch.cos, G_LEFT, G_RIGHT, 0, prob.n_nodes)) < 1e-12


@pytest.mark.parametrize("p", ORDERS)
def test_band_and_rhs_equal_the_stencil_build(p):
    """The CG-topped stencil build's fine ``CgBandFF`` (hi + lo) and its
    float-float rhs, read as the benchmark's builder snapshots them, on the
    reference's model problem (``-u'' = cos x``, Neumann ``-sin 0`` left,
    Dirichlet ``cos 1`` right)."""
    n = 512
    builder = harness.load_module(ROOT / "aggmg_bench" / "builders" / "xl_cg_problem.py", "_test_xl_cg_problem")
    cfg = {"builder_args": {"n": n, "ff_levels": True,
                            "spec": {"cg_orders": list(ORDERS[p]), "dg_orders": [], "n_agg_levels": 2, "p_agg": 1,
                                     "c_dir": 1000.0 * n}}}
    snap = builder.snapshot(builder.build(cfg, "cpu"))
    prob = CG.Problem(_disc(p, n))
    (got,) = snap["operator"].columns(0, prob.n_nodes)
    assert reference.max_column_gap(got, _whole(prob)) < 1e-12
    want = prob.rhs_columns(torch.cos, -np.sin(0.0), np.cos(1.0), 0, prob.n_nodes)
    assert snap["rhs"].shape == want.shape and reference.max_column_gap(snap["rhs"], want) < 1e-12


@pytest.mark.parametrize("p", ORDERS)
def test_blocks_join_to_the_whole(p):
    """Node blocks that cut elements anywhere give the whole operator, rhs
    and matvec, bit for bit; the matvec equals the dense product."""
    n = 40
    prob = CG.Problem(_disc(p, n))
    cuts = [0, 1, p + 1, 2 * p + 3, prob.n_nodes - 2, prob.n_nodes]
    parts = list(zip(cuts, cuts[1:]))
    band = _whole(prob)
    assert torch.equal(torch.cat([prob.operator_columns(lo, hi)[0] for lo, hi in parts], dim=1), band)
    rhs = prob.rhs_columns(torch.cos, G_LEFT, G_RIGHT, 0, prob.n_nodes)
    assert torch.equal(torch.cat([prob.rhs_columns(torch.cos, G_LEFT, G_RIGHT, lo, hi) for lo, hi in parts], dim=1),
                       rhs)
    x = torch.randn(prob.n_nodes, dtype=torch.float64, generator=torch.Generator().manual_seed(SEED))
    y = torch.cat([prob.matvec_columns(x[None], lo, hi) for lo, hi in parts], dim=1)
    dense = cg_to_dense(CgOperator(windows=torch.zeros(p + 1, p + 1, n, dtype=torch.float64), band=band))
    torch.testing.assert_close(y[0], dense @ x, rtol=1e-14, atol=1e-14 * float((dense @ x).abs().max()))


@pytest.mark.parametrize("n", [16, 300])
@pytest.mark.parametrize("p", ORDERS)
def test_direct_solve_equals_a_dense_solve(p, n):
    """Both solves leave ``A (x - x_dense)`` below 1e-12 of ``||b||``; x
    itself agrees to what two backward-stable solves can, ``1e-14 cond(A)``
    of its largest entry (cond(A) reaches 3e7 at p = 8, n = 300)."""
    prob = CG.Problem(_disc(p, n))
    band = _whole(prob)
    b = prob.rhs_columns(torch.cos, G_LEFT, G_RIGHT, 0, prob.n_nodes)
    dense = cg_to_dense(CgOperator(windows=torch.zeros(p + 1, p + 1, n, dtype=torch.float64), band=band))
    want = torch.linalg.solve(dense, b[0])
    got = CG.direct_solve((band,), b)
    assert got.shape == b.shape and got.dtype == torch.float64
    assert float(torch.linalg.vector_norm(dense @ (got[0] - want)) / torch.linalg.vector_norm(b)) < 1e-12
    cond = float(torch.linalg.cond(dense))
    assert float((got[0] - want).abs().max() / want.abs().max()) < 1e-14 * cond


@pytest.fixture
def one_thread():
    """One intra-op thread, restored after: at 131,073 DoF each elementwise
    op would split over every core, and while the other test workers of a
    parallel run hold the cores, every split waits for its threads (a
    solve then takes minutes instead of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_handover_cg_answer_meets_the_tol(one_thread):
    """The cell's builder and entry at ``flagship_xl_spec(16384)``'s shape
    (131,073 DoF, 4 agglomerated levels), one solve, judged on the
    reference's operator and right-hand side in float64."""
    cell = harness.resolve("flagship_16m.handover_cg", ROOT)
    n = 16384
    cfg = harness.merged(cell.config, {"builder_args": {"n": n, "spec": {"n_agg_levels": 4, "c_dir": 1000.0 * n}},
                                       "discretization": {"n_elements": n}})
    state = cell.entry.prepare(cell.builder.build(cfg, "cpu"), cell.mix["args"])
    prob = CG.Problem(cfg["discretization"])
    p = cfg["problem"]
    b64 = torch.cat([prob.rhs_columns(torch.cos, p["left_value"], p["right_value"], lo, hi)
                     for lo, hi in prob.blocks()], dim=1)
    answer, cycles = cell.entry.solve(state, cell.entry.inputs(state, b64), cell.mix["args"])
    x = harness.to_host(answer)
    res = reference.relative_residual(prob, x, lambda lo, hi: b64[:, lo:hi])
    assert x.shape == (8 * n + 1,) and 0 < cycles < cell.mix["args"]["maxiter"]
    assert res < cell.mix["tol"] == 1e-8


def test_reference_loads_neither_package():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from aggmg_bench import reference;"
            "reference.load('cg_band'); print(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'agglomerationmultigrid1d_tpu',"
            " 'agglomerationmultigrid1d_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
