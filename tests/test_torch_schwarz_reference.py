"""The benchmark's plain Schwarz reference (``aggmg_bench/references/
cg_hybrid_schwarz.py``) against the port on the CPU at small sizes: the
float64 Schwarz applies of ``cg_smoother(a, "addSchwarz" | "hybridSchwarz")``
at p = 1, 2, 4, 8 equal the reference's window solves; the reference's
Galerkin CG levels equal the port's; the float32 Schwarz smoothers of a
small ``build_xl_problem(..., cg_smoother="hybridSchwarz", ff_levels=True)``
hold ``tools/schwarz_reference_gap.py``'s float32 bound on every CG level,
which windows stored in bfloat16 or float16 miss; the configuration
``flagship_schwarz_16m``'s builder and entry at a small size reach the mix's
tol on ``cg_band``'s operator, under Chebyshev and under the reference's
damped form; and the reference loads neither package nor JAX."""

import functools
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aggmg_bench import harness, reference
from agglomerationmultigrid1d_tpu_torch.assembly.cg_assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.mesh.cg_mesh import make_cg_mesh
from agglomerationmultigrid1d_tpu_torch.mesh.topology import BoundaryCondition, create_uniform_mesh
from agglomerationmultigrid1d_tpu_torch.models import build_problem, build_xl_problem
from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import apply_smoother, cg_smoother
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

ROOT = Path(__file__).resolve().parents[1]
REF = reference.load("cg_hybrid_schwarz")
CG = reference.load("cg_band")
GAP = harness.load_module(ROOT / "tools" / "schwarz_reference_gap.py", "_schwarz_reference_gap")
CELL = "flagship_schwarz_16m.handover_cg"
KINDS = ("addSchwarz", "hybridSchwarz")
CHAINS = {"8-4-2-1": (8, 4, 2, 1), "4-2-1": (4, 2, 1), "2-1": (2, 1)}
XL_N = 4096
SEED = 2**31 + 24
# float64 against float64: the port's inverse windows (LU, then a product)
# and the reference's LU solves round differently, by the windows'
# condition (~6e3 at p = 8) times 2^-53 of |S| |r|, with both on the same
# band; 1e-12 leaves ~100x room.
TOL_F64 = 1e-12


def _disc(p, n):
    return dict(p=p, n_elements=n, domain=[0.0, 1.0], left="neumann", right="dirichlet", mesh="width",
                nodes="chebyshev_lobatto")


def _componentwise(got, want, scale):
    return float(((got.to(torch.float64) - want).abs() / scale).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", (1, 2, 4, 8))
def test_apply_equals_the_reference(p, kind):
    """The port's float64 apply on its own assembly against the
    reference's window solves on ``cg_band``'s band of the same problem,
    per entry of ``|S| |r|`` (the Dirichlet node's unit row would make
    ``max|y|`` hide the interior), and relative to ``max|y|``."""
    n = 300
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    a, _ = cg_stiffness_and_rhs(make_cg_mesh(create_uniform_mesh(n, 0.0, 1.0), p), torch.cos, bc)
    (band,) = CG.Problem(_disc(p, n)).operator_columns(0, n * p + 1)
    r = torch.randn(n * p + 1, generator=torch.Generator().manual_seed(SEED + p), dtype=torch.float64)
    hybrid = kind == "hybridSchwarz"
    got = apply_smoother(cg_smoother(a, kind), r)
    want = REF.schwarz_apply(band, r, hybrid=hybrid, block=37)  # blocks that do not divide n
    assert _componentwise(got, want, REF.schwarz_apply(band, r, hybrid=hybrid, absolute=True)) < TOL_F64
    assert float((got - want).abs().max() / want.abs().max()) < TOL_F64
    assert torch.equal(REF.multiplicity(p, n)[[0, p, n * p]], torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64))


@pytest.mark.parametrize("chain", CHAINS)
def test_galerkin_levels_equal_the_port(chain):
    """The reference's CG levels (``cg_band``'s band, then ``P^T A P`` read
    off probes) against the port's float64 hierarchy (window-level
    Galerkin products), 1e-12 of each column's largest entry."""
    orders = CHAINS[chain]
    n = 64
    prob = build_problem(HierarchySpec(cg_orders=orders, n_agg_levels=2, c_dir=1000.0 * n,
                                       cg_smoother="hybridSchwarz"), n, device="cpu")
    bands = REF.level_bands(_disc(orders[0], n), orders)
    assert len(bands) == len(orders)
    for k, band in enumerate(bands):
        assert reference.max_column_gap(prob.hierarchy.levels[k].a.band, band) < 1e-12, k


@functools.lru_cache(maxsize=None)
def _xl_gaps():
    cfg = harness.resolve(CELL, ROOT).config
    spec = HierarchySpec(**{**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg["builder_args"]["spec"].items()},
                            "c_dir": 1000.0 * XL_N, "n_agg_levels": 3})
    h_low, ffops, _, _ = build_xl_problem(spec, XL_N, ff_levels=True, device="cpu")
    orders = spec.cg_orders
    bands = REF.level_bands(_disc(orders[0], XL_N), orders)
    return GAP.level_gaps(h_low, ffops, bands, orders, SEED, torch.device("cpu"))


@pytest.mark.parametrize("level", range(4))
def test_float32_cg_smoothers_of_the_xl_build(level):
    """Each CG level's float32 hybrid-Schwarz apply within
    ``GAP.TOL`` (the bound of a float32 apply, see the tool) of the
    reference's per entry of ``|S| |r|``; the windows rounded to bfloat16
    or float16 miss it; the level's float-float band equals the
    reference's Galerkin band."""
    row = _xl_gaps()[level]
    assert row["level"] == level and row["p"] == (8, 4, 2, 1)[level]
    assert row["gap"] <= GAP.TOL and row["band_gap"] <= GAP.BAND_TOL, row
    assert min(row["gap_bfloat16"], row["gap_float16"]) > 10 * GAP.TOL, row
    assert row["ok"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chebyshev", (True, False), ids=("chebyshev", "damped"))
def test_handover_solve_meets_the_tol(chebyshev, one_thread):
    """The cell's builder and entry at 131,073 DoF (3 agglomerated levels),
    Chebyshev over hybrid Schwarz (the configuration) and the reference's
    damped hybrid Schwarz (alpha 2/3), one solve each, judged on
    ``cg_band``'s operator and right-hand side in float64."""
    cell = harness.resolve(CELL, ROOT)
    n = 16384
    cfg = harness.merged(cell.config, {
        "builder_args": {"n": n, "chebyshev": chebyshev, "spec": {"n_agg_levels": 3, "c_dir": 1000.0 * n}},
        "discretization": {"n_elements": n}})
    assert cfg["builder_args"]["spec"]["cg_smoother"] == "hybridSchwarz"
    state = cell.entry.prepare(cell.builder.build(cfg, "cpu"), cell.mix["args"])
    prob = CG.Problem(cfg["discretization"])
    p = cfg["problem"]
    b64 = torch.cat([prob.rhs_columns(torch.cos, p["left_value"], p["right_value"], lo, hi)
                     for lo, hi in prob.blocks()], dim=1)
    answer, cycles = cell.entry.solve(state, cell.entry.inputs(state, b64), cell.mix["args"])
    res = reference.relative_residual(prob, harness.to_host(answer), lambda lo, hi: b64[:, lo:hi])
    assert 0 < cycles < cell.mix["args"]["maxiter"]
    assert res < cell.mix["tol"] == 1e-8


def test_reference_loads_neither_package():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from aggmg_bench import reference;"
            "reference.load('cg_hybrid_schwarz'); print(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'agglomerationmultigrid1d_tpu',"
            " 'agglomerationmultigrid1d_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
