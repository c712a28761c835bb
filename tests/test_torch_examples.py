"""The torch port's example scripts (``examples/*_torch.py``) run on the CPU
(``--device cpu``) at small sizes, held to the JAX package:

* ``full_hierarchy_solve``: JAX's V-cycle count at every n;
* ``cg_convergence``: the L2 errors within 1e-10 relative of JAX's example's
  own computation (its ``l2_error`` on JAX's assembly and dense solve), or
  1e-14 absolute: from n = 16 the error nears what the two packages' dense
  solves (different LAPACK routes) round differently (8.6e-18 on 4.3e-9 at
  n = 16, 1.0e-15 on 2.7e-10 at n = 32);
* ``mixed_precision_fastpath`` at its own size (8,192 elements): within
  ROADMAP G1's 1 outer / 2 inner steps of JAX's ``multigrid_mixed`` (its
  CPU path; below 2,048 elements the outer counts part further, G22);
* ``smoother_study``: the Richardson counts, spectral radii and mode damping
  of the port's functions on the same level (``tests/test_torch_surface.py``
  holds those to JAX);
* ``xl_north_star``: ``multigrid_true``'s cycles within 1 of JAX's at
  16,384 elements, and ``--handover`` at 32,768, where the guard trickles at
  the script's tol 1e-8 and hands over;
* ``scattered_partitions`` and ``distributed_solve`` (two gloo ranks): their
  own checks, the solves converged and the sharded solve equal to the
  unsharded one;
* no example imports JAX.
"""

import importlib.util
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.assembly import cg_assembly as jcg_asm
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh.topology import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh.topology import create_uniform_mesh as juniform
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.ops.cg_operator import cg_to_dense as jcg_to_dense
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
TORCH_EXAMPLES = ("cg_convergence", "full_hierarchy_solve", "mixed_precision_fastpath", "smoother_study",
                  "scattered_partitions", "xl_north_star", "distributed_solve")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_hierarchy_solve_matches_jax():
    ns = [8, 16]
    got = _load("full_hierarchy_solve_torch").main(["--device", "cpu", "--n", *map(str, ns)])["cycles"]
    for n in ns:
        prob = jproblems.poisson_full_hierarchy(n=n)
        res = jsolvers.multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 100, 1e-10)
        assert got[n] == int(res.iterations), (n, got[n], int(res.iterations))


def test_cg_convergence_matches_jax():
    ns = [4, 8, 16]
    got = _load("cg_convergence_torch").main(["--device", "cpu", "--n", *map(str, ns)])
    jex = _load("cg_convergence")
    bc = JBC(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
    for n, err in zip(ns, got["errors"]):
        cg = jcg_mesh.make_cg_mesh(juniform(n, 0.0, 1.0), jex.P)
        a, f = jcg_asm.cg_stiffness_and_rhs(cg, jnp.cos, bc)
        want = jex.l2_error(cg, np.linalg.solve(np.asarray(jcg_to_dense(a)), np.asarray(f)), np.cos)
        assert abs(err - want) <= max(1e-10 * want, 1e-14), (n, err, want)
    assert 3.8 < got["slope"] < 4.2


def test_mixed_precision_fastpath_matches_jax():
    n = 8192
    got = _load("mixed_precision_fastpath_torch").main(["--device", "cpu"])
    prob = jproblems.poisson_dg_hierarchy(n=n, max_p=4, n_dg=3, n_agg=6)
    h32 = jsolvers.make_low_precision_hierarchy(prob.hierarchy)
    res = jsolvers.multigrid_mixed(prob.hierarchy, h32, jnp.zeros_like(prob.b), prob.b, 80, 1e-10, use_pallas=False)
    assert got["rel"] < 1e-10
    assert abs(got["outer"] - int(res.iterations)) <= 1, (got, int(res.iterations))
    assert abs(got["inner"] - int(res.inner_cycles)) <= 2, (got, int(res.inner_cycles))


def test_smoother_study_runs():
    from agglomerationmultigrid1d_tpu_torch.assembly import cg_stiffness_and_rhs
    from agglomerationmultigrid1d_tpu_torch.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
    from agglomerationmultigrid1d_tpu_torch.models import CgLevel, mode_damping, smoother_spectrum
    from agglomerationmultigrid1d_tpu_torch.smoothers import cg_smoother

    mod = _load("smoother_study_torch")
    got = mod.main(["--device", "cpu", "--n", "8"])
    cg = make_cg_mesh(create_uniform_mesh(8, 0.0, 1.0), 2)
    a, _ = cg_stiffness_and_rhs(cg, torch.ones_like, BoundaryCondition(("dir", 0.0), ("dir", 0.0)))
    for kind, alpha in mod.KINDS:
        lv = CgLevel(a=a, smoother=cg_smoother(a, kind))
        assert got[kind]["radius"] == float(np.abs(smoother_spectrum(lv, alpha)[0])) < 1.0
        np.testing.assert_array_equal(got[kind]["damping"], mode_damping(lv, 8, 10, alpha))
        assert 1 < got[kind]["iterations"] < 20000
    # Richardson slows as the spectral radius nears 1
    assert got["jac"]["iterations"] > got["hybridSchwarz"]["iterations"]


def test_scattered_partitions_runs():
    got = _load("scattered_partitions_torch").main(["--device", "cpu", "--n", "64"])
    near, local, far = (got[k] for k in ("contiguous runs of 8", "2 runs, 4 elements apart",
                                        "2 runs, half a domain apart"))
    for r in (near, local):
        assert r["res"] < 1e-9 and r["err"] < 1e-9, got
    # the further an agglomerate's runs spread, the slower the V-cycle contracts
    assert near["cycles"] <= local["cycles"] <= far["cycles"], got


@pytest.mark.parametrize("handover", [False, True])
def test_xl_north_star_runs(handover):
    # at 32,768 elements the guard trickles at the script's tol 1e-8 and hands over; at 16,384 it reaches tol
    n = 32768 if handover else 16384
    got = _load("xl_north_star_torch").main([str(n), "--device", "cpu"] + (["--handover"] if handover else []))
    assert got["history"][-1] < 1e-8
    if handover:
        assert got["ended"] == "trickle" and got["true_cycles"] >= 1, got
        return
    # multigrid_true's cycles against JAX's on the problem examples/xl_north_star.py builds at this n
    # (equal here: 15), held within 1
    n_agg = max(int(np.ceil(np.log2(max(n / 12288, 4)) / 2)), 1)
    spec = JHierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=n_agg, p_agg=1, agg_factor=4, c_dir=1000.0 * n)
    h, ffops, b_ff, norm_b = jbuild_xl_problem(spec, n, slim_fine=True, ff_levels=True)
    res = jsolvers.multigrid_true(h, ffops, b_ff, norm_b, maxiter=40, tol=1e-8)
    assert abs(got["iterations"] - int(res.iterations)) <= 1, (got["iterations"], int(res.iterations))


def test_distributed_solve_on_two_gloo_ranks():
    """As a script: its ranks are spawned processes that import it by path."""
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "distributed_solve_torch.py"), "--device", "cpu", "--world", "2", "--n", "64"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("2 rank(s) on cpu over gloo") and "= 0.00e+00" in line, line
    cycles, unsharded = re.search(r"(\d+) V-cycles \(unsharded (\d+)\)", line).groups()
    assert cycles == unsharded, line


def test_examples_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"for name in {TORCH_EXAMPLES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(EXAMPLES)!r} + '/' + name + '_torch.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'agglomerationmultigrid1d_tpu.'))"
        " or m == 'agglomerationmultigrid1d_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for name in TORCH_EXAMPLES:
        text = (EXAMPLES / f"{name}_torch.py").read_text()
        assert "import jax" not in text and "agglomerationmultigrid1d_tpu." not in text, name
