"""The plain reference (``references/dg_block_tridiag.py``): it agrees
with a dense float64 solve at a tiny size, it works out the program's
operator and right-hand side again, and it (like the generator and the
arithmetic) imports nothing of either package."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aggmg_bench import generator, reference  # noqa: E402

TRIDIAG = reference.load("dg_block_tridiag")
MODEL = {"problems": [{"source": "cos", "left": -0.0, "right": float(np.cos(1.0))}], "scale_exp": [-2, 2]}

DISC = dict(p=3, n_elements=37, domain=[0.0, 1.0], c_dir=37000.0, left="neumann", right="dirichlet",
            mesh="vertices")


def dense(lower, diag, upper) -> np.ndarray:
    bs, _, n = diag.shape
    a = np.zeros((bs * n, bs * n))
    for e in range(n):
        s = slice(bs * e, bs * e + bs)
        a[s, s] = diag[..., e]
        if e > 0:
            a[s, slice(bs * (e - 1), bs * e)] = lower[..., e]
        if e < n - 1:
            a[s, slice(bs * (e + 1), bs * (e + 2))] = upper[..., e]
    return a


@pytest.mark.parametrize("disc", [DISC, {**DISC, "p": 1, "left": "dirichlet", "mesh": "width"},
                                  {**DISC, "p": 2, "right": "neumann", "left": "dirichlet", "n_elements": 2}])
def test_cyclic_reduction_matches_a_dense_solve(disc):
    prob = TRIDIAG.Problem(disc)
    lo, di, up = prob.operator_columns(0, prob.n)
    d = generator.draws(MODEL, 7)[0]
    b = generator.rhs_vector(prob, d)
    x = TRIDIAG.direct_solve((lo, di, up), b)
    want = np.linalg.solve(dense(lo.numpy(), di.numpy(), up.numpy()), b.T.reshape(-1).numpy())
    got = x.T.reshape(-1).numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    assert reference.relative_residual(prob, x, lambda a, c: b[:, a:c]) < 1e-13


def test_blocked_columns_equal_the_whole():
    prob = TRIDIAG.Problem({**DISC, "n_elements": 50})
    whole = prob.operator_columns(0, 50)
    for lo, hi in ((0, 1), (0, 17), (17, 49), (49, 50)):
        for w, part in zip(whole, prob.operator_columns(lo, hi)):
            assert torch.equal(w[..., lo:hi], part)
    b = prob.rhs_columns(torch.cos, 0.3, 0.7, 0, 50)
    assert torch.equal(b[:, 17:50], prob.rhs_columns(torch.cos, 0.3, 0.7, 17, 50))


@pytest.mark.parametrize("p,nd", [(3, 2), (1, 1)])
def test_reference_agrees_with_the_program(p, nd):
    from agglomerationmultigrid1d_tpu_torch.models import poisson_dg_hierarchy

    n = 300
    prog = poisson_dg_hierarchy(n=n, max_p=p, n_dg=nd, n_agg=0, device="cpu")
    ref = TRIDIAG.Problem({**DISC, "p": p, "n_elements": n, "c_dir": 1000.0 * n})
    a = prog.hierarchy.levels[0].a
    for got, want in zip((a.lower, a.diag, a.upper), ref.operator_columns(0, n)):
        assert reference.max_column_gap(got, want) < 1e-13
    b = ref.rhs_columns(torch.cos, -0.0, float(np.cos(1.0)), 0, n)
    assert reference.max_column_gap(prog.b, b) < 1e-13


@pytest.mark.parametrize("module", ["reference", "generator", "roofline", "trace", "references.dg_block_tridiag"])
def test_the_yardstick_imports_nothing_of_either_package(module):
    tree = ast.parse((ROOT / "aggmg_bench" / f"{module.replace('.', '/')}.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names if m.split(".")[0].startswith(("agglomerationmultigrid1d_tpu", "jax", "flax"))]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import aggmg_bench.{module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith(('agglomeration', 'jax', 'flax'))}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_seeds_scale_the_pool_exactly():
    """Every seed draws the same listed problems, in its own order, each
    scaled by a sign and a power of two: the vectors are exact multiples."""
    rhs = {"problems": [{"source": "cos", "left": -0.0, "right": 0.54}, {"source": "sin", "left": 0.3, "right": 1.2},
                        {"source": "exp", "left": -1.0, "right": 0.5}], "scale_exp": [-8, 8]}
    prob = TRIDIAG.Problem(DISC)
    a, b = generator.draws(rhs, 2**31 + 5), generator.draws(rhs, 12345678901)
    key = lambda d: round(float(d.source(torch.tensor([0.3], dtype=torch.float64))[0] / d.scale), 12)  # noqa: E731
    va = {key(d): (d.scale, generator.rhs_vector(prob, d)) for d in a}
    assert len(va) == 3
    for d in b:
        sa, v = va[key(d)]
        assert torch.equal(generator.rhs_vector(prob, d) * (sa / d.scale), v)
    assert [d.scale for d in generator.draws(rhs, 99)] == [d.scale for d in generator.draws(rhs, 99)]
