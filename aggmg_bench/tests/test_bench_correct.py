"""``correct`` comes out true on sound runs and false on the control and
on the faults a solve can have, each planted under the timed path: the
harness runs at a small size on the CPU, skipping only its look for a card.
Faults: a V-cycle that returns its state unchanged; an answer altered where
the solver produces it; the fine operator altered in set-up.  (A solve has
no batch to halve and one card no exchange to drop.)"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_helpers import CELLS, SEED, SMALL  # noqa: E402

from aggmg_bench import harness  # noqa: E402
from aggmg_bench.control import Control  # noqa: E402


def run_small(cell_name, program=None, seconds=0.3):
    cell = harness.resolve(cell_name)
    out, _ = harness.run(cell, SEED, seconds, False, device="cpu", overrides=SMALL[cell.config["name"]],
                         program=program)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.resolve(cell)
    out = run_small(cell, program=Control(c))
    assert not out["correct"], out["checks"]
    assert out["checks"]["rel_residual"]["value"] > out["checks"]["rel_residual"]["limit"]


def _unchanged(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    monkeypatch.setattr(solvers, "v_cycle", lambda h, x0, b, **kw: x0)
    monkeypatch.setattr(solvers, "v_cycle_ff", lambda h, a_ffs, u_ff, rhs_ff, *a, **kw: u_ff)
    monkeypatch.setattr(solvers, "v_cycle_true",
                        lambda h, ffops, r, **kw: FF(torch.zeros_like(r.hi), torch.zeros_like(r.hi)))


def _altered_answer(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    def bump(t):
        t = t.clone()
        t[0, t.shape[1] // 2] += 1e-3 * float(t.abs().max())
        return t

    for fn in ("multigrid", "multigrid_mixed", "multigrid_true"):
        orig = getattr(solvers, fn)
        monkeypatch.setattr(solvers, fn, lambda *a, _o=orig, **k: _o(*a, **k)._replace(x=bump(_o(*a, **k).x)))
    orig_ff = solvers._mixed_loop_ff

    def loop(*a, **k):
        x, outer, cycles, hist = orig_ff(*a, **k)
        return x._replace(hi=bump(x.hi)), outer, cycles, hist

    monkeypatch.setattr(solvers, "_mixed_loop_ff", loop)


def _altered_operator(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import problems

    orig = problems.dg_flux_operators
    monkeypatch.setattr(problems, "dg_flux_operators", lambda dg, bc, c_dir: orig(dg, bc, c_dir * (1 + 1e-6)))


@pytest.mark.parametrize("fault", [_unchanged, _altered_answer, _altered_operator])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(cell)
    assert not out["correct"], (fault.__name__, out["checks"])


def test_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r});"
            "from bench_helpers import SMALL, SEED; from aggmg_bench import harness;"
            "c = harness.resolve('north_star.handover');"
            "harness.run(c, SEED, 0.1, True, device='cpu', overrides=SMALL['north_star']);"
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "aggmg_bench" / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
