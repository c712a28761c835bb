"""The CG-topped cell ``flagship_16m.handover_cg`` at a small size on the
CPU (n = 16,384 elements, 3 agglomerated levels: 131,073 DoF): it
resolves, a sound run reads ``correct``, the float32 control and three
planted faults do not (a V-cycle that returns its state unchanged, an
answer altered where the solver produces it, the fine band altered in
set-up), and the run loads no JAX module.  The CG spans' readers, on a
synthetic trace, take the kernels launched inside ``aggmg.cg@k`` and
leave the phase readings as they were."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aggmg_bench import harness, spans, trace  # noqa: E402
from aggmg_bench.control import Control  # noqa: E402

CELL = "flagship_16m.handover_cg"
N = 16384
SMALL = {"builder_args": {"n": N, "spec": {"c_dir": 1000.0 * N, "n_agg_levels": 3}},
         "discretization": {"n_elements": N}}
SEED = 2**31 + 13
SPLITS = ("solve_s", "solve_s.host_bound")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, restored after: at 131,073 DoF each elementwise
    op would split over every core, and while the other test workers of a
    parallel run hold the cores, every split waits for its threads (a
    solve then takes minutes instead of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_small(program=None, seconds=0.3):
    out, _ = harness.run(harness.resolve(CELL), SEED, seconds, False, device="cpu", overrides=SMALL, program=program)
    return out


def test_cell_resolves():
    cell = harness.resolve(CELL)
    assert cell.builder.FORM == cell.entry.FORM == "xl_cg" and cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert len(e2e & set(SPLITS)) == 1 and {"setup_s", "peak_mem_gib"} <= e2e
    split = (e2e & set(SPLITS)).pop()
    layers = {m["name"]: m for m, _ in cell.per_layer}
    assert {"cg_ms_per_cycle", "cg_launches_per_cycle", "build_s"} <= set(layers)
    assert all(m["moves"] in e2e for m in layers.values())
    assert layers["cg_ms_per_cycle"]["moves"] == layers["cg_launches_per_cycle"]["moves"] == split


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"rel_residual", "operator_gap", "rhs_gap"}


def test_control_is_not_correct():
    out = run_small(program=Control(harness.resolve(CELL)))
    assert not out["correct"], out["checks"]
    assert all(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def _unchanged(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    monkeypatch.setattr(solvers, "v_cycle", lambda h, x0, b, **kw: x0)
    monkeypatch.setattr(solvers, "v_cycle_true",
                        lambda h, ffops, r, **kw: FF(torch.zeros_like(r.hi), torch.zeros_like(r.hi)))


def _altered_answer(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    orig = solvers._mixed_loop_ff

    def loop(*a, **k):
        x, outer, cycles, hist = orig(*a, **k)
        hi = x.hi.clone()
        hi[hi.shape[0] // 2] += 1e-3 * float(hi.abs().max())
        return x._replace(hi=hi), outer, cycles, hist

    monkeypatch.setattr(solvers, "_mixed_loop_ff", loop)


def _altered_band(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import problems
    from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import CgOperator

    orig = problems.cg_stiffness_and_rhs

    def assemble(cg, func, bc):
        a, f = orig(cg, func, bc)
        return CgOperator(windows=a.windows * (1 + 1e-6), band=a.band * (1 + 1e-6)), f

    monkeypatch.setattr(problems, "cg_stiffness_and_rhs", assemble)


@pytest.mark.parametrize("fault", [_unchanged, _altered_answer, _altered_band])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small()
    assert not out["correct"], (fault.__name__, out["checks"])


def test_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r});"
            "from test_bench_flagship import CELL, SEED, SMALL; from aggmg_bench import harness;"
            "harness.run(harness.resolve(CELL), SEED, 0.1, True, device='cpu', overrides=SMALL);"
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _reader(name):
    return harness.load_module(harness.reader_path(ROOT / "aggmg_bench", name), f"_test_reader_{name}")


def _synthetic(with_cg: bool):
    """Two V-cycles: a smooth@0 span with two launches, the first inside a
    CG span; a transfer@0 span with one launch inside a CG span; a launch
    outside every span; a coarse span with one."""
    host = [
        ("aggmg.vcycle.f32", 0, 100),
        ("aggmg.smooth@0", 0, 30), ("cudaLaunchKernel", 4, 2), ("cuLaunchKernel", 20, 2),
        ("aggmg.transfer@0", 40, 20), ("cudaLaunchKernelExC", 45, 2),
        ("cudaLaunchKernel", 62, 2),
        ("aggmg.coarse", 70, 20), ("cudaLaunchKernel", 75, 2),
    ]
    if with_cg:
        host += [("aggmg.cg@0", 1, 10), ("aggmg.cg@0", 41, 10)]
    kernels = [("band", 10, 1_000_000), ("jacobi", 1_000_100, 2_000_000), ("restrict", 3_000_200, 3_000_000),
               ("add", 6_000_300, 500_000), ("bcr", 6_500_400, 4_000_000)]
    return SimpleNamespace(trace=trace.Trace(kernels=kernels, host=host), traced_cycles=2)


def test_cg_readers_take_the_kernels_launched_in_cg_spans():
    rec = _synthetic(True)
    assert _reader("cg_ms_per_cycle").read(rec) == 2.0  # (1 + 3) ms over 2 cycles
    assert _reader("cg_launches_per_cycle").read(rec) == 1.0
    none = _synthetic(False)
    assert _reader("cg_ms_per_cycle").read(none) is None and _reader("cg_launches_per_cycle").read(none) is None
    unpaired = _synthetic(True)
    unpaired.trace.kernels.pop()
    assert _reader("cg_ms_per_cycle").read(unpaired) is None


def test_cg_spans_leave_the_phase_readings_alone():
    plain, marked = _synthetic(False), _synthetic(True)
    assert spans.phase("aggmg.cg@0") is None
    assert spans.kernel_spans(marked.trace) == spans.kernel_spans(plain.trace)
    for p in spans.PHASES:
        assert spans.device_ms_per_cycle(marked, p) == spans.device_ms_per_cycle(plain, p)
        assert spans.host_ms_per_cycle(marked, p) == spans.host_ms_per_cycle(plain, p)
