"""The cell ``flagship_schwarz_16m.handover_cg`` (the CG-topped flagship
with hybrid Schwarz on its CG levels) at a small size on the CPU (n = 16,384
elements, 3 agglomerated levels: 131,073 DoF): it resolves with the two
Schwarz readers, a sound run reads ``correct``, the float32 control does
not.  The Schwarz readers take the kernels launched inside
``aggmg.schwarz@k`` on a synthetic trace (spans that lie inside
``aggmg.cg@k``), read nothing where no such span opens (the Jacobi flagship,
or a program without the span), and leave the CG readers' readings as they
were."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aggmg_bench import harness, trace  # noqa: E402
from aggmg_bench.control import Control  # noqa: E402

CELL = "flagship_schwarz_16m.handover_cg"
N = 16384
SMALL = {"builder_args": {"n": N, "spec": {"c_dir": 1000.0 * N, "n_agg_levels": 3}},
         "discretization": {"n_elements": N}}
SEED = 2**31 + 24
SCHWARZ = ("schwarz_ms_per_cycle", "schwarz_launches_per_cycle")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, restored after (as ``test_bench_flagship``)."""
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
    assert cell.config["builder_args"]["spec"]["cg_smoother"] == "hybridSchwarz"
    assert cell.config["reference"] == "cg_band"
    e2e = {m["name"] for m in cell.end_to_end}
    layers = {m["name"]: m for m, _ in cell.per_layer}
    # device-bound (the solve time spreads 0.36 % over six seeds on one
    # H100 at 700 W), so it reports solve_s and the per-layer metrics that
    # move it; the cg_* readers move solve_s.host_bound, which it does not
    assert e2e == {"setup_s", "solve_s", "peak_mem_gib"}
    assert {"build_s", "launches_per_cycle", "smooth_ms_per_cycle", "kernels_roofline", *SCHWARZ} <= set(layers)
    assert not {"cg_ms_per_cycle", "cg_launches_per_cycle"} & set(layers)
    assert all(m["moves"] in e2e for m in layers.values())
    assert all(layers[s]["moves"] == "solve_s" for s in SCHWARZ)
    assert {layers[s]["layer"] for s in SCHWARZ} == {"CG Schwarz smoothing"}
    assert all(layers[s]["workloads"] == [CELL] for s in SCHWARZ)
    jacobi = {m["name"] for m, _ in harness.resolve("flagship_16m.handover_cg").per_layer}
    assert not set(SCHWARZ) & jacobi


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"rel_residual", "operator_gap", "rhs_gap"}


def test_control_is_not_correct():
    out = run_small(program=Control(harness.resolve(CELL)))
    assert not out["correct"], out["checks"]
    assert all(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def _reader(name):
    return harness.load_module(harness.reader_path(ROOT / "aggmg_bench", name), f"_test_reader_{name}")


def _synthetic(with_schwarz: bool):
    """Two V-cycles: a smooth@0 span inside a CG span with three launches,
    the first two inside one Schwarz span; a transfer@0 span in a CG span
    with one launch; a launch outside every span; a coarse span with one."""
    host = [
        ("aggmg.vcycle.f32", 0, 100),
        ("aggmg.smooth@0", 0, 30), ("aggmg.cg@0", 1, 28),
        ("cudaLaunchKernel", 4, 2), ("cuLaunchKernel", 8, 2), ("cudaLaunchKernel", 20, 2),
        ("aggmg.transfer@0", 40, 20), ("aggmg.cg@0", 41, 10), ("cudaLaunchKernelExC", 45, 2),
        ("cudaLaunchKernel", 62, 2),
        ("aggmg.coarse", 70, 20), ("cudaLaunchKernel", 75, 2),
    ]
    if with_schwarz:
        host += [("aggmg.schwarz@0", 3, 9)]
    kernels = [("gather", 10, 1_000_000), ("bmm", 1_000_100, 2_000_000), ("band", 3_000_200, 3_000_000),
               ("restrict", 6_000_300, 500_000), ("add", 6_500_400, 250_000), ("bcr", 6_750_500, 4_000_000)]
    return SimpleNamespace(trace=trace.Trace(kernels=kernels, host=host), traced_cycles=2)


def test_schwarz_readers_take_the_kernels_launched_in_schwarz_spans():
    rec = _synthetic(True)
    assert _reader("schwarz_ms_per_cycle").read(rec) == 1.5  # (1 + 2) ms over 2 cycles
    assert _reader("schwarz_launches_per_cycle").read(rec) == 1.0
    none = _synthetic(False)
    assert all(_reader(s).read(none) is None for s in SCHWARZ)
    unpaired = _synthetic(True)
    unpaired.trace.kernels.pop()
    assert all(_reader(s).read(unpaired) is None for s in SCHWARZ)
    assert _reader("schwarz_ms_per_cycle").read(SimpleNamespace(trace=None, traced_cycles=0)) is None


def test_schwarz_spans_leave_the_cg_readings_alone():
    plain, marked = _synthetic(False), _synthetic(True)
    for name in ("cg_ms_per_cycle", "cg_launches_per_cycle"):
        assert _reader(name).read(marked) == _reader(name).read(plain) is not None
