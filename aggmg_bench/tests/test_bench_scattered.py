"""The cells ``scattered_2m.mixed_damped`` (scattered agglomerates, 10
block-COO levels at full size) and ``dg_slice.mixed_cheb`` (the slice's
mixed solves on Chebyshev smoothers) at small sizes on the CPU: both
resolve, a sound run reads ``correct``, and the float32 control and planted
faults (an answer altered where the solver produces it, the scattered
chain's fine operator scaled in set-up) do not.  (A V-cycle that returns
its state unchanged makes ``multigrid_mixed`` raise on this chain: its
progressive fallback takes no block-COO level.)  The block-COO readers take the kernels launched inside
``aggmg.bcoo@k`` on a synthetic trace, read the host time inside those
spans on a traced CPU run, and read nothing where no such span opens."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_helpers import SEED  # noqa: E402
from bench_helpers import SMALL as SLICE_SMALL  # noqa: E402

from aggmg_bench import harness, trace  # noqa: E402
from aggmg_bench.control import Control  # noqa: E402

SCATTERED = "scattered_2m.mixed_damped"
CHEB = "dg_slice.mixed_cheb"
N = 1024
SMALL = {
    SCATTERED: {"builder_args": {"n": N}, "partition": {"coarsest": 16},
                "discretization": {"n_elements": N, "c_dir": 1000.0 * N}},
    CHEB: SLICE_SMALL["dg_slice"],
}
BCOO = ("bcoo_ms_per_cycle", "bcoo_launches_per_cycle", "bcoo_host_ms_per_cycle")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, restored after (as ``test_bench_flagship``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_small(cell, program=None, seconds=0.3, trace_=False):
    out, _ = harness.run(harness.resolve(cell), SEED, seconds, trace_, device="cpu", overrides=SMALL[cell],
                         program=program)
    return out


@pytest.mark.parametrize("cell", SMALL)
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c.builder.FORM == c.entry.FORM == "hierarchy" and c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e == {"setup_s", "solve_s.host_bound", "peak_mem_gib"}
    layers = {m["name"]: m for m, _ in c.per_layer}
    assert all(m["moves"] in e2e for m in layers.values())
    assert {"build_s", "kernels_roofline.host_bound", "launches_per_cycle.host_bound"} <= set(layers)
    assert (set(BCOO) <= set(layers)) == (cell == SCATTERED)
    if cell == SCATTERED:
        assert {layers[b]["layer"] for b in BCOO} == {"block-COO levels"}
        assert c.config["partition"] == {"kind": "interleaved_pairs", "coarsest": 1024}


@pytest.mark.parametrize("cell", SMALL)
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    want = {"rel_residual", "rhs_gap"} | ({"operator_gap"} if cell == CHEB else set())
    assert set(out["checks"]) == want


@pytest.mark.parametrize("cell", SMALL)
def test_control_is_not_correct(cell):
    out = run_small(cell, program=Control(harness.resolve(cell)))
    assert not out["correct"], out["checks"]
    assert out["checks"]["rel_residual"]["value"] > out["checks"]["rel_residual"]["limit"]
    assert out["checks"]["rhs_gap"]["value"] > out["checks"]["rhs_gap"]["limit"]


def _altered_answer(monkeypatch):
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    orig = solvers.multigrid_mixed

    def solve(*a, **k):
        res = orig(*a, **k)
        x = res.x.clone()
        x[0, x.shape[1] // 2] += 1e-3 * float(x.abs().max())
        return res._replace(x=x)

    monkeypatch.setattr(solvers, "multigrid_mixed", solve)


def _scaled_operator(monkeypatch):
    """The fine operator 1e-6 larger than the one its hierarchy and rhs
    come from: the answers solve another system."""
    from agglomerationmultigrid1d_tpu_torch.models import problems

    orig = problems.schur_stiffness

    def scaled(*a, **k):
        op = orig(*a, **k)
        return type(op)(*(t * (1 + 1e-6) for t in op))

    monkeypatch.setattr(problems, "schur_stiffness", scaled)


@pytest.mark.parametrize("fault", [_altered_answer, _scaled_operator])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(SCATTERED)
    assert not out["correct"], (fault.__name__, out["checks"])


def _reader(name):
    return harness.load_module(harness.reader_path(ROOT / "aggmg_bench", name), f"_test_reader_{name}")


@pytest.mark.parametrize("cell", SMALL)
def test_bcoo_host_ms_reads_where_a_bcoo_span_opens(cell):
    """A traced CPU run: the scattered chain's block-COO levels open their
    spans, the slice opens none.  The CPU has no kernels, so the device
    readers read nothing in either."""
    out, _ = harness.run(harness.resolve(cell), SEED, 0.1, True, device="cpu", overrides=SMALL[cell])
    assert out["correct"], out["checks"]
    host = _reader("bcoo_host_ms_per_cycle")
    got = out["metrics"].get("bcoo_host_ms_per_cycle")
    if cell == SCATTERED:
        assert got is not None and got["value"] > 0 and got["unit"] == "ms"
    else:
        assert got is None and host.read(SimpleNamespace(trace=trace.Trace(host=[("aggmg.smooth@0", 0, 5)]),
                                                          traced_cycles=1)) is None


def _synthetic(with_bcoo: bool):
    """Two V-cycles: a smooth@1 span with two launches, the first inside a
    block-COO span; a transfer@1 span with one launch inside one; a launch
    outside every span; a coarse span with one."""
    host = [
        ("aggmg.vcycle.f32", 0, 100),
        ("aggmg.smooth@1", 0, 30), ("cudaLaunchKernel", 4, 2), ("cuLaunchKernel", 20, 2),
        ("aggmg.transfer@1", 40, 20), ("cudaLaunchKernelExC", 45, 2),
        ("cudaLaunchKernel", 62, 2),
        ("aggmg.coarse", 70, 20), ("cudaLaunchKernel", 75, 2),
    ]
    if with_bcoo:
        host += [("aggmg.bcoo@1", 1, 10), ("aggmg.bcoo@1", 41, 10)]
    kernels = [("gather", 10, 1_000_000), ("jacobi", 1_000_100, 2_000_000), ("rowsum", 3_000_200, 3_000_000),
               ("add", 6_000_300, 500_000), ("lu", 6_500_400, 4_000_000)]
    return SimpleNamespace(trace=trace.Trace(kernels=kernels, host=host), traced_cycles=2)


def test_bcoo_readers_take_the_kernels_launched_in_bcoo_spans():
    rec = _synthetic(True)
    assert _reader("bcoo_ms_per_cycle").read(rec) == 2.0  # (1 + 3) ms over 2 cycles
    assert _reader("bcoo_launches_per_cycle").read(rec) == 1.0
    assert _reader("bcoo_host_ms_per_cycle").read(rec) == pytest.approx(1e-5)  # 20 ns over 2 cycles
    none = _synthetic(False)
    assert all(_reader(b).read(none) is None for b in BCOO)
    unpaired = _synthetic(True)
    unpaired.trace.kernels.pop()
    assert _reader("bcoo_ms_per_cycle").read(unpaired) is None
    assert _reader("bcoo_launches_per_cycle").read(unpaired) is None
